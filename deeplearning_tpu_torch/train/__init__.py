"""Training of the port: the counterpart of ``deeplearning_tpu/train``.

Schedules, optimizers (``optim``), ``TrainState`` (``state``), the
classification loss and metric functions (``classification``),
``make_train_step`` / ``make_eval_step`` (``steps``), lagged metrics
(``async_metrics``), the ``Trainer`` (``trainer``), the train CLI
(``python -m deeplearning_tpu_torch.train``), the step benchmark
(``python -m deeplearning_tpu_torch.train.bench``) and profiler
(``train.profile``), divergence rollback (``recovery``) and the LR range
test (``lr_finder``), the detection CLI
(``python -m deeplearning_tpu_torch.train.detection``), hyperparameter
evolution (``evolve``) and the task CLI of the segmentation, SSL,
metric-learning, pose and stereo families
(``python -m deeplearning_tpu_torch.train.task``).
"""

from .recovery import RecoveryExhausted, RecoveryManager, RecoveryPolicy
from .state import TrainState
from .steps import make_eval_step, make_train_step

__all__ = ["TrainState", "make_train_step", "make_eval_step",
           "RecoveryPolicy", "RecoveryManager", "RecoveryExhausted"]
