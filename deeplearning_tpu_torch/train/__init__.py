"""Training of the port: the counterpart of ``deeplearning_tpu/train``.

This slice has the pieces of one ViT-B/16 training step: schedules,
optimizers (``optim``), ``TrainState`` (``state``), the classification
loss and metric functions (``classification``), ``make_train_step`` /
``make_eval_step`` (``steps``) and the step benchmark
(``python -m deeplearning_tpu_torch.train.bench``). The input feed, the
Trainer, checkpoints and the train CLI come with the next slice.
"""

from .state import TrainState
from .steps import make_eval_step, make_train_step

__all__ = ["TrainState", "make_train_step", "make_eval_step"]
