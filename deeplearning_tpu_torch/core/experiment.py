"""Config-as-code experiments (YOLOX's Exp system) — the port of
``deeplearning_tpu/core/experiment.py``.

An Exp is a plain Python class whose attributes are the config and whose
methods build the pieces (model, schedule, optimizer, loss and eval
functions, evaluator); ``merge`` applies CLI overrides and ``get_exp``
loads one from a file (which defines ``Exp``) or from the ``EXPERIMENTS``
registry. The registered experiments, their attributes and
``DetectionExp.cli_overrides`` are the JAX package's. Eager torch compiles
nothing, so there is no compile cache to enable; a factory whose model the
port has not registered yet raises the registry's ``KeyError``.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import torch

from .registry import MODELS, Registry

__all__ = ["EXPERIMENTS", "BaseExp", "DetectionExp", "get_exp"]

EXPERIMENTS = Registry("experiments")


class BaseExp:
    """Subclass, set attributes, override factories as needed."""
    model_name: str = "mnist_cnn"
    num_classes: int = 10
    precision: str = "bf16"
    global_batch: int = 64
    max_epochs: int = 3
    base_lr: float = 0.05
    warmup_steps: int = 10
    optimizer: str = "sgd"
    weight_decay: float = 0.0
    scheduler: str = "warmup_cosine"
    label_smoothing: float = 0.0
    ema: bool = False
    seed: int = 0

    def merge(self, opts: Sequence[str]) -> "BaseExp":
        """Apply ['key', 'value', ...] or ['key=value'] CLI overrides, each
        value read by ``yaml.safe_load`` and held to the attribute's type
        (an int where a float is expected is taken as a float, anything
        where a str is expected as its str)."""
        import yaml
        i = 0
        opts = list(opts)
        pairs = []
        while i < len(opts):
            if "=" in opts[i]:
                k, v = opts[i].split("=", 1)
                pairs.append((k, v))
                i += 1
            else:
                if i + 1 >= len(opts):
                    raise ValueError(
                        f"missing value for option {opts[i]!r}")
                pairs.append((opts[i], opts[i + 1]))
                i += 2
        for k, v in pairs:
            if not hasattr(self, k):
                raise KeyError(f"Exp has no attribute {k!r}")
            cur = getattr(self, k)
            val = yaml.safe_load(v)
            if cur is not None and not isinstance(val, type(cur)):
                if isinstance(cur, float) and isinstance(val, int):
                    val = float(val)
                elif isinstance(cur, str):
                    val = str(val)
                else:
                    raise ValueError(
                        f"cannot assign {val!r} to {k} "
                        f"(expected {type(cur).__name__})")
            setattr(self, k, val)
        return self

    # ---- factories (override per experiment) ----
    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    def get_model(self, **kw):
        from .. import models  # noqa: F401  (registers the factories)
        return MODELS.build(self.model_name, num_classes=self.num_classes,
                            dtype=self._dtype(), **kw)

    def get_lr_schedule(self, total_steps: int):
        from ..train.schedules import build_schedule
        return build_schedule(self.scheduler, base_lr=self.base_lr,
                              total_steps=total_steps,
                              warmup_steps=self.warmup_steps)

    def get_optimizer(self, schedule, params):
        from ..train.optim import build_optimizer
        return build_optimizer(self.optimizer, schedule,
                               weight_decay=self.weight_decay,
                               params=params)

    def get_loss_fn(self):
        from ..train.classification import make_loss_fn
        return make_loss_fn(self.label_smoothing)

    def get_eval_fn(self):
        from ..train.classification import make_metric_fn
        return make_metric_fn()


def get_exp(exp_file: Optional[str] = None, exp_name: Optional[str] = None
            ) -> BaseExp:
    """Load an Exp from a python file (which must define ``Exp``) or from
    the EXPERIMENTS registry."""
    if exp_file:
        spec = importlib.util.spec_from_file_location(
            os.path.basename(exp_file).removesuffix(".py"), exp_file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.Exp()
    if exp_name:
        return EXPERIMENTS.build(exp_name)
    raise ValueError("provide exp_file or exp_name")


@EXPERIMENTS.register("mnist_smoke")
class MnistSmokeExp(BaseExp):
    pass


@EXPERIMENTS.register("vit_b16")
class ViTB16Exp(BaseExp):
    model_name = "vit_base_patch16_224"
    num_classes = 1000
    global_batch = 128
    base_lr = 1e-3
    optimizer = "adamw"
    weight_decay = 0.05
    label_smoothing = 0.1
    ema = True


@EXPERIMENTS.register("swin_tiny")
class SwinTinyExp(BaseExp):
    model_name = "swin_tiny_patch4_window7_224"
    num_classes = 1000
    global_batch = 128
    base_lr = 1e-3
    optimizer = "adamw"
    weight_decay = 0.05
    label_smoothing = 0.1
    ema = True


@EXPERIMENTS.register("resnet50")
class ResNet50Exp(BaseExp):
    model_name = "resnet50"
    num_classes = 1000
    global_batch = 256
    base_lr = 0.1
    optimizer = "sgd"
    weight_decay = 1e-4


@EXPERIMENTS.register("mae_pretrain")
class MAEPretrainExp(BaseExp):
    """MAE pretrain defaults (mask ratio 0.75 in the model, AdamW)."""
    model_name = "mae_vit_base_patch16"
    num_classes = 0                  # pretrain has no classifier head
    global_batch = 256
    base_lr = 1.5e-4
    optimizer = "adamw"
    weight_decay = 0.05
    ema = False

    def get_model(self, **kw):
        from .. import models  # noqa: F401  (registers the factories)
        # MAE has no num_classes field (reconstruction objective)
        return MODELS.build(self.model_name, dtype=self._dtype(), **kw)


class DetectionExp(BaseExp):
    """Detector experiment: YOLOX's Exp attributes (input size, multiscale
    random resize, test confidence) mapped onto the detection CLI's config
    tree; ``cli_overrides`` gives them as dotted overrides for
    ``python -m deeplearning_tpu_torch.train.detection --exp NAME``."""
    model_name = "yolox_s"
    num_classes = 80
    img_size = 640
    max_gt = 50
    global_batch = 8
    max_steps = 300
    base_lr = 1e-3
    clip_grad_norm = 1.0
    score_thresh = 0.3               # test_conf
    multiscale = True                # bucketed random_resize

    def cli_overrides(self):
        return [
            f"model.name={self.model_name}",
            f"model.num_classes={self.num_classes}",
            f"model.image_size={self.img_size}",
            f"data.max_gt={self.max_gt}",
            f"data.batch={self.global_batch}",
            f"train.steps={self.max_steps}",
            f"train.lr={self.base_lr}",
            f"train.clip_grad_norm={self.clip_grad_norm}",
            f"train.eval_score_thresh={self.score_thresh}",
            f"train.multiscale={str(self.multiscale).lower()}",
        ]

    def get_evaluator(self):
        from ..evaluation.coco_eval import CocoEvaluator
        return CocoEvaluator(num_classes=self.num_classes)


def _det_exp(name, **attrs):
    cls = type(f"Exp_{name}", (DetectionExp,),
               {"model_name": attrs.pop("model_name", name), **attrs})
    EXPERIMENTS.register(name)(cls)
    return cls


# the exps/default zoo (s/m/l/x scale by the registry model; tiny and nano
# at the reference's 416 input; yolov3 the Darknet-53 variant) and the VOC
# example
_det_exp("yolox_s")
_det_exp("yolox_m")
_det_exp("yolox_l")
_det_exp("yolox_x")
_det_exp("yolox_tiny", img_size=416)
_det_exp("yolox_nano", img_size=416)
_det_exp("yolox_yolov3")
_det_exp("yolox_voc_s", model_name="yolox_s", num_classes=20)
