"""Per-update learning-rate schedules — the port of
``deeplearning_tpu/train/schedules.py``.

Each schedule maps the update count to a learning rate: update t uses
``schedule(t)`` with t counted BEFORE the increment, as optax's
``scale_by_learning_rate`` does (torch's ``LambdaLR`` steps after the
update and is one step off from this). The formulas are optax's, written
in numpy float32 operation by operation, so the traces agree with the JAX
package's to within an ulp or two of the peak rate (numpy's and XLA's
float32 ``cos`` and ``pow`` round differently in the last place). They run on the host and return a Python
float: the optimizer multiplies by it, so nothing syncs with the card.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from ..core.registry import SCHEDULES

__all__ = ["build_schedule", "constant", "warmup_cosine", "cosine_lambda",
           "yolox_warmcos", "poly", "multistep"]

Schedule = Callable[[int], float]
_f32 = np.float32


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial of power 1, from count 0)."""
    if transition_steps <= 0:
        return lambda count: float(_f32(init_value))

    def sched(count):
        c = np.clip(np.int32(count), 0, transition_steps)
        frac = _f32(1) - _f32(c) / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac + _f32(end_value))
    return sched


def _cosine_decay(init_value: float, decay_steps: int,
                  alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        c = np.minimum(_f32(count), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                               / _f32(decay_steps)))
        decayed = _f32(1 - alpha) * cosine + _f32(alpha)
        return float(_f32(init_value) * decayed)
    return sched


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""
    def sched(count):
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out
    return sched


@SCHEDULES.register("constant")
def constant(base_lr: float, total_steps: int = 0, **_) -> Schedule:
    return lambda count: base_lr


@SCHEDULES.register("warmup_cosine")
def warmup_cosine(base_lr: float, total_steps: int,
                  warmup_steps: int = 0, warmup_lr: float = 1e-7,
                  min_lr: float = 0.0, **_) -> Schedule:
    """Linear warmup from ``warmup_lr`` then cosine to ``min_lr``
    (optax.warmup_cosine_decay_schedule)."""
    warm = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr
    return _join([_linear(warmup_lr, base_lr, warm),
                  _cosine_decay(base_lr, decay_steps - warm, alpha)],
                 [warm])


@SCHEDULES.register("cosine_lambda")
def cosine_lambda(base_lr: float, total_steps: int, lrf: float = 0.1,
                  **_) -> Schedule:
    """lr(t) = base * ((1 + cos(pi t / T)) / 2 * (1 - lrf) + lrf)."""
    decay = _cosine_decay(1.0, max(total_steps, 1))

    def sched(count):
        t = _f32(decay(count))
        return float(_f32(base_lr) * (t * _f32(1 - lrf) + _f32(lrf)))
    return sched


@SCHEDULES.register("yolox_warmcos")
def yolox_warmcos(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  warmup_lr_start: float = 0.0, min_lr_ratio: float = 0.05,
                  no_aug_steps: int = 0, **_) -> Schedule:
    """Quadratic warmup -> cosine -> flat floor during the no-aug steps."""
    min_lr = base_lr * min_lr_ratio

    def sched(count):
        step = _f32(count)
        if step < warmup_steps:
            return float(_f32(base_lr - warmup_lr_start) * np.square(
                step / _f32(max(warmup_steps, 1))) + _f32(warmup_lr_start))
        if step >= total_steps - no_aug_steps:
            return float(_f32(min_lr))
        span = max(total_steps - warmup_steps - no_aug_steps, 1)
        cos = np.cos(_f32(math.pi) * (step - _f32(warmup_steps))
                     / _f32(span))
        return float(_f32(min_lr) + _f32(0.5 * (base_lr - min_lr))
                     * (_f32(1) + cos))
    return sched


@SCHEDULES.register("poly")
def poly(base_lr: float, total_steps: int, warmup_steps: int = 0,
         power: float = 0.9, warmup_factor: float = 1e-3, **_) -> Schedule:
    """Poly decay with linear warmup."""
    def sched(count):
        step = _f32(count)
        if step < warmup_steps:
            alpha = step / _f32(max(warmup_steps, 1))
            return float(_f32(base_lr) * (_f32(warmup_factor)
                                          * (_f32(1) - alpha) + alpha))
        frac = _f32(1) - (step - _f32(warmup_steps)) / _f32(
            max(total_steps - warmup_steps, 1))
        return float(_f32(base_lr) * np.power(np.clip(frac, _f32(0),
                                                      _f32(1)), _f32(power)))
    return sched


@SCHEDULES.register("multistep")
def multistep(base_lr: float, milestones: Sequence[int] = (),
              gamma: float = 0.1, warmup_steps: int = 0, **_) -> Schedule:
    """Multiply by ``gamma`` at each milestone; optional linear warmup
    from 0 (the milestones then count from the end of the warmup)."""
    marks = sorted(int(m) for m in milestones)

    def steps(count):
        value = _f32(base_lr)
        for m in marks:
            if count >= m:
                value = value * _f32(gamma)
        return float(value)
    if warmup_steps:
        return _join([_linear(0.0, base_lr, warmup_steps), steps],
                     [warmup_steps])
    return steps


def build_schedule(name: str, **kwargs) -> Schedule:
    return SCHEDULES.build(name, **kwargs)
