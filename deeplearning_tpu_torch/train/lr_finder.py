"""LR range test (SupCon learning_rate_finder.py surface) — the port of
``deeplearning_tpu/train/lr_finder.py``: sweep the learning rate
exponentially over one pass, record the smoothed loss, suggest the
steepest-descent rate.

The run's key is ``core.rng.root_key(0)`` (JAX: ``jax.random.key(0)``),
from which the port's step draws each step's ``torch.Generator``. Each
step's loss is fetched to the host: the sweep needs it to stop early.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..core import rng as rng_mod

__all__ = ["lr_range_test"]


def lr_range_test(
    make_state: Callable[[Callable[[int], float]], object],
    train_step_factory: Callable[[object], Callable],
    batches,
    min_lr: float = 1e-7,
    max_lr: float = 1.0,
    beta: float = 0.98,
) -> Dict[str, np.ndarray]:
    """``make_state(schedule)`` builds a fresh ``TrainState`` whose
    optimizer follows ``schedule`` (step -> lr); ``train_step_factory
    (state)`` returns the step. Returns {lrs, losses, suggestion}."""
    batches = list(batches)
    n = len(batches)
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), n))

    def schedule(step: int) -> float:
        return float(lrs[min(max(int(step), 0), n - 1)])

    state = make_state(schedule)
    step_fn = train_step_factory(state)
    rng = rng_mod.root_key(0)
    avg = 0.0
    smoothed: List[float] = []
    best = np.inf
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch, rng)
        loss = float(metrics["loss"])
        avg = beta * avg + (1 - beta) * loss
        corrected = avg / (1 - beta ** (i + 1))
        smoothed.append(corrected)
        best = min(best, corrected)
        if corrected > 4 * best and i > n // 10:   # diverged: stop early
            lrs = lrs[: i + 1]
            break
    losses = np.asarray(smoothed)
    # steepest negative slope of the smoothed loss; skip the first 10% of
    # points, biased by the average's warm-up
    if len(losses) > 2:
        slopes = np.gradient(losses, np.log(lrs[: len(losses)]))
        skip = max(len(slopes) // 10, 1)
        suggestion = float(lrs[skip + int(np.argmin(slopes[skip:]))])
    else:
        suggestion = float(lrs[0])
    return {"lrs": lrs[: len(losses)], "losses": losses,
            "suggestion": suggestion}
