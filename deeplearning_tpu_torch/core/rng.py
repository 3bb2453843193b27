"""Deterministic random streams — the port of ``deeplearning_tpu/core/rng.py``.

JAX threads one key per experiment and folds the step into it, so every
step's dropout stream is independent and a replayed step (after a
restore) draws the same masks. The port keeps that contract with plain
integer keys and ``torch.Generator``s: ``root_key(seed)`` is the
experiment's key, ``fold_in`` mixes data into a key on the host (no
device work, no sync), and ``step_key`` turns (key, step) into a
generator on the step's device. The streams are not JAX's: the same seed
gives other numbers than ``jax.random``, so tests feed both frameworks
numbers made with numpy.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["root_key", "fold_in", "step_key"]

_MASK = (1 << 63) - 1


def root_key(seed: int) -> int:
    """The experiment's key: a non-negative 63-bit integer."""
    return int(seed) & _MASK


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data``, mixed by numpy's SeedSequence
    (different data give statistically independent keys)."""
    words = np.random.SeedSequence([int(key) & _MASK, int(data) & _MASK]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & _MASK


def step_key(key: int, step: int,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Generator:
    """The generator of train step ``step``: the same (key, step) gives the
    same stream, so a replayed step draws the same masks. ``device``
    defaults to the CPU."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(fold_in(key, step))
    return gen
