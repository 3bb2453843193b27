"""Deterministic random streams — the port of ``deeplearning_tpu/core/rng.py``.

JAX threads one key per experiment and folds the step into it, so every
step's dropout stream is independent and a replayed step (after a
restore) draws the same masks. The port keeps that contract with plain
integer keys and ``torch.Generator``s: ``root_key(seed)`` is the
experiment's key, ``host_key(seed)`` this process's (the root key folded
with its rank: distinct augmentation streams on each rank; the Trainer's
key, as in JAX), ``fold_in`` mixes data into a key on the host (no device
work, no sync), ``split_named`` splits a key into named ones, and
``step_key`` turns (key, step) into a generator on the step's device. The streams are not JAX's: the same seed
gives other numbers than ``jax.random``, so tests feed both frameworks
numbers made with numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["root_key", "host_key", "fold_in", "split_named", "step_key"]

_MASK = (1 << 63) - 1


def root_key(seed: int) -> int:
    """The experiment's key: a non-negative 63-bit integer."""
    return int(seed) & _MASK


def host_key(seed: int) -> int:
    """This process's key: the root key folded with its rank in the
    default process group (0 when no group is initialised), as JAX folds
    ``jax.process_index()``."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    return fold_in(root_key(seed), rank)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data``, mixed by numpy's SeedSequence
    (different data give statistically independent keys)."""
    words = np.random.SeedSequence([int(key) & _MASK, int(data) & _MASK]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & _MASK


def split_named(key: int, names: Sequence[str]) -> Dict[str, int]:
    """One key a name, distinct from each other and from ``key``'s
    ``fold_in`` keys: the children numpy's SeedSequence spawns from
    ``key``, one a name in order (JAX: ``jax.random.split``)."""
    children = np.random.SeedSequence(int(key) & _MASK).spawn(len(names))
    out = {}
    for name, child in zip(names, children):
        words = child.generate_state(2, np.uint32)
        out[name] = (int(words[0]) << 32 | int(words[1])) & _MASK
    return out


def step_key(key: int, step: int,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Generator:
    """The generator of train step ``step``: the same (key, step) gives the
    same stream, so a replayed step draws the same masks. ``device``
    defaults to the CPU."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(fold_in(key, step))
    return gen
