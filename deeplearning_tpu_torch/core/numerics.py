"""Numerics mode: the fast tanh-approximate GELU by default, exact erf on
request — the same switch as ``deeplearning_tpu/core/numerics.py``.

The JAX package made tanh the default because its TPU lowering of erf
cost training throughput; the port keeps the same default so that the
two packages compute the same function from the same weights, and the
same ``exact_numerics()`` / ``set_exact`` switch to erf (what
``torch.nn.GELU()`` computes). PyTorch runs eagerly, so the flag is read
at every call rather than at trace time.

    from deeplearning_tpu_torch.core import numerics
    y = numerics.gelu(x)

    with numerics.exact_numerics():
        logits = model(images)
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

_EXACT = False


def exact_enabled() -> bool:
    return _EXACT


def set_exact(flag: bool) -> None:
    """Process-wide switch (CLI entry points). Prefer the context manager."""
    global _EXACT
    _EXACT = bool(flag)


@contextlib.contextmanager
def exact_numerics(flag: bool = True) -> Iterator[None]:
    """Temporarily select exact-erf numerics for anything run inside."""
    global _EXACT
    old = _EXACT
    _EXACT = bool(flag)
    try:
        yield
    finally:
        _EXACT = old


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU honoring the numerics mode: erf when exact, else tanh."""
    return F.gelu(x, approximate="none" if _EXACT else "tanh")
