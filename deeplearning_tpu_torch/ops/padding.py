"""Torch-semantics conv padding: the port's own copy of
``deeplearning_tpu/ops/padding.py``.

The JAX package pads a strided conv explicitly, ``torch_pad(k)`` =
symmetric ``dilation·(k−1)//2`` on each side, because XLA's "SAME" pads
(0, 1) at stride 2 and shifts the sampling centres. A torch ``Conv2d``
pads symmetrically already: ``conv_padding(k)`` is the ``padding=`` that
gives the same result (and equals "SAME" at stride 1 for odd k).
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["torch_pad", "conv_padding"]


def torch_pad(kernel: int, dilation: int = 1) -> List[Tuple[int, int]]:
    """Explicit symmetric padding equal to torch's p = dilation*(k-1)//2,
    as (before, after) pairs for the two spatial dims."""
    p = dilation * (kernel - 1) // 2
    return [(p, p), (p, p)]


def conv_padding(kernel: int, dilation: int = 1) -> int:
    """``torch_pad`` as a ``Conv2d`` ``padding=`` argument."""
    (p, _), _ = torch_pad(kernel, dilation)
    return p
