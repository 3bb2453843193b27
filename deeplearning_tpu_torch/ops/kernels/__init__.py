"""Building and loading the hand-written CUDA kernels (``csrc/``), and
what their wrappers share."""

from typing import Sequence

__all__ = ["kernel_head_dim"]


def kernel_head_dim(d: int, head_dims: Sequence[int], name: str) -> int:
    """The instantiated head dim a ``d`` runs at: the smallest of
    ``head_dims`` (ascending) that holds it. Raises above the largest,
    naming the kernel ``name`` and its limit."""
    for dk in head_dims:
        if d <= dk:
            return dk
    raise ValueError(f"{name} takes head dims up to {head_dims[-1]}, "
                     f"got {d}")
