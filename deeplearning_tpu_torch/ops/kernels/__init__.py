"""Building and loading the hand-written CUDA kernels (``csrc/``), and
what their wrappers share."""

from typing import Sequence

__all__ = ["kernel_head_dim", "WIDE_GRANULE"]

# the wide SIMT kernels stream the head dim in chunks of 64 columns
# (``wide::kChunk`` in ``csrc/wide_attn.cuh``)
WIDE_GRANULE = 64


def kernel_head_dim(d: int, head_dims: Sequence[int], name: str) -> int:
    """The head dim a ``d`` runs at: the smallest of ``head_dims``
    (ascending, the tensor-core kernels' instantiations) that holds it;
    above the largest, ``d`` rounded up to a multiple of ``WIDE_GRANULE``
    (the SIMT kernels of ``csrc/wide_attn.cuh`` take any such d). Raises for a
    ``d`` below 1, naming the kernel ``name``."""
    if d < 1:
        raise ValueError(f"{name} takes head dims of 1 or more, got {d}")
    for dk in head_dims:
        if d <= dk:
            return dk
    return -(-d // WIDE_GRANULE) * WIDE_GRANULE
