"""Building and loading the hand-written CUDA kernels (``csrc/``), and
what their wrappers share: the head-dim rule and the custom-op binding."""

from typing import Callable, Optional, Sequence

import torch

__all__ = ["kernel_head_dim", "WIDE_GRANULE", "define_op", "LIB"]

# every kernel entry of the port is an op of this namespace (``dltpu::``)
LIB = torch.library.Library("dltpu", "FRAGMENT")

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


def define_op(schema: str, impl: Callable, fake: Callable, *,
              backward: Optional[Callable] = None,
              setup_context: Optional[Callable] = None):
    """Define ``dltpu::<schema>`` as a ``torch.library`` op: ``impl`` its
    CPU and CUDA kernel (one Python function that dispatches by where the
    tensors lie), ``fake`` its fake implementation (the results' shapes,
    dtypes and strides, nothing launched), ``backward`` and
    ``setup_context`` its autograd formula. Returns the op's overload.

    The ops are defined through ``torch.library.Library`` rather than the
    ``torch.library.custom_op`` decorator, whose kernels run under a
    ``torch._dynamo.disable`` wrapper: that imports dynamo (seconds) at a
    process's first launch and adds tens of microseconds to every one."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    for key in ("CPU", "CUDA"):
        LIB.impl(name, impl, key)
    torch.library.register_fake(f"dltpu::{name}", fake, lib=LIB)
    if backward is not None:
        torch.library.register_autograd(f"dltpu::{name}", backward,
                                        setup_context=setup_context,
                                        lib=LIB)
    return getattr(torch.ops.dltpu, name).default
