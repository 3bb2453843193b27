"""Collectives over the process group, with block-scaled int8 payloads —
the port of ``deeplearning_tpu/parallel/collectives.py``.

JAX's collectives run inside ``shard_map`` over named mesh axes; the
port's run over a ``torch.distributed`` process group (``Mesh.group``;
None is the world). Each call adds one to ``launch_counts()[kind]``,
read around the train step as the kernels' launch counters are.

- ``pmean_tree`` / ``psum_tree``: the all-reduce of every leaf (DDP's).
- ``quantized_psum`` (EQuARX): every rank quantizes its vector in blocks
  of ``block`` elements, the int8 payloads and float32 scales go out
  through one ``all_to_all_single`` each (JAX's ``all_to_all``), each
  rank sums its chunk in float32, requantizes it, and an ``all_gather``
  of payloads and scales rebuilds the sum: a quarter of the float32
  bytes on the wire, at most ~2/127 of a block's maximum off, and exact
  on small integers. ``quantized_reduce_scatter`` stops after the first
  stage (this rank's dim-0 slice of the sum). ``quantized_reduce`` does
  both for many leaves in one packed pass (the train step's gradients).
- ``ppermute`` (JAX's ``lax.ppermute``) and ``all_to_all_tiled`` (JAX's
  tiled ``lax.all_to_all`` over chosen split and concat dims): the
  differentiable moves of ring attention, Ulysses and the pipeline. Both
  travel as one ``all_to_all_single`` with split sizes (a permutation
  sends its whole tensor to one rank and receives one), which NCCL and
  gloo both carry for CUDA tensors: gloo stages its collectives through
  the host inside the backend, the port adds no copy of its own and
  switches no path. Over a group of one rank both are the identity and
  issue no collective.
- ``copy_to_model`` and ``reduce_from_model``: Megatron's two operators
  around a column- and row-parallel pair of layers over the ``model``
  group. The first is the identity forward and all-reduces the input's
  gradient in the backward (every model rank's slice of the layer
  contributes to it); the second all-reduces the row-parallel partial
  sums forward and passes the gradient through (the sum is replicated,
  so each rank's partial has the whole gradient). Over a group of one
  rank both issue no collective.
- ``host_allgather``, ``broadcast_from_host0``, ``sync_barrier``: host
  objects and the rank-0 broadcast.

Each block of 256 consecutive elements shares one float32 scale
``s = exp2(ceil(log2(max(max|x|, 1e-30) / 127)))`` and stores
``clip(round(x / s), -127, 127)`` as int8, so a tensor costs about one
byte an element plus 4/256 for the scales (the serving engine's int8
weight residency, ``serve/engine.py``, uses the same quantizers).

The scale is computed as XLA computes it on the CPU, so that the port's
payloads and scales equal the JAX package's: ``log2(y)`` is
``log(y) / log(2)`` in float32 and ``exp2(k)`` is ``exp(log(2) * k)``,
which puts a scale a few ulps off ``2**k`` (``2**13`` comes out
8192.0039). The logarithm and the exponential are taken in float64 and
rounded once, which XLA's float32 ``exp`` matches at every exponent the
1e-30 floor allows; where ``max|x| / 127`` is exactly a power of two,
XLA's ``log`` may round across the integer and the ceilings can differ.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["_pad_to", "_quantize_blocks", "_dequantize_blocks",
           "KINDS", "launch_counts", "reset_launch_counts", "all_reduce",
           "all_reduce_autograd",
           "ppermute", "all_to_all_tiled", "all_gather_dim0",
           "reduce_scatter_dim0", "all_to_all", "copy_to_model",
           "reduce_from_model",
           "pmean_tree", "psum_tree", "quantized_reduce", "quantized_psum",
           "quantized_psum_tree", "quantized_reduce_scatter",
           "host_allgather", "broadcast_from_host0", "sync_barrier"]

_QMAX = 127.0
_TINY = 1e-30        # floor before log2: an all-zero block gets 2^-106
_LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
# log(2) as a tensor on each device it ran on: a true division by it, as
# XLA divides (a host scalar divisor becomes a reciprocal multiply on the
# card), with no host-to-card copy once cached (a CUDA graph may hold it)
_LN2_ON: Dict[torch.device, torch.Tensor] = {}

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "ppermute", "broadcast", "barrier")
_COUNTS: Dict[str, int] = {k: 0 for k in KINDS}

# torch 2.13 renamed the tensor forms; older releases have only these
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def launch_counts() -> Dict[str, int]:
    """Collectives issued since the last reset, by kind."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


# ----------------------------------------------------------- quantizers
def _quantize_blocks(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., block) float32 -> int8 payload and a (..., 1) float32 scale
    a block."""
    xb = xb.to(torch.float32)
    maxabs = xb.abs().amax(dim=-1, keepdim=True)
    y = torch.clamp_min(maxabs, _TINY) / _QMAX
    ln2 = _LN2_ON.get(xb.device)
    if ln2 is None:
        ln2 = _LN2_ON.setdefault(xb.device, _LN2.to(xb.device))
    k = torch.ceil(torch.log(y.double()).float() / ln2)
    s = torch.exp((ln2 * k).double()).float()
    q = torch.clamp(torch.round(xb / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def _dequantize_blocks(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis up to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


# ------------------------------------------------------ the primitives
def _size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place all-reduce SUM of ``x``."""
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def all_reduce_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce SUM of ``x`` that autograd differentiates (the
    backward all-reduces the incoming gradient): a new tensor."""
    from torch.distributed.nn import functional as dist_fn
    _COUNTS["all_reduce"] += 1
    return dist_fn.all_reduce(x, group=group or dist.group.WORLD)


def all_gather_dim0(out: torch.Tensor, x: torch.Tensor,
                    group=None) -> torch.Tensor:
    """``out`` = every rank's ``x`` concatenated along dim 0, in rank
    order."""
    _COUNTS["all_gather"] += 1
    _ALL_GATHER(out, x, group=group)
    return out


def reduce_scatter_dim0(out: torch.Tensor, x: torch.Tensor,
                        group=None) -> torch.Tensor:
    """``out`` = this rank's dim-0 chunk of the SUM of every rank's
    ``x``."""
    _COUNTS["reduce_scatter"] += 1
    _REDUCE_SCATTER(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; chunk i of the result came from
    rank i (JAX's ``all_to_all`` with split and concat axis 0)."""
    _COUNTS["all_to_all"] += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
              group) -> torch.Tensor:
    """``x`` of group rank ``src`` on group rank ``dst`` for each pair;
    a rank no pair sends to gets zeros."""
    n = _size(group)
    if n == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    numel = x.numel()
    send = x.contiguous().view(-1) if dst else x.new_empty(0)
    recv = x.new_empty(numel if src else 0)
    _COUNTS["ppermute"] += 1
    dist.all_to_all_single(
        recv, send, output_split_sizes=[numel if j in src else 0
                                        for j in range(n)],
        input_split_sizes=[numel if j in dst else 0 for j in range(n)],
        group=group)
    return recv.view(x.shape) if src else torch.zeros_like(x)


def _check_perm(perm: Sequence[Tuple[int, int]], n: int) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute needs a permutation of the {n} ranks' "
                         f"indices, got {list(perm)}")


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        # the transpose: the gradient goes back along the inverse pairs
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """``lax.ppermute``: every (src, dst) pair of group ranks sends src's
    ``x`` to dst (every rank passes the same shape); a rank that no pair
    sends to gets zeros. Differentiable: the backward sends the gradient
    along the inverse pairs."""
    perm = [(int(s), int(d)) for s, d in perm]
    _check_perm(perm, _size(group))
    return _PPermute.apply(x, perm, group)


def _all_to_all_dims(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    # chunk j of the split dim first, so that it goes to rank j
    parts = all_to_all(x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
                       .contiguous(), group)
    # chunk i came from rank i: lay them along the concat dim in that order
    return parts.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all_dims(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all_dims(g, concat_dim, split_dim, ctx.group),
                None, None, None)


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group=None) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` is cut into n chunks along ``split_dim``, chunk j goes to group
    rank j, and the chunks received are laid along ``concat_dim`` in rank
    order. Differentiable: the backward is the same move with the two
    dims swapped."""
    d = x.dim()
    return _AllToAll.apply(x, split_dim % d, concat_dim % d, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` (replicated over the model group) as the
    input of column-parallel layers; the backward all-reduces its
    gradient over the group."""
    if _size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the sum over the model group of the
    row-parallel partials ``x``; the backward passes the gradient
    through."""
    if _size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)


# -------------------------------------------------------- tree reductions
def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def psum_tree(tree: Any, group=None) -> Any:
    """Every leaf summed over the group (new tensors)."""
    return _map(lambda x: all_reduce(x.clone(), group), tree)


def pmean_tree(tree: Any, group=None) -> Any:
    """Every leaf averaged over the group (DDP's gradient and metric
    all-reduce)."""
    n = _size(group)
    return _map(lambda x: all_reduce(x.clone(), group) / n, tree)


# ---------------------------------------------------- quantized (EQuARX)
def quantized_reduce(leaves: List[torch.Tensor], scatter: List[bool],
                     group=None, block: int = 256) -> List[torch.Tensor]:
    """The int8 reduction of several leaves at once: a leaf with
    ``scatter`` False gets its whole SUM over the group back
    (``quantized_psum``), one with ``scatter`` True this rank's dim-0
    slice of it (``quantized_reduce_scatter``, dim 0 divisible by the
    group's size). Each leaf keeps JAX's own padding, blocks and chunk
    ownership (a psum leaf is padded to a multiple of n * block and rank j
    owns its j-th 1/n; a scatter leaf's n rows are each padded to a
    multiple of block), and the leaves' chunks are packed side by side,
    so one quantize, two ``all_to_all`` (payloads, scales), one float32
    sum and, for the psum leaves, one requantize and two ``all_gather``
    serve them all: the numbers are those of one call a leaf."""
    n = _size(group)
    dev = leaves[0].device
    rows, widths = [], []
    for x, rs in zip(leaves, scatter):
        if rs:
            if x.shape[0] % n != 0:
                raise ValueError(
                    f"quantized_reduce_scatter needs dim0 % {n} == 0, "
                    f"got shape {tuple(x.shape)}")
            flat, _ = _pad_to(x.to(torch.float32).reshape(n, -1), block)
        else:
            flat, _ = _pad_to(x.to(torch.float32).reshape(-1), n * block)
            flat = flat.reshape(n, -1)
        rows.append(flat)
        widths.append(flat.shape[1])
    # stage 1: rank j receives chunk j of every rank and sums them
    q, s = _quantize_blocks(torch.cat(rows, dim=1).reshape(n, -1, block))
    q = all_to_all(q, group)
    s = all_to_all(s, group)
    parts = _dequantize_blocks(q, s)
    total = parts[0].clone()
    for i in range(1, n):
        total += parts[i]
    chunks = list(total.reshape(-1).split(widths))
    # stage 2: the psum leaves' chunks are requantized and gathered
    psum = [i for i, rs in enumerate(scatter) if not rs]
    gathered: Dict[int, torch.Tensor] = {}
    if psum:
        q2, s2 = _quantize_blocks(
            torch.cat([chunks[i] for i in psum]).reshape(-1, block))
        q_all = torch.empty((n,) + tuple(q2.shape), dtype=torch.int8,
                            device=dev)
        s_all = torch.empty((n,) + tuple(s2.shape), dtype=torch.float32,
                            device=dev)
        all_gather_dim0(q_all.reshape((-1,) + tuple(q2.shape[1:])), q2,
                        group)
        all_gather_dim0(s_all.reshape((-1,) + tuple(s2.shape[1:])), s2,
                        group)
        full = _dequantize_blocks(q_all, s_all).reshape(n, -1)
        for i, piece in zip(psum, full.split([widths[i] for i in psum],
                                             dim=1)):
            gathered[i] = piece.reshape(-1)
    out = []
    for i, (x, rs) in enumerate(zip(leaves, scatter)):
        if rs:
            rows_ = x.shape[0] // n
            part = chunks[i][:x[0:rows_].numel()]
            out.append(part.reshape((rows_,) + tuple(x.shape[1:]))
                       .to(x.dtype))
        else:
            out.append(gathered[i][:x.numel()].reshape(x.shape)
                       .to(x.dtype))
    return out


def quantized_psum(x: torch.Tensor, group=None,
                   block: int = 256) -> torch.Tensor:
    """int8 block-scaled all-reduce SUM of ``x`` over the group: every
    rank passes the same shape and gets the whole sum back. Exact when
    each rank's values and their sums are integers in [-127, 127];
    otherwise within ~2/127 of a block's maximum (two quantizations)."""
    return quantized_reduce([x], [False], group, block)[0]


def quantized_psum_tree(tree: Any, group=None, block: int = 256) -> Any:
    """``psum_tree`` with int8 block-scaled payloads (every leaf in one
    packed reduction)."""
    leaves: List[torch.Tensor] = []
    _map(leaves.append, tree)
    summed = iter(quantized_reduce(leaves, [False] * len(leaves), group,
                                   block))
    return _map(lambda _: next(summed), tree)


def quantized_reduce_scatter(x: torch.Tensor, group=None,
                             block: int = 256) -> torch.Tensor:
    """int8 reduce-scatter: every rank passes the same shape and gets its
    ``x.shape[0] // n`` leading-dim slice of the SUM (one quantization:
    the slice never rides the wire again). Needs ``x.shape[0] % n ==
    0``."""
    return quantized_reduce([x], [True], group, block)[0]


# ------------------------------------------------------------ the host
def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def host_allgather(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every process's dict of host arrays, stacked on a new leading
    axis (one row a rank), on every process."""
    if not _initialized() or dist.get_world_size() == 1:
        return {k: np.asarray(v)[None] for k, v in tree.items()}
    _COUNTS["all_gather"] += 1
    rows: list = [None] * dist.get_world_size()
    dist.all_gather_object(rows, {k: np.asarray(v) for k, v in
                                  tree.items()})
    return {k: np.stack([r[k] for r in rows]) for k in tree}


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every process."""
    if not _initialized() or dist.get_world_size() == 1:
        return obj
    _COUNTS["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sync_barrier(name: str = "barrier") -> None:
    """Wait until every process reaches this point."""
    del name
    if _initialized() and dist.get_world_size() > 1:
        _COUNTS["barrier"] += 1
        dist.barrier()

