"""Shared plumbing for the sequence-parallel model ``attn_fn`` adapters —
the port of ``deeplearning_tpu/parallel/_seq_adapter.py``.

Both flavors (ring, Ulysses) expose the models' (B, N, H, D) attention
signature through the same adapter: transpose to (B, H, N, D), zero-pad
the token dim to a multiple of the ``seq`` axis, give each seq rank its
chunk, run the flavor's attention on the chunks, gather the chunks back
and slice and transpose to (B, N, H, D). One copy here so the contract
(dropout guard, flash divisibility rule, padding policy) cannot diverge
between the two.

JAX runs the adapter inside one GSPMD program; the port runs it on every
rank of a ``torch.distributed`` group, on this rank's slice of the batch
(the loader cuts it by the data x fsdp index). The stream outside
attention is replicated over ``seq``: every seq rank holds the same
tokens and computes the same loss. So the two moves at the adapter's
edges have the transposes of a replicated value, not of a sum:

- the chunking (forward: this rank's slice of the padded sequence) has a
  backward that sums the zero-padded partial dq/dk/dv over ``seq``: an
  all-gather of the chunks' gradients, each rank holding the gradient of
  its own chunk;
- the gathering (forward: the chunks laid back along the sequence) has a
  backward that hands each rank the slice of its own chunk, not the sum
  over ranks (which would count the same loss once a rank).

The parameter gradients then come out equal on every seq rank, and the
train step reduces them over data x fsdp only.

Beside a ``model`` axis (tensor parallelism) the adapter sees this
rank's heads, (B, N, H / model, D), and runs over the seq group of its
model index; the model group's collectives sit outside it, in the
blocks' column- and row-parallel layers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import collectives
from .mesh import Mesh

__all__ = ["batch_axes", "batch_extent", "seq_attn_adapter",
           "seq_chunk", "seq_gather"]


def batch_axes(mesh: Mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes the batch dim shards over (data, fsdp): the set the
    loader and the train step cut the batch by."""
    axes = tuple(a for a in ("data", "fsdp") if a in mesh.shape)
    return axes or None


def batch_extent(mesh: Mesh, axes: Optional[Tuple[str, ...]]) -> int:
    ext = 1
    for a in axes or ():
        ext *= mesh.shape[a]
    return ext


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` laid along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    collectives.all_gather_dim0(out, src, group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


class _Chunk(torch.autograd.Function):
    """Forward: this rank's slice of a value replicated over the group;
    backward: the slices' gradients gathered (the zero-padded partials
    summed over the group)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Forward: the ranks' slices laid along ``dim`` (a value then
    replicated over the group); backward: this rank's slice of the
    gradient, the same on every rank, never summed over them."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


def seq_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This seq rank's chunk of a replicated ``x`` along ``dim``."""
    if dist.get_world_size(group) == 1:
        return x
    return _Chunk.apply(x, dim % x.dim(), group)


def seq_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The seq ranks' chunks laid back along ``dim``."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), group)


def seq_attn_adapter(mesh: Mesh, axis_size: int, axis_name: str,
                     flavor: str, use_flash: bool,
                     local_call: Callable) -> Callable:
    """Wrap ``local_call(qc, kc, vc, n_valid) -> (B, H, Npad / P, D)``,
    which takes this rank's (B, H, Npad / P, D) chunks, into the models'
    attn_fn signature. ``axis_size`` is the seq-axis extent."""
    group = mesh.group(axis_name)

    def attn_fn(q, k, v, dropout_rate=0.0, deterministic=True, rng=None):
        if dropout_rate and not deterministic:
            raise NotImplementedError(
                f"{flavor} attn_fn does not support attention dropout")
        n = q.shape[1]
        n_pad = -n % axis_size
        if n_pad and use_flash:
            raise ValueError(
                f"the {axis_name} axis size ({axis_size}) must divide "
                f"N={n} for the flash {flavor} path (masking needs the "
                "lax path)")
        # q, k and v move together: one collective each way, not three
        qkv = torch.stack([q, k, v]).transpose(2, 3)   # (3, B, H, N, D)
        if n_pad:
            qkv = F.pad(qkv, (0, 0, 0, n_pad))
        qc, kc, vc = seq_chunk(qkv, 3, group).unbind(0)
        out = seq_gather(local_call(qc, kc, vc, n), 2, group)
        return out[:, :, :n].transpose(1, 2)

    return attn_fn
