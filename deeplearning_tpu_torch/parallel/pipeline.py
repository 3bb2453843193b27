"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis —
the port of ``deeplearning_tpu/parallel/pipeline.py``.

JAX stacks the stages' parameters on a leading S axis sharded over the
``model`` axis and runs the schedule inside ``shard_map``. The port runs
one stage a rank of the axis's process group (``Mesh.group("model")``):
each rank holds its own stage and applies it to the microbatch resident
on it, then ``collectives.ppermute`` moves the activations one stage on.
With M microbatches and S stages the loop runs S + M - 1 ticks (bubble
share (S - 1) / (S + M - 1)), and every stage applies its block on every
tick, bubbles included, as JAX's scan does.

The stage function must keep the activation's shape (the transformer
block setting), so the rotating buffer keeps one shape.

Gradients follow JAX's transposes with the input and the output
replicated over the axis (every rank embeds the batch and computes the
loss from the same logits):

- the microbatches go in replicated and only stage 0 reads them; JAX's
  all-gather of their storage shards transposes to a reduce-scatter, so
  the input's gradient is the SUM over the axis (an all-reduce in the
  backward: the embedding's gradient is the sequential model's on every
  rank);
- the outputs live on the last stage and a psum shares them; its
  transpose hands every rank the cotangent once, with no sum (the
  forward all-reduce has an identity backward).

Every rank builds the same graph (the masks are arithmetic on the
stage's index, not branches), so the backward's collectives come in one
order on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import collectives
from .mesh import MODEL_AXIS, Mesh

__all__ = ["PIPE_AXIS", "pipeline_apply", "stack_stage_params",
           "pack_stages", "pipeline_apply_heterogeneous"]

PIPE_AXIS = MODEL_AXIS      # the model axis carries the stages by default


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (the transpose of JAX's all-gather of the microbatches)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous().clone(),
                                      ctx.group), None


class _Shared(torch.autograd.Function):
    """All-reduce SUM forward (the last stage's outputs to every rank);
    identity backward (JAX's psum of a replicated result)."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _pipeline_schedule(apply_stage: Callable[[Any, torch.Tensor],
                                             torch.Tensor],
                       params: Any, x: torch.Tensor, mesh: Mesh,
                       axis_name: str) -> torch.Tensor:
    """The GPipe fill-drain schedule: ``apply_stage(params, act)`` runs
    this rank's stage on the resident microbatch, then the activations
    move one stage forward."""
    s = mesh.shape[axis_name]
    m = x.shape[0]
    if m % s != 0:
        raise ValueError(
            f"microbatches ({m}) must be divisible by pipeline stages "
            f"({s}): the (M,...) input is sharded P({axis_name!r}) for "
            "storage, so a non-multiple silently truncates outputs")
    group = mesh.group(axis_name)
    idx = mesh.coords[axis_name]
    if s > 1:
        x = _Replicated.apply(x, group)
    perm = [(i, (i + 1) % s) for i in range(s)]
    incoming = 1.0 if idx == 0 else 0.0
    buf = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(s + m - 1):
        # stage 0 ingests microbatch t (if any); the others read buf
        inject = x[t if t < m else 0] * incoming + buf * (1.0 - incoming)
        y = apply_stage(params, inject)
        # the last stage's output at tick t is microbatch t - (s - 1)
        slot = t - (s - 1)
        valid = 0 <= slot < m and idx == s - 1
        # a select, not a branch: every rank builds the same graph
        updated = outputs.index_copy(
            0, torch.tensor([max(slot, 0)], device=x.device), y[None])
        outputs = torch.where(torch.tensor(valid, device=x.device),
                              updated, outputs)
        if s > 1:
            buf = collectives.ppermute(y, perm, group)
        else:
            buf = y
    # the outputs live on the last stage; share them with every rank
    return _Shared.apply(outputs, group) if s > 1 else outputs


def _own_stage(params: Any, idx: int, s: int) -> Any:
    """This rank's stage from a stacked tree: leaves of leading dim S (the
    whole stack) or 1 (this rank's slice of it, as the state holds)."""
    def pick(p):
        if p.shape[0] == s:
            return p[idx]
        if p.shape[0] == 1:
            return p[0]
        raise ValueError(f"a stage leaf of leading dim {p.shape[0]}: "
                         f"want {s} (the stack) or 1 (this rank's stage)")
    return _tree_map(pick, params)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh: Mesh,
                   axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``x`` (M, micro_batch, ...) through the S pipelined stages of
    ``mesh``'s ``axis_name`` ranks; returns (M, micro_batch, ...) on
    every rank. ``stage_params`` is a tree whose leaves carry the leading
    S axis (``stack_stage_params``), whole or as this rank's (1, ...)
    slice of it; ``stage_fn(params_slice, act) -> act`` is applied by
    every rank to the microbatch resident on it."""
    s, idx = mesh.shape[axis_name], mesh.coords[axis_name]
    return _pipeline_schedule(stage_fn, _own_stage(stage_params, idx, s),
                              x, mesh, axis_name)


def stack_stage_params(params_list) -> Any:
    """[stage0_params, stage1_params, ...] (one structure) -> one tree
    with a leading S axis on every leaf."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_list])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in params_list])
                           for i in range(len(first)))
    return torch.stack(list(params_list))


# --------------------------------------------------- heterogeneous stages
def pack_stages(params_list) -> Tuple[torch.Tensor, list]:
    """Pack per-stage parameter trees of DIFFERENT structures into one
    (S, L) float32 tensor (rows zero-padded to the longest stage) plus a
    per-stage unpack function (row -> the stage's tree, in its dtypes).
    Leaves must be floats of at most 32 bits: a wider or integer leaf
    would lose bits on the round trip. The rows have one shape, so they
    lay out over the pipe axis like a stacked tree."""
    flats, unpackers = [], []
    for p in params_list:
        leaves = _tree_leaves(p)
        shapes = [tuple(leaf.shape) for leaf in leaves]
        dtypes = [leaf.dtype for leaf in leaves]
        for d in dtypes:
            if not (d.is_floating_point and torch.finfo(d).bits <= 32):
                raise TypeError(
                    f"pack_stages supports float leaves of <=32 bits, got "
                    f"{d}; keep non-float state out of the packed stage "
                    f"params")
        sizes = [int(np.prod(sh)) if sh else 1 for sh in shapes]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        flat = (torch.cat([leaf.reshape(-1).float() for leaf in leaves])
                if leaves else torch.zeros(0))
        flats.append(flat)

        def make_unpack(tree=p, shapes=shapes, dtypes=dtypes, offs=offs):
            def unpack(vec: torch.Tensor):
                it = iter(range(len(shapes)))

                def leaf(_):
                    i = next(it)
                    return vec[offs[i]:offs[i + 1]].reshape(
                        shapes[i]).to(dtypes[i])
                return _tree_map(leaf, tree)
            return unpack
        unpackers.append(make_unpack())
    length = max((f.shape[0] for f in flats), default=1)
    packed = torch.stack([torch.nn.functional.pad(f, (0, length - len(f)))
                          for f in flats])
    return packed, unpackers


def pipeline_apply_heterogeneous(stage_fns: Sequence[Callable],
                                 params_list: List[Any], x: torch.Tensor,
                                 mesh: Mesh,
                                 axis_name: str = PIPE_AXIS
                                 ) -> torch.Tensor:
    """The GPipe schedule over stages with different parameter
    structures. JAX packs them (``pack_stages``) so every device's shard
    has one shape and picks its stage with ``lax.switch`` on its mesh
    coordinate; here each rank runs its own stage's function on its own
    stage's parameters (``stage_fns[i]`` and ``params_list[i]`` on the
    axis's rank i). Activations must keep one shape across the stage
    boundaries."""
    s = mesh.shape[axis_name]
    if len(stage_fns) != s or len(params_list) != s:
        raise ValueError(f"need exactly {s} stages for axis "
                         f"{axis_name!r}, got {len(stage_fns)}")
    idx = mesh.coords[axis_name]
    return _pipeline_schedule(stage_fns[idx], params_list[idx], x, mesh,
                              axis_name)
