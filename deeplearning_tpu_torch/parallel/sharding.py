"""Sharding rules and layouts — the port of
``deeplearning_tpu/parallel/sharding.py``.

JAX places every leaf with a ``NamedSharding`` and GSPMD moves the data.
The port keeps each sharded leaf as this rank's slice: a plain
contiguous tensor, so the train step, the kernels' wrappers, the
optimizer's ``_foreach`` calls and the checkpoint see ordinary tensors.
``NamedSharding(mesh, spec)`` is the layout record beside it, and
``local_slice`` / ``gather_global`` move a leaf between its global value
and this rank's slice (``all_gather`` over ``Mesh.group`` of the dim's
axes).

The rules are JAX's regexes, matched on each parameter's flax path
(``utils/convert.flax_path``: ``blocks.0.attn.qkv.weight`` ->
``blocks_0/attn/qkv/kernel``), with the first matching rule winning and
a rule skipped when its spec has more entries than the leaf has dims.
Their specs are re-expressed on the port's layouts, so that rank r's
slice holds the elements of JAX's shard on device r: a Dense kernel
``(in, out)`` is a Linear weight ``(out, in)`` (JAX ``P(None, X)`` is dim
0 here, ``P(X, None)`` dim 1), an HWIO conv kernel is OIHW (JAX's
``P(None, None, None, X)`` is dim 0), and a ViT patch projection is a 2-D
Linear weight whose dim 0 is the kernel's O.

One layout differs from JAX's shard on purpose: the fused ``qkv`` of an
attention that runs Megatron's blocks (``bind_tensor_parallel``), split
over ``model`` along its output dim. Column-parallel attention needs
whole heads of q, k and v on each rank, and a contiguous cut of ``3 * D``
outputs would give rank 0 all of q and half of k. The module's
``tp_layout`` says so, and the binding records the dim in its
``NamedSharding`` as split within each of its 3 equal parts (``parts``):
rank r holds rows ``[r * D / n, (r + 1) * D / n)`` of q, of k and of v,
laid one after the other. ``gather_global`` puts them back, so the
gathered leaf equals JAX's whole leaf bit for bit;
``shard_layout_summary`` reports the spec alone, as JAX does.

ZeRO-1 (``zero1_partition_spec``) shards the first dim of the port's own
shape that the data-parallel extent divides. Whether such a dim exists
does not depend on the order of the dims, so the same leaves stay
replicated as in JAX and a rank holds the same bytes; for a 2-D or 4-D
leaf the slice is along another dim than JAX's.

``StateSharding`` is a sharded ``TrainState``'s record: the params' and
the optimizer moments' layouts, and the moves between them that the
train step makes (``update_views``, ``complete_update``) and the
checkpoint makes (``gather_tree``, ``slice_tree``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..utils.convert import flax_path
from . import collectives
from .mesh import (AXES, DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS,
                   Mesh, rank, world_size)

__all__ = ["PartitionSpec", "P", "NamedSharding", "Rules", "batch_spec",
           "batch_sharding", "replicated", "logical_to_sharding",
           "tree_paths", "shard_params_tree", "TRANSFORMER_TP_RULES",
           "FSDP_RULES", "zero1_partition_spec", "zero1_shardings",
           "opt_state_shardings", "tree_bytes_per_device",
           "shard_layout_summary", "host_local_slice", "make_global_array",
           "local_slice", "gather_global", "map_tree", "StateSharding",
           "bind_tensor_parallel",
           "DATA_AXIS", "FSDP_AXIS", "MODEL_AXIS"]


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dim, each None (replicated),
    an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec
Rules = Sequence[Tuple[str, PartitionSpec]]


def _axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout on ``mesh``: dim d is split over ``spec[d]``'s
    axes (row-major over them), the dims past the spec are whole. A
    ``(d, k)`` pair of ``parts`` splits dim d within each of its k equal
    parts (a fused qkv's q, k and v) instead of as one run."""
    mesh: Mesh
    spec: PartitionSpec
    parts: Tuple[Tuple[int, int], ...] = ()

    def dims(self) -> List[Tuple[int, Tuple[str, ...]]]:
        """(dim, axes) of every dim split over more than one rank."""
        return [(d, _axes(e)) for d, e in enumerate(self.spec)
                if _axes(e) and self.mesh.axis_size(_axes(e)) > 1]

    def parts_of(self, dim: int) -> int:
        """The equal parts dim ``dim`` is split within (1: one run)."""
        return dict(self.parts).get(dim, 1)

    def over(self, axes: Sequence[str]) -> "NamedSharding":
        """This layout with only the splits over ``axes`` (a dim split
        over these and other axes at once is refused)."""
        spec: List[Any] = []
        for d, e in enumerate(self.spec):
            mine = tuple(a for a in _axes(e) if a in axes)
            if mine and len(mine) != len(_axes(e)):
                raise ValueError(f"dim {d} is split over {_axes(e)} at "
                                 f"once; the port splits a dim over "
                                 f"{tuple(axes)} alone")
            spec.append(e if mine else None)
        kept = {d for d, e in enumerate(spec) if e is not None}
        return NamedSharding(self.mesh, P(*spec),
                             tuple(p for p in self.parts if p[0] in kept))

    @property
    def is_fully_replicated(self) -> bool:
        return not self.dims()

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, axes in self.dims():
            n, k = self.mesh.axis_size(axes), self.parts_of(d)
            if out[d] % (n * k):
                raise ValueError(
                    f"dim {d} of a {tuple(shape)} leaf is {out[d]}, not "
                    f"divisible by the {n} ranks of {axes}"
                    + (f" in each of its {k} parts" if k > 1 else ""))
            out[d] //= n
        return tuple(out)

    def same_layout(self, other: "NamedSharding") -> bool:
        split = {d for d, _ in self.dims()}
        return self.dims() == other.dims() and all(
            self.parts_of(d) == other.parts_of(d) for d in split)


def batch_spec() -> PartitionSpec:
    """The leading (batch) dim over data x fsdp; the rest whole."""
    return P((DATA_AXIS, FSDP_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Parameter sharding by regex rules over flax paths; first match wins and
# the default is replicated.
# ---------------------------------------------------------------------------

def logical_to_sharding(mesh: Mesh, rules: Optional[Rules]
                        ) -> Callable[[str, torch.Tensor], NamedSharding]:
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or [])]

    def lookup(name: str, leaf: torch.Tensor) -> NamedSharding:
        path = flax_path(name, leaf.dim())
        for pat, spec in compiled:
            if pat.search(path) and len(spec) <= leaf.dim():
                return NamedSharding(mesh, spec)
        return NamedSharding(mesh, P())
    return lookup


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a tree of dicts, tuples and lists,
    the keys '/'-joined (a parameter keeps its port name)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def shard_params_tree(params: Dict[str, torch.Tensor], mesh: Mesh,
                      rules: Optional[Rules] = None
                      ) -> Dict[str, NamedSharding]:
    """A ``NamedSharding`` a parameter under ``rules``."""
    lookup = logical_to_sharding(mesh, rules)
    return {n: lookup(n, p) for n, p in params.items()}


# JAX's Megatron layout (qkv and mlp-in column-parallel, proj and mlp-out
# row-parallel) on Linear weights: JAX's P(None, model) is dim 0 here,
# P(model, None) dim 1
TRANSFORMER_TP_RULES: Rules = (
    (r"(qkv|query|key|value|mlp/fc1|Dense_0)/kernel$", P(MODEL_AXIS, None)),
    (r"(proj|out|mlp/fc2|Dense_1)/kernel$", P(None, MODEL_AXIS)),
    (r"(qkv|query|key|value|mlp/fc1|Dense_0)/bias$", P(MODEL_AXIS)),
)

# JAX's FSDP rules: the row-parallel kernels (attention proj, mlp fc2)
# split their input dim (Linear dim 1), every other Dense kernel its
# output dim (Linear dim 0), and a conv kernel its output channels
# (OIHW dim 0). The 4-entry conv rule comes before the 2-D one, which a
# 4-D leaf never reaches.
FSDP_RULES: Rules = (
    (r"(attn/proj|mlp/fc2)/kernel$", P(None, FSDP_AXIS)),
    (r"kernel$", P(FSDP_AXIS, None, None, None)),
    (r"kernel$", P(FSDP_AXIS, None)),
)


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer moments shard over the data axes.
# ---------------------------------------------------------------------------

def zero1_partition_spec(shape: Tuple[int, ...], dp: int) -> PartitionSpec:
    """The FIRST dim of ``shape`` that the data-parallel extent ``dp``
    divides, over ('data', 'fsdp'); ``P()`` when none does (the small
    tail stays replicated, not padded)."""
    if dp <= 1:
        return P()
    for d, size in enumerate(shape):
        if size >= dp and size % dp == 0:
            spec: List[Any] = [None] * len(shape)
            spec[d] = (DATA_AXIS, FSDP_AXIS)
            return P(*spec)
    return P()


def zero1_shardings(params: Dict[str, torch.Tensor], mesh: Mesh,
                    rules: Optional[Rules] = None,
                    base: Optional[Dict[str, NamedSharding]] = None
                    ) -> Dict[str, NamedSharding]:
    """The moments' layouts under ZeRO-1: a leaf a rule shards keeps the
    rule's layout (``base``'s, default the rules'), a rule-replicated leaf
    shards over the whole data-parallel extent where a dim divides."""
    dp = mesh.axis_size((DATA_AXIS, FSDP_AXIS))
    if base is None:
        base = shard_params_tree(params, mesh, rules)
    return {n: (sh if not sh.is_fully_replicated else NamedSharding(
        mesh, zero1_partition_spec(tuple(params[n].shape), dp)))
        for n, sh in base.items()}


def opt_state_shardings(opt_state: Any, param_names: Sequence[str],
                        param_sh: Dict[str, NamedSharding],
                        rep: NamedSharding) -> Any:
    """A tree mirroring an optimizer state: a dict keyed by every
    parameter name (Adam's ``mu`` / ``nu``, momentum's ``trace``) gets
    ``param_sh``; every other leaf (counts, masked sub-states) ``rep``."""
    names = set(param_names)

    def go(node: Any) -> Any:
        if isinstance(node, dict):
            if node and set(node) == names:
                return {k: param_sh[k] for k in node}
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return rep
    return go(opt_state)


def tree_bytes_per_device(tree: Any) -> int:
    """Bytes ONE rank holds for a tree: the port keeps local slices (a
    qkv split within its parts holds as many as a contiguous cut), so
    this is the sum of its tensors' bytes."""
    return sum(int(t.numel()) * t.element_size()
               for _, t in tree_paths(tree) if isinstance(t, torch.Tensor))


def shard_layout_summary(shardings: Any) -> Dict[str, Any]:
    """The spec of every split leaf of a tree of ``NamedSharding``s
    (keyed by path) and the leaf counts, as JAX's summary of a placed
    tree (the spec alone: a qkv's ``parts`` are the port's layout of the
    same spec)."""
    specs: Dict[str, str] = {}
    counts = {"leaves": 0, "replicated": 0, "sharded": 0}
    for path, sh in tree_paths(shardings):
        if not isinstance(sh, NamedSharding):
            continue
        counts["leaves"] += 1
        if sh.is_fully_replicated:
            counts["replicated"] += 1
        else:
            counts["sharded"] += 1
            specs[path] = str(tuple(sh.spec))
    return {"specs": specs, **counts}


def host_local_slice(global_batch: int,
                     mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[start, end) of this rank's slice of a global batch: by its index
    on data x fsdp of ``mesh`` (the ranks that differ only on seq or
    model read the same rows), or by its world rank without a mesh."""
    if mesh is None:
        n, i = world_size(), rank()
    else:
        n, i = (mesh.axis_size((DATA_AXIS, FSDP_AXIS)),
                mesh.axis_index((DATA_AXIS, FSDP_AXIS)))
    per_rank = global_batch // n
    return i * per_rank, (i + 1) * per_rank


def make_global_array(local_batch: Union[np.ndarray, torch.Tensor],
                      mesh: Mesh,
                      spec: Optional[PartitionSpec] = None) -> torch.Tensor:
    """A rank's batch on its device. JAX assembles the hosts' batches
    into one global array; here a rank's batch stays local and the
    process group is the global view (the step reduces over it)."""
    if spec is not None and tuple(spec) != tuple(batch_spec()):
        raise ValueError(f"a rank's batch is split as {batch_spec()}, "
                         f"got {spec}")
    if isinstance(local_batch, np.ndarray):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    return local_batch.to(mesh.device, non_blocking=True)


# ---------------------------------------------------------------------------
# Moves between a leaf's global value and this rank's slice.
# ---------------------------------------------------------------------------

def local_slice(x: torch.Tensor, sh: NamedSharding,
                view: bool = False) -> torch.Tensor:
    """This rank's slice of the global ``x`` (a copy, or with ``view`` a
    view into ``x``, which a dim split within its parts cannot give)."""
    out = x
    shape = sh.shard_shape(x.shape)
    for d, axes in sh.dims():
        i, k = sh.mesh.axis_index(axes), sh.parts_of(d)
        if k == 1:
            out = out.narrow(d, i * shape[d], shape[d])
            continue
        if view:
            raise ValueError(f"dim {d} is split within its {k} parts: "
                             "its slice is not a view")
        m = shape[d] // k
        out = out.unflatten(d, (k, -1)).narrow(d + 1, i * m, m).flatten(
            d, d + 1)
    return out if view or out is x else out.clone()


def gather_global(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """The global value of this rank's slice ``x`` (an all-gather along
    each split dim over its axes' group; a dim split within its parts
    has each part's rows put back in rank order)."""
    for d, axes in reversed(sh.dims()):
        n, k = sh.mesh.axis_size(axes), sh.parts_of(d)
        src = x.movedim(d, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        collectives.all_gather_dim0(out, src, sh.mesh.group(axes))
        if k > 1:      # (rank, part, row) -> (part, rank, row)
            out = out.unflatten(0, (n, k, -1)).transpose(0, 1).flatten(0, 2)
        x = out.movedim(0, d)
    return x.contiguous()


def map_tree(fn: Callable[[torch.Tensor, NamedSharding], torch.Tensor],
             tree: Any, shardings: Any) -> Any:
    """``tree`` with every tensor leaf t replaced by ``fn(t, sh)``, sh its
    leaf of the mirroring ``shardings`` tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, s)
                          for v, s in zip(tree, shardings))
    return tree


def _model_dim(sh: NamedSharding) -> Optional[int]:
    """The one dim ``sh`` splits over ``model``; None when none is;
    refused when several are."""
    dims = [d for d, axes in sh.dims() if MODEL_AXIS in axes]
    if len(dims) > 1:
        raise ValueError(f"{sh.spec} splits {len(dims)} dims over "
                         f"{MODEL_AXIS!r}")
    return dims[0] if dims else None


def bind_tensor_parallel(model: torch.nn.Module,
                         layouts: Dict[str, NamedSharding],
                         mesh: Mesh) -> frozenset:
    """Megatron's blocks on ``mesh``'s ``model`` axis. Every module with a
    ``tp_layout(n)`` (the ViT's ``Attention`` and ``Mlp``: each of its
    parameters' (dim, parts) split over n ranks, None for a replicated
    one) whose parameters ``layouts`` split over ``model`` along exactly
    those dims gets the model group as ``model_group`` and runs on its
    slices, and ``layouts`` records their ``parts`` in place; every other
    module gets None (its split leaves are all-gathered before the
    forward). Returns the names of the parameters the bound modules use
    as slices. Collective the first time (the group), so every rank calls
    it, before the state is cut to the layouts."""
    n = mesh.shape[MODEL_AXIS]
    tp = [(prefix, mod) for prefix, mod in model.named_modules()
          if hasattr(mod, "tp_layout")]
    group = mesh.group(MODEL_AXIS) if tp and n > 1 else None
    native: set = set()
    for prefix, mod in tp:
        want = (mod.tp_layout(n) if group is not None else None) or {}
        own = dict(mod.named_parameters())
        names = {f"{prefix}.{k}" if prefix else k: v
                 for k, v in want.items() if k in own}
        bound = bool(names) and all(
            _model_dim(layouts[nm]) == (v[0] if v else None)
            for nm, v in names.items())
        mod.model_group = group if bound else None
        if not bound:
            continue
        native.update(names)
        for nm, v in names.items():
            if v and v[1] > 1:
                layouts[nm] = dataclasses.replace(layouts[nm], parts=(v,))
    return frozenset(native)


class StateSharding:
    """The layout record of a sharded ``TrainState``: ``params`` and
    ``ema`` are the params' layouts, ``moments`` the optimizer moments'
    (the gradients' layout in the step), ``opt_state`` the mirror of the
    optimizer state, ``native`` the parameters that tensor-parallel
    modules use as this rank's ``model`` slices (``bind_tensor_parallel``)."""

    def __init__(self, mesh: Mesh, params: Dict[str, NamedSharding],
                 moments: Dict[str, NamedSharding], opt_state: Any,
                 ema: Optional[Dict[str, NamedSharding]],
                 native: frozenset = frozenset()):
        self.mesh = mesh
        self.params = params
        self.moments = moments
        self.opt_state = opt_state
        self.ema = ema
        self.native = frozenset(native)

    def gathered(self, name: str, layout: Dict[str, NamedSharding]
                 ) -> NamedSharding:
        """The splits of ``name`` (laid out by ``layout``) that the
        forward all-gathers: all, or for a ``native`` leaf all but the
        ``model`` and ``expert`` axes'."""
        if name in self.native:
            return layout[name].over(tuple(
                a for a in AXES if a not in (MODEL_AXIS, EXPERT_AXIS)))
        return layout[name]

    def tree(self) -> Dict[str, Any]:
        """The mirror of ``TrainState.state_dict()``'s sharded parts."""
        return {"params": self.params, "opt_state": self.opt_state,
                "ema_params": self.ema}

    @property
    def any_sharded(self) -> bool:
        return any(not s.is_fully_replicated
                   for s in list(self.params.values())
                   + list(self.moments.values()))

    def gather_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """``tree`` (``params`` / ``opt_state`` / ``ema_params`` of local
        slices) with every leaf's global value; collective."""
        sh = self.tree()
        return {k: (map_tree(gather_global, v, sh[k]) if k in sh else v)
                for k, v in tree.items()}

    def slice_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """The reverse: global values cut to this rank's slices."""
        sh = self.tree()
        return {k: (map_tree(local_slice, v, sh[k]) if k in sh else v)
                for k, v in tree.items()}

    def update_views(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Each parameter in its moments' layout: itself where the two
        layouts agree, else (a replicated parameter, ZeRO-1 moments) a view
        of this rank's slice, so that an in-place update writes into it."""
        out = {}
        for n, p in params.items():
            psh, msh = self.params[n], self.moments[n]
            if psh.same_layout(msh):
                out[n] = p
            elif psh.is_fully_replicated:
                out[n] = local_slice(p, msh, view=True)
            else:
                raise ValueError(f"{n}: moments laid out as {msh.spec} "
                                 f"over params laid out as {psh.spec}")
        return out

    @torch.no_grad()
    def complete_update(self, params: Dict[str, torch.Tensor],
                        views: Dict[str, torch.Tensor]) -> None:
        """All-gather every updated slice back into its replicated
        parameter (ZeRO-1's second half)."""
        for n, p in params.items():
            if views[n] is not p:
                p.copy_(gather_global(views[n], self.moments[n]))

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from the leaves in the moments'
        layout: each split leaf's squared norm is summed over the ranks
        of its axes, a replicated leaf's counted once."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for n, g in grads.items():
            axes = tuple(a for _, ax in self.moments[n].dims() for a in ax)
            by_axes.setdefault(axes, []).append(g)
        total = None
        for axes, gs in by_axes.items():
            sq = torch.stack(torch._foreach_norm(gs)).float().square().sum()
            if axes:
                collectives.all_reduce(sq, self.mesh.group(axes))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
