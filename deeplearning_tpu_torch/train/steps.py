"""Train and eval steps — the port of ``deeplearning_tpu/train/steps.py``.

``make_train_step(loss_fn)`` returns ``step(state, batch, rng) ->
(state, metrics)``:

- the step's random stream is ``core.rng.step_key(rng, state.step)``, a
  ``torch.Generator`` on the step's device: the same (key, step) draws the
  same masks;
- ``accum_steps > 1`` splits the batch into that many microbatches and
  averages their float32 gradients, losses and metrics (torch BN updates
  its statistics in place between microbatch forwards, as the JAX scan
  threads them);
- gradients are float32 whatever the compute dtype; ``grad_norm`` is
  their global norm before any clip, ``bad_step`` an int32 flag set when
  the loss is not finite. Every metric stays a tensor on the device: the
  step never calls ``.item()`` and never waits for the card.

It runs on the card (``device`` defaults to ``cuda`` and raises when no
card is visible) unless the caller asks for the CPU. On the CPU the step
runs its convolutions without oneDNN: oneDNN's threaded convolutions do
not repeat themselves from run to run, so two runs of one seed would
give other losses (JAX's CPU steps repeat). The native convolution is
bit-equal from run to run at any thread count, and slower; the card's
path is untouched. Batches may be
numpy arrays or tensors; they are moved to the step's device. JAX's
``donate`` flags are accepted: the port updates the state in place
anyway.

With a ``mesh`` (``parallel.mesh.build_mesh``) the step is the JAX
step's GSPMD parallelism written out over ``torch.distributed``, on a
state placed by ``shard_state``:

- each rank takes its own slice of the global batch (the loader's, by
  its data x fsdp index: the ranks that differ only on ``model`` or
  ``seq`` read the same rows) and draws its masks from the step key
  folded with its data index, so the masks on the stream replicated over
  ``model`` and ``seq`` are the same on those ranks;
- parameters a rule splits (FSDP, or a ``model`` rule on a leaf no
  tensor-parallel module takes as a slice) are all-gathered before the
  forward; a training BatchNorm normalises with the moments of the
  global batch (``models.layers.sync_batch_stats``);
- tensor parallelism: a ViT placed under ``TRANSFORMER_TP_RULES`` runs
  its blocks as Megatron's column- and row-parallel layers on this
  rank's slices (``parallel.sharding.bind_tensor_parallel``), and their
  gradients come out as this rank's slices. A leaf gathered over
  ``model`` has the same whole gradient on every model rank, which is
  cut to this rank's slice without a collective;
- the float32 gradients are then mean-reduced over data x fsdp only:
  all-reduced for a moment not split over those axes, reduce-scattered
  to one split over them (ZeRO-1 or FSDP, also beside a ``model``
  split), one packed call a layout; with ``grad_comm="int8"`` through
  the EQuARX collectives (``parallel.collectives.quantized_reduce``:
  reduce-scatter for leaves whose ZeRO-1 spec splits dim 0, psum for the
  rest), then divided by n;
- the optimizer updates this rank's slices and ZeRO-1's updated slices
  are all-gathered back into the replicated parameters;
- loss and metrics are averaged over the ranks in float32, and
  ``grad_norm`` (and ``clip_grad_norm``) is the norm of the whole
  gradient: a split leaf's squares summed over the ranks of its axes, a
  replicated leaf counted once.

At one rank the all-reduce copies and the division is by one, so the
replicated and ZeRO-1 steps equal the step without a mesh bit for bit.

A ``seq`` axis above one is sequence parallelism inside the model: the
model's ``attn_fn`` is a ring or Ulysses adapter
(``parallel.ring_attention`` / ``parallel.ulysses``) on the rank's local
heads, the ranks that differ only on ``seq`` hold the same gradients,
and the step reduces over data x fsdp as above; ZeRO-1 and the int8
collectives are data-parallel modes and refuse it. The pipeline has its
own step (``parallel.pipeline_train``).

An ``expert`` axis is expert parallelism under ``parallel.moe.MOE_RULES``:
the batch is split over data x fsdp only, so the ranks of one expert
group see the same tokens; every ``MoEMlp`` routes over the global batch
(its token group, data x fsdp) and runs its own slice of the experts
(``parallel.moe.bind_expert_parallel``), the combine gathering the
experts' outputs over the expert group. The expert slices' gradients are
this rank's slices, averaged over data x fsdp and never summed over
``expert``; a leaf gathered over ``expert`` (or ``model``) has the same
whole gradient on every rank of that axis and is cut without a
collective.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..models.layers import sync_batch_stats
from ..parallel import collectives
from ..parallel.mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS,
                             SEQ_AXIS, Mesh)
from ..parallel.sharding import (NamedSharding, Rules, StateSharding,
                                 bind_tensor_parallel, gather_global,
                                 local_slice, map_tree, opt_state_shardings,
                                 replicated, shard_params_tree,
                                 zero1_shardings)
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "shard_state"]

LossFn = Callable[..., Tuple[torch.Tensor, Dict]]
_DP = (DATA_AXIS, FSDP_AXIS)


def _to_device(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return batch


def _microbatch(batch: Any, accum_steps: int, i: int) -> Any:
    if isinstance(batch, dict):
        return {k: _microbatch(v, accum_steps, i) for k, v in batch.items()}
    micro = batch.shape[0] // accum_steps
    return batch[i * micro:(i + 1) * micro]


def _value_and_grad(loss_fn: LossFn, params: Dict[str, torch.Tensor],
                    state: TrainState, batch: Any, gen: torch.Generator):
    loss, aux = loss_fn(params, state, batch, gen)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    # float32 gradients: the optimizer sees one dtype at every accum_steps
    return loss.detach(), aux, {
        n: (torch.zeros_like(params[n], dtype=torch.float32) if g is None
            else g.float()) for n, g in zip(names, grads)}


def _rule_axes(rules: Optional[Rules]) -> set:
    out = set()
    for _, spec in rules or ():
        for entry in spec:
            if entry is not None:
                out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _check_mesh(mesh: Mesh, rules: Optional[Rules], weight_update: str,
                grad_comm: str) -> None:
    """The step splits the batch over data x fsdp, the attention's tokens
    over seq and the parameters by the rules; ZeRO-1 and int8 are
    data-parallel modes."""
    if SEQ_AXIS in _rule_axes(rules):
        raise NotImplementedError(f"rules over {[SEQ_AXIS]}: parameters "
                                  "are replicated over seq")
    if mesh.shape[SEQ_AXIS] > 1 and (weight_update == "zero1"
                                     or grad_comm == "int8"):
        raise ValueError("train.weight_update=zero1 / train.grad_comm=int8 "
                         "are data-parallel modes; unset pipeline_stages/"
                         "mesh_model_axis/mesh_seq_axis")
    if mesh.shape[EXPERT_AXIS] > 1 and grad_comm == "int8":
        raise ValueError("grad_comm='int8' is data-parallel only: the "
                         "expert axis shards the experts, the int8 path "
                         "replicates every parameter")


def _forward_params(params: Dict[str, torch.Tensor], sh: StateSharding,
                    layout: Dict[str, NamedSharding], grad: bool
                    ) -> Dict[str, torch.Tensor]:
    """Each parameter as the forward takes it: all-gathered over its
    split axes, but over ``model`` only where no tensor-parallel module
    takes it as this rank's slice (``sh.native``); with ``grad`` a
    gathered copy is a new leaf of autograd."""
    out = {}
    for name, p in params.items():
        gsh = sh.gathered(name, layout)
        if gsh.is_fully_replicated:
            out[name] = p
        else:
            full = gather_global(p.detach(), gsh)
            out[name] = full.requires_grad_() if grad else full
    return out


def _model_slices(grads: Dict[str, torch.Tensor], sh: StateSharding
                  ) -> Dict[str, torch.Tensor]:
    """Every gradient cut to its moments' ``model`` and ``expert`` slice.
    A native leaf's already is one; a leaf gathered over ``model`` or
    ``expert`` has the same whole gradient on every rank of that axis (the
    stream is replicated there), so its cut needs no collective."""
    out = {}
    for name, g in grads.items():
        msh = sh.moments[name].over((MODEL_AXIS, EXPERT_AXIS))
        out[name] = (g if name in sh.native or msh.is_fully_replicated
                     else local_slice(g, msh))
    return out


def _reduce_fp32(grads: Dict[str, torch.Tensor],
                 layouts: Dict[str, NamedSharding], mesh: Mesh,
                 axes: Tuple[str, ...] = _DP) -> Dict[str, torch.Tensor]:
    """The SUM over ``axes`` (data x fsdp) of this rank's gradients, each
    cut to its ``layouts`` slice, packed as DDP packs its buckets: every
    leaf not split over ``axes`` in one flat all-reduce, and the leaves
    split over the same of ``axes`` in one reduce-scatter over those
    axes' group (each leaf's split dim moved first and cut into n rows,
    the rows laid side by side), then all-reduced over the rest of
    ``axes``. One call a layout instead of one a leaf: a call costs the
    host far more than the bytes cost the link. A layout split over any
    other axis (``model``, ``seq``) is refused: those slices are not
    summed."""
    by_axes: Dict[Tuple[str, ...], list] = {}
    for name, g in grads.items():
        dims = layouts[name].dims()
        other = [a for _, ax in dims for a in ax if a not in axes]
        if other or len(dims) > 1:
            raise ValueError(
                f"{name}: a gradient split as {layouts[name].spec} is "
                f"reduced over {axes}, one dim at most")
        by_axes.setdefault(dims[0][1] if dims else (), []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for split, names in by_axes.items():
        if not split:
            flat = torch.cat([grads[nm].reshape(-1) for nm in names])
            collectives.all_reduce(flat, mesh.group(axes))
            for nm, piece in zip(names, flat.split(
                    [grads[nm].numel() for nm in names])):
                out[nm] = piece.view(grads[nm].shape)
            continue
        n = mesh.axis_size(split)
        moved = {}
        for nm in names:
            d = layouts[nm].dims()[0][0]
            moved[nm] = (d, grads[nm].movedim(d, 0))
        rows = torch.cat([m.reshape(n, -1) for _, m in moved.values()],
                         dim=1)
        mine = torch.empty(rows.shape[1], dtype=rows.dtype,
                           device=rows.device)
        collectives.reduce_scatter_dim0(mine.view(1, -1), rows,
                                        mesh.group(split))
        rest = tuple(a for a in axes if a not in split and mesh.shape[a] > 1)
        if rest:
            collectives.all_reduce(mine, mesh.group(rest))
        for nm, piece in zip(names, mine.split(
                [m.numel() // n for _, m in moved.values()])):
            d, m = moved[nm]
            out[nm] = piece.view((m.shape[0] // n,) + tuple(m.shape[1:])
                                 ).movedim(0, d).contiguous()
    return {nm: out[nm] for nm in grads}


def _reduce_int8(grads: Dict[str, torch.Tensor], sh: StateSharding,
                 zero1: bool, group, n: int, block: int
                 ) -> Dict[str, torch.Tensor]:
    """JAX's ``_int8_value_and_grad`` reduction: leaves whose ZeRO-1 spec
    splits dim 0 (and whose dim 0 the n ranks divide) take the int8
    reduce-scatter and come out in the moments' layout; the rest take the
    int8 psum and are cut to their moments' layout."""
    names = list(grads)

    def scatter(name):
        spec = sh.moments[name].spec
        g = grads[name]
        return (zero1 and len(spec) > 0 and spec[0] is not None
                and g.shape[0] % n == 0)

    flags = [scatter(nm) for nm in names]
    out = collectives.quantized_reduce([grads[nm] for nm in names], flags,
                                       group, block)
    return {nm: (g if rs else local_slice(g, sh.moments[nm]))
            for nm, g, rs in zip(names, out, flags)}


def make_train_step(loss_fn: LossFn, mesh: Optional[Mesh] = None,
                    accum_steps: int = 1, donate: bool = True,
                    donate_batch: bool = False,
                    weight_update: str = "replicated",
                    grad_comm: str = "fp32", rules: Optional[Rules] = None,
                    comm_block: int = 256,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable[[TrainState, Any, int],
                                  Tuple[TrainState, Dict]]:
    """Build the train step. ``batch`` leaves have a leading batch dim
    (this rank's slice of the global batch with a mesh) divisible by
    ``accum_steps``; ``rng`` is the run's key (``core.rng.root_key(seed)``).

    ``weight_update="zero1"`` (needs ``mesh``; pair it with
    ``shard_state(..., zero1=True)``) keeps the optimizer moments split
    over the data axes; ``rules`` must be the rules the state was placed
    with. ``grad_comm="int8"`` (needs ``mesh``, ``accum_steps == 1``, no
    ``rules`` and a loss without batch statistics) reduces the gradients
    with block-scaled int8 collectives (blocks of ``comm_block``)."""
    del donate, donate_batch
    if weight_update not in ("replicated", "zero1"):
        raise ValueError(f"weight_update must be 'replicated' or 'zero1', "
                         f"got {weight_update!r}")
    if grad_comm not in ("fp32", "int8"):
        raise ValueError(f"grad_comm must be 'fp32' or 'int8', "
                         f"got {grad_comm!r}")
    if (weight_update == "zero1" or grad_comm == "int8") and mesh is None:
        raise ValueError("weight_update='zero1' / grad_comm='int8' need "
                         "a mesh")
    if grad_comm == "int8" and accum_steps != 1:
        raise ValueError("grad_comm='int8' requires accum_steps == 1 "
                         "(the accumulation is float32; quantizing "
                         "microbatch partial sums would stack quantization "
                         "error accum_steps times)")
    if grad_comm == "int8" and rules:
        raise ValueError("grad_comm='int8' is data-parallel only: TP/FSDP "
                         "rules shard params, but the int8 gradient path "
                         "replicates them")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is None:
        if rules:
            raise ValueError("rules place a state on a mesh: pass mesh=")
        dev = resolve_device(device)
    else:
        _check_mesh(mesh, rules, weight_update, grad_comm)
        dev = mesh.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")

    def step_fn(state: TrainState, batch: Any, rng: int
                ) -> Tuple[TrainState, Dict]:
        run = run_step if mesh is None else run_mesh_step
        if dev.type != "cpu":
            return run(state, batch, rng)
        was = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            return run(state, batch, rng)
        finally:
            torch.backends.mkldnn.enabled = was

    def local_grads(state: TrainState, params: Dict[str, torch.Tensor],
                    batch: Any, gen: torch.Generator):
        """This process's loss, aux, metrics and float32 gradients."""
        if accum_steps == 1:
            loss, aux, grads = _value_and_grad(loss_fn, params, state, batch,
                                               gen)
            metrics = {k: v.detach()
                       for k, v in aux.get("metrics", {}).items()}
            return loss, aux, metrics, grads
        grads, loss, metrics, aux = None, 0.0, {}, {}
        for i in range(accum_steps):
            l, aux, g = _value_and_grad(
                loss_fn, params, state,
                _microbatch(batch, accum_steps, i), gen)
            if grads is None:
                grads = g
            else:
                names = list(grads)
                torch._foreach_add_([grads[n] for n in names],
                                    [g[n] for n in names])
            loss = loss + l
            for k, v in aux.get("metrics", {}).items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
        names = list(grads)
        torch._foreach_div_([grads[n] for n in names], accum_steps)
        loss = loss / accum_steps
        metrics = {k: v / accum_steps for k, v in metrics.items()}
        return loss, aux, metrics, grads

    def run_step(state: TrainState, batch: Any, rng: int
                 ) -> Tuple[TrainState, Dict]:
        gen = rng_mod.step_key(rng, state.step, dev)
        batch = _to_device(batch, dev)
        loss, aux, metrics, grads = local_grads(state, state.params, batch,
                                                gen)
        state.apply_gradients(grads, aux.get("batch_stats"))
        out = {"loss": loss.float(), **metrics}
        out["grad_norm"] = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads.values()))))
        # device-side divergence flag: read lagged, never synced per step
        out["bad_step"] = (~torch.isfinite(loss)).to(torch.int32)
        return state, out

    def run_mesh_step(state: TrainState, batch: Any, rng: int
                      ) -> Tuple[TrainState, Dict]:
        sh = state.sharding
        if sh is None or sh.mesh is not mesh:
            raise ValueError("place the state on this mesh first: "
                             "shard_state(state, mesh, rules, zero1)")
        group, n = mesh.group(_DP), mesh.axis_size(_DP)
        # each rank its own masks: the step key folded with its data index
        gen = rng_mod.step_key(rng_mod.fold_in(rng, state.step),
                               mesh.axis_index(_DP), dev)
        batch = _to_device(batch, dev)
        params = _forward_params(state.params, sh, sh.params, grad=True)
        sync = (sync_batch_stats(group) if n > 1 and grad_comm == "fp32"
                else contextlib.nullcontext())
        with sync:
            loss, aux, metrics, grads = local_grads(state, params, batch,
                                                    gen)
        if grad_comm == "int8":
            if "batch_stats" in aux:
                raise ValueError(
                    "grad_comm='int8' does not support batch_stats losses: "
                    "BN statistics would need their own cross-replica "
                    "reduction (use a model without BatchNorm or fp32 comm)")
            grads = _reduce_int8(grads, sh, weight_update == "zero1",
                                 group, n, comm_block)
        else:
            grads = _reduce_fp32(
                _model_slices(grads, sh),
                {nm: sh.moments[nm].over(_DP) for nm in grads}, mesh)
        names = list(grads)
        torch._foreach_div_([grads[nm] for nm in names], n)
        # loss and metrics averaged over the ranks, in float32
        keys = list(metrics)
        vals = torch.stack([loss.float()]
                           + [metrics[k].float() for k in keys])
        vals = collectives.all_reduce(vals, group) / n
        state.apply_gradients(grads, aux.get("batch_stats"))
        out = {"loss": vals[0], **dict(zip(keys, vals[1:]))}
        out["grad_norm"] = (
            sh.global_norm(grads) if sh.any_sharded else
            torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [grads[nm] for nm in names]))))
        out["bad_step"] = (~torch.isfinite(vals[0])).to(torch.int32)
        return state, out

    return step_fn


def make_eval_step(metric_fn: Callable[..., Dict],
                   mesh: Optional[Mesh] = None, use_ema: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[[TrainState, Any], Dict]:
    """``metric_fn(params, state, batch)`` returns per-batch metric SUMS
    (summing, not averaging, lets callers weight by true batch size). The
    EMA params are used when the state keeps them and ``use_ema``. With a
    ``mesh`` each rank scores its slice of the batch with the parameters
    as the train step's forward takes them (gathered, a tensor-parallel
    block's slices kept) and the sums are added over data x fsdp."""
    dev = resolve_device(device) if mesh is None else mesh.device

    def step_fn(state: TrainState, batch: Any) -> Dict:
        with torch.no_grad():
            params = state.eval_params if use_ema else state.params
            if mesh is None:
                return metric_fn(params, state, _to_device(batch, dev))
            sh = state.sharding
            if sh is None or sh.mesh is not mesh:
                raise ValueError("place the state on this mesh first: "
                                 "shard_state(state, mesh, rules, zero1)")
            layout = (sh.ema if use_ema and state.ema_params is not None
                      else sh.params)
            params = _forward_params(params, sh, layout, grad=False)
            out = metric_fn(params, state, _to_device(batch, dev))
            return collectives.psum_tree(out, mesh.group(_DP))

    return step_fn


def shard_state(state: TrainState, mesh: Mesh,
                rules: Optional[Rules] = None,
                zero1: bool = False) -> TrainState:
    """Place ``state`` on ``mesh``, in place: the model moves to the
    mesh's device, every parameter (and its EMA) is cut to this rank's
    slice of its layout under ``rules`` (default: replicated, pure data
    parallel), and the optimizer moments (the state's dicts keyed by every
    parameter) follow the params' layout, or with ``zero1`` are split over
    the data axes where a dim divides (a leaf a rule splits keeps the
    rule's layout; the rest stay replicated, as ``shard_layout_summary``
    shows). Counts and other leaves stay replicated. The model's
    tensor-parallel modules whose parameters the rules split in
    Megatron's layout over ``model`` run on their slices
    (``bind_tensor_parallel``), and so do its MoE layers whose experts
    the rules split over ``expert`` (``parallel.moe.bind_expert_parallel``,
    which also gives every MoE layer the data x fsdp group it routes
    over). Returns the state, its layout in ``state.sharding``."""
    from ..parallel.moe import bind_expert_parallel
    param_sh = shard_params_tree(state.params, mesh, rules)
    native = (bind_tensor_parallel(state.model, param_sh, mesh)
              | bind_expert_parallel(state.model, param_sh, mesh))
    moment_sh = (zero1_shardings(state.params, mesh, rules, base=param_sh)
                 if zero1 else param_sh)
    place_state(state, mesh, param_sh, moment_sh)
    state.sharding.native = native
    return state


def place_state(state: TrainState, mesh: Mesh,
                param_sh: Dict[str, Any], moment_sh: Dict[str, Any]
                ) -> TrainState:
    """Place ``state`` on ``mesh`` with the given layouts of the params
    and of the optimizer moments (``shard_state``'s and
    ``parallel.pipeline_train.shard_pipeline_state``'s second half)."""
    if state.sharding is not None:
        raise ValueError("the state is already placed on a mesh")
    state.model.to(mesh.device)
    params = state.params
    rep = replicated(mesh)
    opt_sh = opt_state_shardings(state.opt_state, list(params), moment_sh,
                                 rep)
    ema_sh = dict(param_sh) if state.ema_params is not None else None

    def place(t: torch.Tensor, sh) -> torch.Tensor:
        t = t.to(mesh.device)
        return t if sh.is_fully_replicated else local_slice(t, sh)

    with torch.no_grad():
        for name, p in params.items():
            if not param_sh[name].is_fully_replicated:
                p.data = local_slice(p.data, param_sh[name])
        state.opt_state = map_tree(place, state.opt_state, opt_sh)
        if state.ema_params is not None:
            state.ema_params = map_tree(place, state.ema_params, ema_sh)
    state.sharding = StateSharding(mesh, param_sh, moment_sh, opt_sh, ema_sh)
    return state
