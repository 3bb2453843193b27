"""Pipeline-parallel training for the ViT family — the port of
``deeplearning_tpu/parallel/pipeline_train.py``.

The ViT's parameters split into ``outer`` (patch embed, cls/pos, the
final norm, the head: replicated) and ``stages`` (the D blocks stacked
into S stages of D / S blocks, each leaf with a leading S axis laid out
over the ``model`` axis, so that each rank holds its own stage). The
forward runs embed -> the GPipe schedule (``parallel.pipeline``) over
the microbatches -> head on every rank; autograd runs back through the
schedule, and one optimizer step updates the outer parameters and this
rank's stage.

JAX keeps the two halves in a ``{'outer', 'stages'}`` tree. The port's
state is a ``TrainState`` over ``vit_pipeline_module``'s module, whose
parameters are named ``outer.<ViT name>`` and ``stages.sub<k>.<block
name>``; ``shard_pipeline_state`` places it (``stages.*`` split on their
leading axis over ``model``, the rest replicated), so a checkpoint of it
holds the whole stacked state, as JAX's does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from .mesh import DATA_AXIS, FSDP_AXIS, Mesh
from .pipeline import PIPE_AXIS, pipeline_apply

__all__ = ["split_vit_params", "vit_pipeline_module",
           "make_vit_pipeline_forward", "make_pipeline_train_step",
           "shard_pipeline_state", "PIPE_AXIS"]

_DP = (DATA_AXIS, FSDP_AXIS)


def _block_index(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "blocks" else None


def split_vit_params(params: Dict[str, torch.Tensor], num_stages: int
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor], int]:
    """A ViT's named parameters -> (outer, stacked stages, blocks a
    stage). Stage j holds blocks [j*K, (j+1)*K) as ``sub<k>.<name>``
    leaves with a leading S axis."""
    depth = len({_block_index(n) for n in params} - {None})
    if depth == 0:
        raise ValueError("pipeline_stages needs a ViT-style model with "
                         "blocks_<i> params")
    if depth % num_stages:
        raise ValueError(f"depth {depth} not divisible by "
                         f"pipeline_stages={num_stages}")
    k_per = depth // num_stages
    stages: Dict[str, torch.Tensor] = {}
    for name in params:
        if _block_index(name) != 0:
            continue
        rest = name.split(".", 2)[2]
        for k in range(k_per):
            stages[f"sub{k}.{rest}"] = torch.stack(
                [params[f"blocks.{j * k_per + k}.{rest}"]
                 for j in range(num_stages)])
    outer = {n: p for n, p in params.items() if _block_index(n) is None}
    return outer, stages, k_per


class _Params(nn.Module):
    """A module that only holds parameters, registered along dotted
    names (so ``named_parameters`` gives the names back)."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in named.items():
            mod: nn.Module = self
            *path, leaf = name.split(".")
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            mod.register_parameter(leaf, nn.Parameter(t.detach().clone()))


def vit_pipeline_module(model: nn.Module, num_stages: int
                        ) -> Tuple[nn.Module, int]:
    """(module, blocks a stage): the ViT's parameters in the pipeline
    layout, ``outer.<name>`` and ``stages.sub<k>.<name>`` (copies), for
    ``TrainState.create(model=module, ...)``."""
    outer, stages, k_per = split_vit_params(
        dict(model.named_parameters()), num_stages)
    named = {**{f"outer.{n}": p for n, p in outer.items()},
             **{f"stages.{n}": p for n, p in stages.items()}}
    return _Params(named), k_per


def _sub(tree: Dict[str, torch.Tensor], prefix: str) -> Dict[str,
                                                             torch.Tensor]:
    return {n[len(prefix):]: p for n, p in tree.items()
            if n.startswith(prefix)}


def _dense(x, w, b, dtype):
    return F.linear(x.to(dtype), w.to(dtype), None if b is None
                    else b.to(dtype))


def _embed(model, outer: Dict[str, torch.Tensor],
           images: torch.Tensor) -> torch.Tensor:
    """Patch embed + cls token + pos embed (the ViT forward before the
    blocks) on the outer parameters."""
    x = functional_call(model.patch_embed, _sub(outer, "patch_embed."),
                        (images,))
    b, _, c = x.shape
    cls = outer["cls_token"].to(x.dtype).expand(b, 1, c)
    return torch.cat([cls, x], dim=1) + outer["pos_embed"].to(x.dtype)


def _head(model, outer: Dict[str, torch.Tensor],
          x: torch.Tensor) -> torch.Tensor:
    x = functional_call(model.norm, _sub(outer, "norm."), (x,))[:, 0]
    if "pre_logits.weight" in outer:
        x = torch.tanh(_dense(x, outer["pre_logits.weight"],
                              outer["pre_logits.bias"], model.dtype))
    return _dense(x, outer["head.weight"], outer["head.bias"],
                  model.dtype).float()


def _drop_rates(model) -> list:
    rates = [model.pos_drop.rate]
    for blk in model.blocks:
        rates += [blk.drop_path.rate, blk.attn.attn_drop,
                  blk.attn.proj_dropout.rate, blk.mlp.drop.rate]
    return rates


def make_vit_pipeline_forward(model, mesh: Mesh, k_per_stage: int,
                              microbatches: int,
                              axis_name: str = PIPE_AXIS) -> Callable:
    """``forward(params, images) -> logits``, pipelined: ``params`` the
    pipeline module's named parameters (``outer.*``, ``stages.*``);
    ``model`` the ViT whose modules (and ``attn_fn``) run them. Its own
    parameters are never read: move them to ``meta`` once
    ``vit_pipeline_module`` has copied them."""
    if any(_drop_rates(model)):
        raise ValueError(
            "pipeline_stages currently requires drop_rate = "
            "attn_drop_rate = drop_path_rate = 0 on the model; the "
            "schedule runs deterministically")
    block = model.blocks[0]

    def stage_fn(stage_params, act):
        for k in range(k_per_stage):
            act = functional_call(block, _sub(stage_params, f"sub{k}."),
                                  (act,))
        return act

    def forward(params, images):
        x = _embed(model, _sub(params, "outer."), images)
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible by "
                             f"microbatches={microbatches}")
        acts = x.reshape(microbatches, b // microbatches, *x.shape[1:])
        acts = pipeline_apply(stage_fn, _sub(params, "stages."), acts, mesh,
                              axis_name)
        return _head(model, _sub(params, "outer."),
                     acts.reshape(b, *x.shape[1:]))

    return forward


def make_pipeline_train_step(model, mesh: Mesh, k_per_stage: int,
                             microbatches: int,
                             label_smoothing: float = 0.0,
                             axis_name: str = PIPE_AXIS):
    """(train_step, eval_step) over a ``TrainState`` of
    ``vit_pipeline_module``'s module placed by ``shard_pipeline_state``.
    ``train_step(state, batch, rng)`` returns the loss, accuracy,
    ``grad_norm`` and ``bad_step`` of the train step's metrics; the
    gradients are this rank's stage's and the outer parameters' (equal on
    every stage), averaged over data x fsdp when that extent is above
    one. ``eval_step`` returns ``top1`` / ``count`` sums; the state
    applies its own optimizer."""
    from ..ops import losses
    from ..evaluation.metrics import topk_correct
    from . import collectives
    forward = make_vit_pipeline_forward(model, mesh, k_per_stage,
                                        microbatches, axis_name)
    dev = mesh.device
    n_dp = mesh.axis_size(_DP)

    def placed(state):
        sh = state.sharding
        if sh is None or sh.mesh is not mesh:
            raise ValueError("place the state on this mesh first: "
                             "shard_pipeline_state(state, mesh)")
        return sh

    def to_dev(batch):
        return {k: (torch.from_numpy(v) if not isinstance(v, torch.Tensor)
                    else v).to(dev, non_blocking=True)
                for k, v in batch.items()}

    def train_step(state, batch, rng):
        del rng                          # the schedule is deterministic
        sh = placed(state)
        batch = to_dev(batch)
        params = state.params
        logits = forward(params, batch["image"])
        labels = batch["label"]
        loss = losses.cross_entropy(logits, labels, label_smoothing)
        acc = (logits.argmax(-1) == labels).float().mean()
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(params[n], dtype=torch.float32)
                     if g is None else g.float())
                 for n, g in zip(names, grads)}
        vals = torch.stack([loss.detach().float(), acc])
        if n_dp > 1:
            group = mesh.group(_DP)
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            collectives.all_reduce(flat, group)
            flat /= n_dp
            grads = {n: piece.view(grads[n].shape) for n, piece in zip(
                names, flat.split([grads[n].numel() for n in names]))}
            vals = collectives.all_reduce(vals, group) / n_dp
        state.apply_gradients(grads)
        return state, {"loss": vals[0], "accuracy": vals[1],
                       "grad_norm": sh.global_norm(grads),
                       "bad_step": (~torch.isfinite(vals[0])).to(
                           torch.int32)}

    def eval_step(state, batch):
        placed(state)
        batch = to_dev(batch)
        with torch.no_grad():
            logits = forward(state.params, batch["image"])
            # count-style metrics: the Trainer divides by "count"
            counts = topk_correct(logits, batch["label"], ks=(1,))
            if n_dp > 1:
                counts = collectives.psum_tree(counts, mesh.group(_DP))
        return counts

    return train_step, eval_step


def shard_pipeline_state(state, mesh: Mesh, axis_name: str = PIPE_AXIS):
    """Place the state in place: the ``stages.*`` leaves (and their
    optimizer moments and EMA) split on their leading axis over
    ``axis_name``, everything else replicated. Returns the state."""
    from ..train.steps import place_state
    from .sharding import NamedSharding, P, replicated
    split = NamedSharding(mesh, P(axis_name))
    layout = {n: (split if n.startswith("stages.") else replicated(mesh))
              for n in state.params}
    return place_state(state, mesh, layout, layout)
