"""TrainState — the port of ``deeplearning_tpu/train/state.py``.

The step count, the model (whose parameters are the params), the
optimizer and its state, BN statistics and an optional EMA shadow of the
params, in one object. JAX's state is an immutable pytree that each step
replaces; the port updates the parameters, the optimizer state and the
EMA in place (no second copy of 86M parameters per step) and
``apply_gradients`` returns the same object.

``step`` is a host integer: the schedules and Adam's bias correction read
it on the host, so a step never waits for the card. ``state_dict()`` /
``load_state_dict()`` are what ``core.checkpoint`` saves and restores.

A state placed on a mesh (``train.steps.shard_state``) keeps each
sharded leaf as this rank's slice and its layout in ``sharding``
(``parallel.sharding.StateSharding``): ``apply_gradients`` then takes
gradients in the moments' layout, updates the slices and all-gathers
what the params' layout needs; ``state_dict()`` all-gathers every leaf to
its global value (every rank must call it) and ``load_state_dict()``
cuts global values back to this rank's slices.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .optim import GradientTransformation, apply_updates, global_norm_over

__all__ = ["TrainState"]


class TrainState:
    def __init__(self, *, model: nn.Module, tx: GradientTransformation,
                 opt_state: Any, step: int = 0,
                 batch_stats: Optional[Dict[str, torch.Tensor]] = None,
                 ema_params: Optional[Dict[str, torch.Tensor]] = None,
                 ema_decay: float = 0.9998):
        self.model = model
        self.tx = tx
        self.opt_state = opt_state
        self.step = step
        self.batch_stats = batch_stats if batch_stats is not None else {}
        self.ema_params = ema_params
        self.ema_decay = ema_decay
        self.sharding = None     # a StateSharding once placed on a mesh

    @classmethod
    def create(cls, *, model: nn.Module, tx: GradientTransformation,
               batch_stats: Optional[Dict[str, torch.Tensor]] = None,
               use_ema: bool = False,
               ema_decay: float = 0.9998) -> "TrainState":
        params = dict(model.named_parameters())
        ema = ({n: p.detach().clone() for n, p in params.items()}
               if use_ema else None)
        return cls(model=model, tx=tx, opt_state=tx.init(params),
                   batch_stats=batch_stats, ema_params=ema,
                   ema_decay=ema_decay)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        return self.ema_params if self.ema_params is not None else self.params

    def apply_fn(self, params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                 train: bool = False,
                 rng: Optional[torch.Generator] = None) -> Any:
        """The model on ``params`` (JAX's ``apply_fn(variables, x, train=,
        rngs=)``): train mode draws its masks from ``rng``."""
        self.model.train(train)
        return torch.func.functional_call(self.model, params, (x,),
                                          {"rng": rng})

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        new_batch_stats: Optional[Dict] = None
                        ) -> "TrainState":
        """One optimizer update in place; the EMA (if on) follows with
        d = decay * (1 - exp(-(step + 1) / 2000)) on the step before the
        increment (the YOLOX warmup EMA)."""
        params = self.params
        sh = self.sharding
        views = params if sh is None else sh.update_views(params)
        norm = (global_norm_over(sh.global_norm)
                if sh is not None and sh.any_sharded
                else contextlib.nullcontext())
        with norm:
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     views)
        apply_updates(views, updates)
        if sh is not None:
            sh.complete_update(params, views)
        if self.ema_params is not None:
            d = self.ema_decay * (1.0 - math.exp(-(self.step + 1) / 2000.0))
            names = list(self.ema_params)
            with torch.no_grad():
                ema = [self.ema_params[n] for n in names]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[n].detach().to(self.ema_params[n].dtype)
                     for n in names], 1 - d))
        if new_batch_stats is not None:
            self.batch_stats = new_batch_stats
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the params, the model's
        buffers (BN statistics: ``batch_stats`` are those buffers), the
        optimizer state and the EMA. Tensors are the live ones; saving
        copies them."""
        tree = {"step": self.step,
                "params": {n: p.detach() for n, p in self.params.items()},
                "buffers": dict(self.model.named_buffers()),
                "opt_state": self.opt_state,
                "ema_params": self.ema_params}
        return tree if self.sharding is None else \
            self.sharding.gather_tree(tree)

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Restore a ``state_dict()`` in place: params, buffers and EMA
        are copied into the live tensors (bit for bit), the optimizer
        state is moved to the params' device."""
        if (self.ema_params is None) != (tree["ema_params"] is None):
            raise ValueError("the checkpoint and the state disagree on EMA")
        if self.sharding is not None:
            tree = self.sharding.slice_tree(tree)
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(tree["params"][name])
            for name, b in self.model.named_buffers():
                b.copy_(tree["buffers"][name])
            if self.ema_params is not None:
                for name, e in self.ema_params.items():
                    e.copy_(tree["ema_params"][name])
        dev = next(iter(self.params.values())).device
        self.opt_state = _to(tree["opt_state"], dev)
        self.step = int(tree["step"])
        if self.batch_stats:
            self.batch_stats = dict(self.model.named_buffers())


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree
