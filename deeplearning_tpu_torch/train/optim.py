"""Optimizers with parameter masks — the port of
``deeplearning_tpu/train/optim.py``.

The JAX package builds its optimizers as optax chains; the port keeps
that shape with a small functional equivalent: a
``GradientTransformation`` is an ``(init, update)`` pair over dicts of
tensors keyed by parameter name (``dict(model.named_parameters())``), and
the chains, their order and their state layout are optax's. So the port
updates a parameter as optax does, to float32 rounding, and an optax
state converts one to one (``utils/convert.from_optax_state``). States are
dicts named after optax's fields (``count``, ``mu``, ``nu``, ``trace``,
``inner_state``; ``{}`` for an empty state) inside tuples for chains.

Updates run under ``torch.no_grad`` with ``torch._foreach_*`` ops (a few
multi-tensor launches per transform, no host sync: counts are host
integers and learning rates host floats). ``lars`` (MAE pretraining)
comes with the slice that trains MAE.

Masks are judged on the flax path of each parameter
(``utils/convert.flax_path``: ``blocks.0.attn.qkv.weight`` ->
``blocks_0/attn/qkv/kernel``), so the port decays and freezes exactly the
leaves the JAX package does.
"""

from __future__ import annotations

import contextlib
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..core.registry import OPTIMIZERS
from ..utils.convert import flax_path

__all__ = ["GradientTransformation", "chain", "scale_by_adam",
           "add_decayed_weights", "masked", "set_to_zero", "trace",
           "scale_by_learning_rate", "clip_by_global_norm",
           "global_norm_over",
           "NO_DECAY_PATTERNS", "decay_mask", "freeze_mask", "sgd", "adam",
           "adamw", "build_optimizer", "apply_updates"]

Tree = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]

NO_DECAY_PATTERNS = ("bias", "scale", "norm", "bn", "pos_embed", "cls_token",
                     "relative_position_bias", "absolute_pos_embed",
                     "logit_scale")


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]


def _lists(tree: Tree, names) -> list:
    return [tree[n] for n in names]


def _zeros(params: Tree) -> Tree:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: bias-corrected first and second moments."""
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def update(updates, state, params=None):
        names = list(updates)
        g = _lists(updates, names)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(_lists(state["mu"], names),
                                                   b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2),
                                torch._foreach_mul(_lists(state["nu"], names),
                                                   b2))
        count = state["count"] + 1
        # the bias corrections in float32, as optax computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_add(
            torch._foreach_div(nu, c2), eps_root))
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        return (dict(zip(names, out)),
                {"count": count, "mu": dict(zip(names, mu)),
                 "nu": dict(zip(names, nu))})
    return GradientTransformation(init, update)


def masked(inner: GradientTransformation,
           mask: Dict[str, bool]) -> GradientTransformation:
    """optax.masked: ``inner`` sees only the leaves where ``mask`` is
    True; the others pass through unchanged."""
    def pick(tree):
        return {n: x for n, x in tree.items() if mask[n]}

    def init(params):
        return {"inner_state": inner.init(pick(params))}

    def update(updates, state, params=None):
        sub, inner_state = inner.update(
            pick(updates), state["inner_state"],
            None if params is None else pick(params))
        return {**updates, **sub}, {"inner_state": inner_state}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Dict[str, bool]] = None
                        ) -> GradientTransformation:
    """optax.add_decayed_weights: update + weight_decay * param."""
    def init(params):
        return {}

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        names = list(updates)
        out = torch._foreach_add(
            _lists(updates, names),
            torch._foreach_mul(_lists(params, names), weight_decay))
        return dict(zip(names, out)), state
    tx = GradientTransformation(init, update)
    return masked(tx, mask) if mask is not None else tx


def set_to_zero() -> GradientTransformation:
    def update(updates, state, params=None):
        return {n: torch.zeros_like(u) for n, u in updates.items()}, state
    return GradientTransformation(lambda params: {}, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace (SGD momentum): t = g + decay * t."""
    def init(params):
        return {"trace": _zeros(params)}

    @torch.no_grad()
    def update(updates, state, params=None):
        names = list(updates)
        g = _lists(updates, names)
        new = torch._foreach_add(
            g, torch._foreach_mul(_lists(state["trace"], names), decay))
        out = (torch._foreach_add(g, torch._foreach_mul(new, decay))
               if nesterov else new)
        return dict(zip(names, out)), {"trace": dict(zip(names, new))}
    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: Schedule) -> GradientTransformation:
    """update * -lr; a schedule is read at the count before the increment
    (update t uses schedule(t)), as optax does."""
    if not callable(learning_rate):
        def init_const(params):
            return {}

        @torch.no_grad()
        def update_const(updates, state, params=None):
            names = list(updates)
            out = torch._foreach_mul(_lists(updates, names),
                                     -float(learning_rate))
            return dict(zip(names, out)), state
        return GradientTransformation(init_const, update_const)

    def init(params):
        return {"count": 0}

    @torch.no_grad()
    def update(updates, state, params=None):
        names = list(updates)
        step = -float(np.float32(learning_rate(state["count"])))
        out = torch._foreach_mul(_lists(updates, names), step)
        return dict(zip(names, out)), {"count": state["count"] + 1}
    return GradientTransformation(init, update)


# the norm of the whole gradient when each rank holds slices of it: a
# sharded train state sets it around its update (``global_norm_over``)
_GLOBAL_NORM: Optional[Callable[[Tree], torch.Tensor]] = None


@contextlib.contextmanager
def global_norm_over(fn: Callable[[Tree], torch.Tensor]):
    """Inside the block, ``clip_by_global_norm`` takes its norm from
    ``fn(updates)`` (a sharded state's ``StateSharding.global_norm``, which
    sums the slices' squares over the ranks) instead of the local
    leaves."""
    global _GLOBAL_NORM
    was, _GLOBAL_NORM = _GLOBAL_NORM, fn
    try:
        yield
    finally:
        _GLOBAL_NORM = was


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: g * max_norm / ||g|| only where
    ||g|| >= max_norm (the device-side comparison; no host sync)."""
    @torch.no_grad()
    def update(updates, state, params=None):
        names = list(updates)
        g = _lists(updates, names)
        norm = (torch.sqrt(sum(torch.sum(x * x) for x in g))
                if _GLOBAL_NORM is None else _GLOBAL_NORM(updates))
        keep = norm < max_norm
        clipped = torch._foreach_mul(torch._foreach_div(g, norm), max_norm)
        out = [torch.where(keep, x, c) for x, c in zip(g, clipped)]
        return dict(zip(names, out)), state
    return GradientTransformation(lambda params: {}, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """optax.apply_updates, in place: param += update."""
    names = list(updates)
    torch._foreach_add_(_lists(params, names), _lists(updates, names))


# ------------------------------------------------------------------ masks
def decay_mask(params: Tree,
               no_decay: Sequence[str] = NO_DECAY_PATTERNS
               ) -> Dict[str, bool]:
    """True where weight decay applies: 2D+ kernels whose flax path
    matches none of ``no_decay`` (biases and norm scales never decay)."""
    def keep(name, leaf):
        path = flax_path(name, leaf.ndim).lower()
        return leaf.ndim >= 2 and not any(p in path for p in no_decay)
    return {n: keep(n, p) for n, p in params.items()}


def freeze_mask(params: Tree, frozen: Sequence[str]) -> Dict[str, bool]:
    """True where the flax path matches a frozen pattern. Patterns match
    whole '/'-separated components (possibly several, e.g.
    "backbone/conv1"), so ("blocks_1",) does not also catch blocks_10."""
    pats = [f"/{p.lower().strip('/')}/" for p in frozen]

    def match(name, leaf):
        padded = f"/{flax_path(name, leaf.ndim).lower()}/"
        return any(p in padded for p in pats)
    return {n: match(n, p) for n, p in params.items()}


# ------------------------------------------------------------- optimizers
def _optax_sgd(schedule, momentum, nesterov):
    head = (trace(momentum, nesterov) if momentum is not None
            else GradientTransformation(lambda params: {},
                                        lambda u, s, p=None: (u, s)))
    return chain(head, scale_by_learning_rate(schedule))


@OPTIMIZERS.register("sgd")
def sgd(schedule, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0, params: Optional[Tree] = None, **_):
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(
            weight_decay, decay_mask(params) if params is not None else None))
    parts.append(_optax_sgd(schedule, momentum, nesterov))
    return chain(*parts)


@OPTIMIZERS.register("adam")
def adam(schedule, b1: float = 0.9, b2: float = 0.999, **_):
    return chain(scale_by_adam(b1, b2), scale_by_learning_rate(schedule))


@OPTIMIZERS.register("adamw")
def adamw(schedule, b1: float = 0.9, b2: float = 0.999,
          weight_decay: float = 0.05, eps: float = 1e-8,
          params: Optional[Tree] = None, **_):
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay,
                                     decay_mask(params)
                                     if params is not None else None),
                 scale_by_learning_rate(schedule))


def build_optimizer(name: str, schedule: Schedule,
                    clip_grad_norm: Optional[float] = None,
                    params: Optional[Tree] = None,
                    freeze: Optional[Sequence[str]] = None,
                    **kwargs) -> GradientTransformation:
    """Optimizer chain with optional global-norm clipping in front and
    optional freezing: frozen gradients are zeroed BEFORE the clip (they
    must not shrink everyone else's clip budget) and the final updates
    AFTER the optimizer (decoupled weight decay would still move them)."""
    if name == "lars":
        raise NotImplementedError(
            "lars comes with the MAE training slice (ROADMAP Queue 1)")
    tx = OPTIMIZERS.build(name, schedule, params=params, **kwargs)
    if clip_grad_norm and clip_grad_norm > 0:
        tx = chain(clip_by_global_norm(clip_grad_norm), tx)
    if freeze:
        if params is None:
            raise ValueError("freeze patterns require params to build the mask")
        mask = freeze_mask(params, freeze)
        tx = chain(masked(set_to_zero(), mask), tx,
                   masked(set_to_zero(), mask))
    return tx
