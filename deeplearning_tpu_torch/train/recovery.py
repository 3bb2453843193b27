"""Divergence rollback-and-skip: a loss spike is a detour, not a death —
the port of ``deeplearning_tpu/train/recovery.py``.

Large-batch training on real data diverges occasionally — a pathological
batch, an optimizer overflow, a bit flip in device memory. Aborting on
the first non-finite loss wastes everything since the last checkpoint on
disk. This module implements the cheaper policy:

1. keep a device-side **anchor** copy of the ``TrainState``'s tensors
   (parameters, buffers, optimizer state, EMA), refreshed every
   ``anchor_every`` steps — one clone a tensor, queued on the loop's
   stream, no host fetch, no disk;
2. when divergence fires, **roll back** to the anchor, **skip** the data
   window that produced it (the loader is re-seeded, so the replayed span
   draws another permutation), and **dampen** updates for a cooldown
   window;
3. give up — the abort path, with full flight telemetry — only after
   ``max_recoveries`` rollbacks inside ``budget_steps``.

Anchor correctness under lagged metrics: the Trainer learns about a
divergence ``metrics_lag`` steps late, so an anchor snapshotted at step t
is only *promoted* once a verified-finite metrics entry for a step
``> t`` arrives — entry t+1's loss was computed FROM state t, so a finite
entry at t+1 proves the state at t was clean. Until promotion a snapshot
waits in a small pending queue; a rollback clears it.

In-place safety: the port's step updates the parameters and moments in
place, so ``snapshot_state`` is queued BEFORE the step, on the same
stream: the clone reads the tensors before the step writes them. A
snapshot is a tree of tensors (``TrainState.state_dict()``'s layout);
``TrainState.load_state_dict`` copies one back into the live tensors.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

__all__ = ["RecoveryPolicy", "RecoveryManager", "RecoveryExhausted",
           "snapshot_state", "damp_update", "poison_state"]


class RecoveryExhausted(RuntimeError):
    """Rollback budget spent (or no anchor exists): the run is genuinely
    sick — fall through to the abort path."""


class RecoveryPolicy:
    """Knobs for divergence recovery. ``budget_steps=0`` means the
    ``max_recoveries`` budget spans the whole run; otherwise only
    rollbacks within the trailing ``budget_steps`` window count — a
    2M-step run is allowed one bad day per epoch, not three ever."""

    def __init__(self, *, mode: str = "rollback", anchor_every: int = 50,
                 max_recoveries: int = 3, budget_steps: int = 0,
                 cooldown_steps: int = 20, lr_decay: float = 0.1):
        if mode not in ("rollback", "abort"):
            raise ValueError(f"mode must be rollback|abort, got {mode!r}")
        self.mode = mode
        self.anchor_every = max(int(anchor_every), 1)
        self.max_recoveries = int(max_recoveries)
        self.budget_steps = int(budget_steps)
        self.cooldown_steps = max(int(cooldown_steps), 0)
        self.lr_decay = float(lr_decay)


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def snapshot_state(state: Any) -> Any:
    """Device-side deep copy of a ``TrainState`` (its ``state_dict()``:
    step, params, buffers, optimizer state, EMA) or of a tree of tensors.
    Queue it BEFORE the in-place step: the copy reads the tensors the
    step will overwrite."""
    tree = state.state_dict() if hasattr(state, "state_dict") else state
    return _clone(tree)


def damp_update(old_params: Dict[str, torch.Tensor],
                new_params: Dict[str, torch.Tensor],
                scale: float) -> Dict[str, torch.Tensor]:
    """``old + scale * (new - old)`` leaf-wise: shrink one step's param
    delta by ``scale``. Exactly an LR decay for SGD; the standard
    post-rollback damping for adaptive optimizers (whose moments keep
    their own schedule). Returns new tensors; the Trainer copies them into
    the live parameters."""
    names = list(old_params)
    old = [old_params[n].detach() for n in names]
    new = [new_params[n].detach() for n in names]
    with torch.no_grad():
        delta = torch._foreach_sub(new, old)
        torch._foreach_mul_(delta, float(scale))
        out = torch._foreach_add(old, delta)
    return dict(zip(names, out))


def poison_state(state: Any) -> Any:
    """NaN-poison the float params in place (the ``nan`` fault's
    effect): the next step computes a NaN loss through the REAL
    ``bad_step`` flag, so injection exercises detection end to end."""
    with torch.no_grad():
        for p in state.params.values():
            if p.is_floating_point():
                p.mul_(float("nan"))
    return state


class RecoveryManager:
    """Owns the anchor lifecycle and the rollback budget. Not
    thread-safe — everything runs on the Trainer's consumer thread."""

    def __init__(self, policy: Optional[RecoveryPolicy] = None):
        self.policy = policy or RecoveryPolicy()
        self._anchor: Optional[Tuple[int, Any]] = None
        # snapshots awaiting a verified-finite entry newer than them
        self._pending: Deque[Tuple[int, Any]] = collections.deque(maxlen=8)
        self._last_snap_step: Optional[int] = None
        self._cooldown_until = -1
        self.rollbacks = 0
        self.recovery_steps: List[int] = []        # budget accounting
        self.skipped: List[Tuple[int, int]] = []   # (anchor, bad) windows

    # ------------------------------------------------------------ anchor
    def seed(self, step: int, state: Any) -> None:
        """Anchor the known-clean starting state (fresh init or a
        just-restored checkpoint)."""
        self._anchor = (int(step), snapshot_state(state))
        self._pending.clear()
        self._last_snap_step = int(step)

    def maybe_snapshot(self, step: int, state: Any) -> None:
        """Hot-loop hook: one int compare when idle; every
        ``anchor_every`` steps, dispatch a device-side copy into the
        pending queue. Call BEFORE the in-place step is queued."""
        step = int(step)
        if step - (self._last_snap_step or 0) < self.policy.anchor_every:
            return
        self._last_snap_step = step
        self._pending.append((step, snapshot_state(state)))

    def mark_verified(self, step: int) -> None:
        """A metrics entry at ``step`` arrived finite: promote every
        pending snapshot strictly older than it (entry t+1's loss was
        computed from state t, so finiteness at t+1 vouches for t)."""
        step = int(step)
        promoted = None
        while self._pending and self._pending[0][0] < step:
            promoted = self._pending.popleft()
        if promoted is not None:
            self._anchor = promoted

    @property
    def anchor_step(self) -> Optional[int]:
        return self._anchor[0] if self._anchor is not None else None

    # --------------------------------------------------------- rollback
    def on_divergence(self, step: int) -> Tuple[int, Any]:
        """Account one divergence at host step ``step``; return
        ``(anchor_step, anchor_state)`` to roll back to, or raise
        :class:`RecoveryExhausted` when the budget is spent. The anchor
        itself is returned: ``TrainState.load_state_dict`` copies it into
        the live tensors, and the optimizer makes new moment tensors each
        step, so the anchor stays untouched and a second divergence in the
        same window can roll back to it again."""
        step = int(step)
        if self.policy.budget_steps > 0:
            floor = step - self.policy.budget_steps
            self.recovery_steps = [s for s in self.recovery_steps
                                   if s >= floor]
        if self._anchor is None:
            raise RecoveryExhausted(
                f"divergence at step {step} with no verified anchor")
        if len(self.recovery_steps) >= self.policy.max_recoveries:
            raise RecoveryExhausted(
                f"divergence at step {step}: {len(self.recovery_steps)} "
                f"rollbacks already spent (max {self.policy.max_recoveries}"
                + (f" per {self.policy.budget_steps} steps"
                   if self.policy.budget_steps else "") + ")")
        self.recovery_steps.append(step)
        self.rollbacks += 1
        anchor_step, anchor_state = self._anchor
        self.skipped.append((anchor_step, step))
        # in-flight snapshots may postdate the poison — drop them, and
        # restart the snapshot cadence from the anchor
        self._pending.clear()
        self._last_snap_step = anchor_step
        self._cooldown_until = anchor_step + self.policy.cooldown_steps
        return anchor_step, anchor_state

    def cooldown_scale(self, step: int) -> Optional[float]:
        """``lr_decay`` while inside the post-rollback cooldown window,
        else None (one int compare on the hot path)."""
        if int(step) < self._cooldown_until:
            return self.policy.lr_decay
        return None

    def stats(self) -> dict:
        return {
            "rollbacks": self.rollbacks,
            "rollback_steps": list(self.recovery_steps),
            "skipped_windows": [list(w) for w in self.skipped],
            "anchor_step": self.anchor_step,
            "anchor_every": self.policy.anchor_every,
            "max_recoveries": self.policy.max_recoveries,
        }
