"""Runtime strict mode: the card's own sanitizers scoped to the hot loops
— the port of ``deeplearning_tpu/analysis/strict.py``.

``Trainer(strict="transfers")`` (or ``DLTPU_STRICT=1`` in the
environment) wraps every hot-loop step region in
``torch.cuda.set_sync_debug_mode("error")``: a call that makes the host
wait for the card (``.item()``, ``float()`` of a card tensor, a blocking
copy, ``torch.cuda.synchronize``) raises at the offending line instead
of silently stalling the queue. ``strict="nans"`` arms, for the whole
run, forward hooks that raise ``FloatingPointError`` at the first
module whose output holds a NaN and gradient hooks that raise at the
first module whose output's gradient holds one, naming the module (JAX's
``jax_debug_nans`` raises at the emitting primitive), with autograd's
anomaly mode recording each op's trace; ``debug_nans()`` without a model
is anomaly mode with ``check_nan``.

Differences from the JAX module, by decision:
- ``threads`` (the runtime thread sanitizer, ``analysis/threadsan.py``)
  comes with ROADMAP Queue 1 item 8c: asking for it raises ``ValueError``
  naming the item, and so does a bare ``"all"``, which arms it too.
- The sync debug mode is one switch for the process, not one a kind: the
  ``kind`` of ``no_transfers`` is checked and every kind arms it. It has
  no teeth on the CPU, where there is no card to wait for (the JAX
  caveat about the zero-copy CPU backend): ``guard_enforced()`` is False
  there and True on the card.
- The switch is process-wide, not per thread: while it is armed the
  feed and checkpoint threads poll their events and never synchronise,
  and the NaN hooks lift it around their own checks (``unguarded``).
  Anomaly mode's ``check_nan`` synchronises inside the backward, where
  nothing can lift the guard, so under a model the gradient hooks check
  instead (``check_nan=False``).
"""

from __future__ import annotations

import contextlib
import os
from typing import FrozenSet, Iterator, Optional, Union

import torch

__all__ = [
    "MODES", "resolve", "no_host_transfers", "no_transfers",
    "debug_nans", "strict_section", "guard_enforced", "unguarded",
]

MODES = ("transfers", "nans", "threads")

# what a bare opt-in ("1", "true", "on") arms
_DEFAULT_MODES = frozenset({"transfers"})
_KINDS = ("device_to_host", "host_to_device", "all")
_LATER = {"threads": "ROADMAP Queue 1 item 8c (the thread sanitizer, "
                     "analysis/threadsan.py)"}


def resolve(value: Union[str, bool, None] = None,
            env: str = "DLTPU_STRICT") -> FrozenSet[str]:
    """Normalize a strict spec into the set of armed modes.

    ``value`` wins when given (``True``/``"1"`` → transfers;
    ``"transfers,nans"`` → both; ``False``/``""``/``"0"`` → none);
    otherwise the ``DLTPU_STRICT`` env var is consulted. ``"threads"``
    and ``"all"`` (which includes it) raise ``ValueError`` naming the
    ROADMAP item that brings the thread sanitizer.
    """
    if value is None:
        value = os.environ.get(env, "")
    if isinstance(value, bool):
        return _DEFAULT_MODES if value else frozenset()
    value = str(value).strip().lower()
    if value in ("", "0", "false", "off", "none"):
        return frozenset()
    if value in ("1", "true", "on"):
        return _DEFAULT_MODES
    if value == "all":
        modes = frozenset(MODES)
    else:
        modes = frozenset(m.strip() for m in value.split(",") if m.strip())
    unknown = modes - frozenset(MODES)
    if unknown:
        raise ValueError(
            f"unknown strict mode(s) {sorted(unknown)}; "
            f"valid: {MODES}, '1'/'all', or ''")
    for mode in sorted(modes & set(_LATER)):
        raise ValueError(f"strict mode {mode!r} comes with {_LATER[mode]}")
    return modes


def _card() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _sync_debug_mode(mode) -> Iterator[None]:
    """Set the sync debug mode for the block and restore the previous one
    on exit; a no-op without a card."""
    if not _card():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def unguarded() -> "contextlib.AbstractContextManager[None]":
    """Lift the sync guard for a block that synchronises by design (the
    NaN hook's check, a lagged metrics fetch) and restore it after."""
    return _sync_debug_mode(0)


def no_transfers(kind: str = "device_to_host"
                 ) -> "contextlib.AbstractContextManager[None]":
    """Disallow synchronising transfers inside the block.
    ``kind`` ∈ {"device_to_host", "host_to_device", "all"}: torch has one
    switch for every kind (any synchronising call raises)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown transfer kind {kind!r}")
    return _sync_debug_mode("error")


def no_host_transfers() -> "contextlib.AbstractContextManager[None]":
    """The hot-loop guard: any card→host materialization inside the block
    (``.item()``, ``float()``, ``.cpu()``, ``.tolist()``, printing)
    raises instead of silently stalling the queue."""
    return no_transfers("device_to_host")


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


def _has_nan(tensors) -> bool:
    """One host check of every tensor; it waits for the card, so the
    sync guard is lifted around it."""
    with unguarded():
        return any(bool(torch.isnan(t).any()) for t in tensors)


@contextlib.contextmanager
def debug_nans(enable: bool = True,
               model: Optional[torch.nn.Module] = None) -> Iterator[None]:
    """Arm NaN detection inside the block (restored on exit).

    With ``model``: a forward hook on every module raises
    ``FloatingPointError`` at the first one whose output holds a NaN, and
    a gradient hook on each such output raises at the first module whose
    output's gradient holds one (the backward walks the modules from the
    loss down), naming the module; anomaly mode records each forward op's
    trace for errors raised in the backward. The hooks' checks wait for
    the card, so each lifts the sync guard around itself.
    Without a model: anomaly mode with ``check_nan`` (a backward function
    that returns a NaN raises ``RuntimeError`` naming it). That engine
    check also waits for the card, inside the backward where no guard can
    be lifted, so a model's run takes the hooks instead. Expensive either
    way: opt-in via ``strict='nans'`` only."""
    if not enable:
        yield
        return
    if model is None:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
        return
    names = {m: n or type(model).__name__
             for n, m in model.named_modules()}

    def grad_hook(name):
        def check(grad):
            if _has_nan([grad]):
                raise FloatingPointError(
                    f"NaN in the gradient of the output of module {name}")
        return check

    def hook(module, args, out):
        tensors = _tensors(out)
        name = f"{names[module]!r} ({type(module).__name__})"
        if _has_nan(tensors):
            raise FloatingPointError(f"NaN in the output of module {name}")
        for t in tensors:
            if t.requires_grad:
                t.register_hook(grad_hook(name))
    handles = [m.register_forward_hook(hook) for m in names]
    try:
        with torch.autograd.detect_anomaly(check_nan=False):
            yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def strict_section(modes: FrozenSet[str]) -> Iterator[None]:
    """The per-step guard region the Trainer wraps around its hot loop.
    Only the transfer guard applies per section (``debug_nans`` is armed
    run-wide by the Trainer)."""
    if "transfers" in modes:
        with no_host_transfers():
            yield
    else:
        yield


def guard_enforced(kind: str = "device_to_host",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> bool:
    """Does a disallowed ``kind`` transfer raise here? False for a CPU
    device (nothing to wait for), True on the card: the probe tries a
    real card→host fetch (``kind="host_to_device"``: a blocking copy from
    pageable memory) under the guard."""
    if kind not in _KINDS:
        raise ValueError(f"unknown transfer kind {kind!r}")
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if _card() else torch.device("cpu"))
    if dev.type != "cuda":
        return False
    x = torch.arange(4, device=dev)
    try:
        with no_transfers(kind):
            if kind == "host_to_device":
                x.copy_(torch.arange(4))
            else:
                float(x[0])
        return False
    except RuntimeError:
        return True
