"""Preemption-safe shutdown: SIGTERM/SIGINT → flush → checkpoint → 75 —
the port of ``deeplearning_tpu/elastic/preempt.py``.

Card time is often preemptible: the scheduler sends SIGTERM and the
process has seconds to land its state. The guard turns that signal into
a three-phase graceful exit:

1. **In the handler** (async-signal time, main thread): record a flight
   event, run the registered ``flush`` callbacks — the checkpoint
   manager's ``flush()`` barrier lands any in-flight async write, the
   flight recorder dumps its ring — and set a flag. Nothing here starts
   new device work.
2. **At the next step boundary** the Trainer sees the flag and raises
   :class:`Preempted`, then saves a fresh checkpoint at the exact
   interrupted step and flushes it.
3. **The entrypoint** converts :class:`Preempted` into
   :data:`EXIT_PREEMPTED` (75, sysexits' EX_TEMPFAIL) so the supervisor
   requeues the run instead of counting a crash.

Signals subscribe through :mod:`.signals`, so the guard coexists with
the flight recorder's own SIGTERM hook — neither replaces the other.
``agree_preempt_step`` broadcasts rank 0's step over an initialised
``torch.distributed`` group of more than one rank (the JAX function's
``multihost_utils.broadcast_one_to_all``).
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Iterable, List, Optional

from ..obs import flight
from . import signals

__all__ = ["EXIT_PREEMPTED", "Preempted", "PreemptionGuard",
           "agree_preempt_step"]

# sysexits EX_TEMPFAIL: "transient failure, retry" — the supervisor's
# contract for "requeue me, this was a preemption, not a bug".
EXIT_PREEMPTED = 75


class Preempted(Exception):
    """Raised at a step boundary after a preemption signal. By the time
    the Trainer re-raises this, the final checkpoint is saved+flushed."""

    def __init__(self, message: str, *, signum: Optional[int] = None,
                 step: Optional[int] = None):
        super().__init__(message)
        self.signum = signum
        self.step = step


class PreemptionGuard:
    """Graceful-shutdown flag fed by chained SIGTERM/SIGINT handlers.

    ``install()`` subscribes (graceful — the process does NOT die in the
    handler); the hot loop polls ``requested()`` (one ``Event.is_set``)
    and raises :class:`Preempted` at the next boundary. ``add_flush``
    callbacks run inside the handler itself so an in-flight async
    checkpoint write commits even if the loop never reaches another
    boundary (e.g. preempted mid-eval)."""

    def __init__(self, signums: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signums = tuple(signums)
        self.signum: Optional[int] = None
        self._event = threading.Event()
        self._flush: List[Callable[[], None]] = []
        self._installed: List[int] = []

    def add_flush(self, fn: Callable[[], None]) -> "PreemptionGuard":
        self._flush.append(fn)
        return self

    def install(self) -> bool:
        """Subscribe on every signal; True if at least one took (False
        off the main thread — callers just lose signal-driven preemption,
        ``request()`` still works)."""
        for signum in self.signums:
            if signals.subscribe(signum, self._on_signal, graceful=True):
                self._installed.append(signum)
        return bool(self._installed)

    def uninstall(self) -> None:
        for signum in self._installed:
            signals.unsubscribe(signum, self._on_signal)
        self._installed = []

    def _on_signal(self, signum: int, frame) -> None:
        if self._event.is_set():
            return                       # double-delivery: already landing
        self.signum = signum
        flight.record("preempt_signal", signum=int(signum))
        for fn in self._flush:
            try:
                fn()
            except Exception:  # noqa: BLE001 - a failed flush must not
                pass           # stop the remaining landing steps
        self._event.set()

    def request(self) -> None:
        """Programmatic preemption (tests, managed-runtime callbacks)."""
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()


def agree_preempt_step(step: int) -> int:
    """Multi-process preemption agreement: rank 0 broadcasts ITS step so
    every process lands the same checkpoint step (a job-wide SIGTERM
    reaches processes at slightly different step boundaries). Identity
    when no ``torch.distributed`` group is initialised or it has one
    rank, and a best-effort identity if the collective itself fails (a
    dying job should still land SOME checkpoint)."""
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return int(step)
    try:
        # NCCL moves only card tensors; gloo takes host ones
        device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        agreed = torch.tensor([int(step)], dtype=torch.int64, device=device)
        dist.broadcast(agreed, src=0)
        return int(agreed.item())
    except Exception:  # noqa: BLE001 - never block the landing on it
        return int(step)
