"""Chained signal subscriptions: one process, many SIGTERM subscribers —
a copy of ``deeplearning_tpu/elastic/signals.py``.

Two subsystems want the same signals — the obs flight recorder dumps its
ring on SIGTERM, and the elastic preemption guard turns SIGTERM/SIGINT
into a graceful checkpoint-and-requeue. Python gives a process exactly
one handler per signal, so whoever installs second silently disconnects
whoever installed first. This registry owns the real handler and fans
the signal out to every subscriber, then falls through to whatever
handler was installed *before* the registry took the signal over — the
chain is never silently broken.

A subscriber registered with ``graceful=True`` declares that it owns
shutdown (the preemption guard: "I set a flag; the train loop will
checkpoint and exit at the next step boundary"). When any graceful
subscriber is present the dispatcher does NOT terminate the process;
without one, the pre-registry handler (or the OS default) runs, so a
process with only the flight-recorder subscriber still dies on SIGTERM
exactly as before.

Everything here is stdlib-only: a supervisor process imports it without
touching torch.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, Dict, List, Tuple

__all__ = ["subscribe", "unsubscribe", "subscribers", "installed"]

Handler = Callable[[int, object], None]

_LOCK = threading.Lock()
_SUBSCRIBERS: Dict[int, List[Tuple[Handler, bool]]] = {}
_PREVIOUS: Dict[int, object] = {}      # handler the registry replaced


def subscribe(signum: int, fn: Handler, *, graceful: bool = False) -> bool:
    """Register ``fn(signum, frame)`` to run when ``signum`` arrives.

    Installs the registry's dispatcher on first use for that signal
    (main thread only — returns False elsewhere, signal.signal's rule).
    ``graceful=True`` marks ``fn`` as owning shutdown: while it is
    subscribed, the dispatcher returns after the fan-out instead of
    chaining into the terminating default."""
    with _LOCK:
        if signum not in _PREVIOUS:
            if threading.current_thread() is not threading.main_thread():
                return False
            try:
                previous = signal.getsignal(signum)
                signal.signal(signum, _dispatch)
            except (ValueError, OSError):   # exotic runtime / bad signum
                return False
            _PREVIOUS[signum] = previous
        _SUBSCRIBERS.setdefault(signum, []).append((fn, graceful))
    return True


def unsubscribe(signum: int, fn: Handler) -> None:
    """Remove every subscription of ``fn``. The dispatcher stays
    installed (removing it races with delivery); with zero subscribers
    it degenerates to the pre-registry behavior."""
    with _LOCK:
        subs = _SUBSCRIBERS.get(signum, [])
        # equality, not identity: ``obj.method`` builds a fresh bound
        # method on every access, so an identity check would never match
        _SUBSCRIBERS[signum] = [(f, g) for f, g in subs if f != fn]


def subscribers(signum: int) -> List[Tuple[Handler, bool]]:
    with _LOCK:
        return list(_SUBSCRIBERS.get(signum, []))


def installed(signum: int) -> bool:
    with _LOCK:
        return signum in _PREVIOUS


def _dispatch(signum: int, frame) -> None:
    """The one real handler: run every subscriber (a failing subscriber
    never starves the rest), then either yield to a graceful owner or
    chain the pre-registry handler / OS default."""
    with _LOCK:
        subs = list(_SUBSCRIBERS.get(signum, []))
        previous = _PREVIOUS.get(signum)
    graceful = False
    for fn, g in subs:
        try:
            fn(signum, frame)
        except Exception:  # noqa: BLE001 - handlers must not cascade
            pass  # dltpu: allow(DLT104) a failing subscriber must not starve the rest
        graceful = graceful or g
    if graceful:
        return                        # the owner exits at a safe boundary
    if previous in (signal.SIG_IGN, None):
        return
    if callable(previous):            # e.g. pytest/KeyboardInterrupt hook
        previous(signum, frame)
        return
    # SIG_DFL: re-deliver with the default disposition (terminates)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)
