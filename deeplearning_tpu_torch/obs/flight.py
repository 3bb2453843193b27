"""Crash flight recorder: last-K structured events + config, dumped on
request or when something goes wrong.

A diverged or preempted run previously left nothing to autopsy — the
metrics ring dies with the process and the log file stops mid-line. The
recorder keeps a bounded in-memory ring of recent structured events
(step metric snapshots, feed stats, retrace warnings, compile events,
serve rejections — anything a layer ``record()``s) and serializes it to
``runs/<dir>/flightrec.json`` together with the run config, a CUDA
memory snapshot, and the exception, the moment something goes wrong.

Recording is always-on and cheap (bounded ``deque.append`` under a
lock; no device syncs, no I/O); DUMPING requires a path — either
``configure(path, config)`` (the Trainer does this per run) or an
explicit ``dump(path=...)``. The default process-wide recorder is what
the convenience ``record(kind, **data)`` feeds, so layers don't need a
handle threaded through them.

``install_signal_handler`` dumps the ring on SIGTERM through the
``elastic/signals.py`` registry, so it coexists with the preemption
guard; with a graceful owner subscribed the handler only marks the dump
pending and the Trainer writes it at its next step boundary
(``flush_pending``).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "get_recorder", "record", "configure",
           "dump", "memory_snapshot", "install_signal_handler",
           "flush_pending"]


def _jsonable(obj: Any, depth: int = 0) -> Any:
    """Best-effort JSON projection: configs arrive as dataclass-dicts,
    numpy scalars, tensors — serialize what we can, stringify the
    rest (a flight record must never fail to write)."""
    if depth > 6:
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else repr(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v, depth + 1) for v in obj]
    if hasattr(obj, "item"):           # numpy / torch scalars
        try:
            return _jsonable(obj.item(), depth + 1)
        except Exception:  # noqa: BLE001
            pass
    if hasattr(obj, "__dataclass_fields__"):
        import dataclasses
        try:
            return _jsonable(dataclasses.asdict(obj), depth + 1)
        except Exception:  # noqa: BLE001
            pass
    return repr(obj)


class FlightRecorder:
    """Bounded ring of recent events with a one-shot crash dump."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.path: Optional[str] = None
        self.config: Optional[Dict[str, Any]] = None
        self.dumps = 0
        self.recorded = 0

    # ------------------------------------------------------- recording
    def record(self, kind: str, **data: Any) -> None:
        event = {"kind": kind, "time": time.time(),
                 "thread": threading.current_thread().name, **data}
        with self._lock:
            self.recorded += 1
            self._ring.append(event)

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            ring = list(self._ring)
        return ring if kind is None else [e for e in ring
                                          if e["kind"] == kind]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0

    # --------------------------------------------------------- dumping
    def configure(self, path: str,
                  config: Optional[Any] = None) -> "FlightRecorder":
        """Arm the recorder: where to dump and what run config to embed
        (any object; serialized best-effort)."""
        self.path = path
        self.config = _jsonable(config) if config is not None else None
        return self

    def dump(self, reason: str = "manual", *,
             exception: Optional[BaseException] = None,
             path: Optional[str] = None,
             include_hbm: bool = True) -> Optional[str]:
        """Write ``flightrec.json``; returns the path (None when no path
        is configured — recording without arming is legal). Never raises:
        this runs inside except blocks and signal handlers.

        ``include_hbm=False`` skips the device-memory snapshot (which
        never initialises CUDA itself: it reads the allocator only in a
        process that already uses the card)."""
        try:
            path = path or self.path
            if not path:
                return None
            exc_info = None
            if exception is not None:
                exc_info = {
                    "type": type(exception).__name__,
                    "message": str(exception),
                    "traceback": traceback.format_exception(
                        type(exception), exception,
                        exception.__traceback__),
                }
            hbm = None
            if include_hbm:
                hbm = _jsonable(memory_snapshot())
            doc = {
                "reason": reason,
                "time": time.time(),
                "pid": os.getpid(),
                "config": self.config,
                "exception": exc_info,
                "hbm": hbm,
                "events": _jsonable(self.events()),
            }
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
            self.dumps += 1
            return path
        except Exception:  # noqa: BLE001 - a dump failure must not mask
            return None    # the original crash


def memory_snapshot() -> Optional[Dict[str, Any]]:
    """The caching allocator's view of each card this process uses
    (bytes allocated, reserved, peak), or None before CUDA is in use."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return {str(i): {"allocated": torch.cuda.memory_allocated(i),
                     "reserved": torch.cuda.memory_reserved(i),
                     "peak_allocated": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())}


# process-wide default recorder: layers record into it without plumbing
_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **data: Any) -> None:
    """Append one event to the default recorder (always cheap/bounded)."""
    _RECORDER.record(kind, **data)


def configure(path: str, config: Optional[Any] = None) -> FlightRecorder:
    return _RECORDER.configure(path, config)


def dump(reason: str = "manual", *,
         exception: Optional[BaseException] = None,
         path: Optional[str] = None) -> Optional[str]:
    return _RECORDER.dump(reason, exception=exception, path=path)


_PENDING = threading.Event()
_SIGNAL_INSTALLED = False


def _sigterm_dump(signum: int, frame) -> None:
    # Signal-handler discipline: mark the dump pending and get out. When
    # a graceful subscriber owns this signal the process keeps running to
    # its next step boundary, where flush_pending() does the open()/json
    # work on the normal call stack.
    _PENDING.set()
    from ..elastic import signals
    if any(graceful for _fn, graceful
           in signals.subscribers(signal.SIGTERM)):
        return
    # Terminating chain: no graceful owner means the pre-registry handler
    # / OS default kills the process right after this handler returns —
    # there is no later flush point, so this dump is the only dump.
    flush_pending()


def flush_pending() -> Optional[str]:
    """Write a dump the SIGTERM handler deferred; no-op when none is
    pending. Called from the Trainer's step boundary (next to the
    preemption poll)."""
    if not _PENDING.is_set():
        return None
    _PENDING.clear()
    return _RECORDER.dump("sigterm")


def install_signal_handler() -> bool:
    """Dump on SIGTERM (preemption / a scheduler's kill). Subscribes through
    the elastic signal registry, so this hook COEXISTS with the
    preemption guard: without a graceful subscriber the process still
    terminates after the dump (the pre-registry handler or the OS default
    is chained); with one, the handler only marks the dump pending and
    the Trainer flushes it at the next step boundary. Main thread only;
    returns False elsewhere."""
    global _SIGNAL_INSTALLED
    if _SIGNAL_INSTALLED:
        return True
    from ..elastic import signals      # lazy: flight must import light
    if signals.subscribe(signal.SIGTERM, _sigterm_dump):
        _SIGNAL_INSTALLED = True
        return True
    return False
