"""Thread spawn registry: the one place background threads are born.

The runtime grew a real thread fleet — feed prefetcher, serve dispatch,
zoo loaders, HBM sampler, heartbeat writer, metrics/fleet servers,
wedge watchers — and the concurrency linter (``analysis/concurrency.py``,
rule DLT204) needs every entry point to be enumerable: a ``Thread``
whose target nobody can find is a shared-state writer nobody audits.
``spawn()`` is that choke point. It creates, records, and (by default)
starts a **named** thread; ``inventory()`` exposes what was spawned so
``tools/obs_report.py`` and the strict-mode thread sanitizer can cross-
check the live fleet against the statically known spawn sites.

Stdlib-only by construction (no jax, no intra-package imports): the
supervisor and ``tools/check.py`` load paths must stay light, and the
registry itself must be importable from a signal handler's drain hook.

Contract (README "Concurrency policy"):

- every background thread is created via ``spawn(target, name=...)`` —
  raw ``threading.Thread(...)`` anywhere else is a DLT204 finding;
- every thread has a stable, grep-able name (it shows up in span
  timelines, flight events, and sanitizer autopsies);
- non-daemon threads are the caller's to ``join()`` (DLT203 audits
  that); the registry records daemon-ness so the report can show which
  threads can outlive a clean shutdown.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["spawn", "inventory", "counts", "live", "clear"]

_LOCK = threading.Lock()
_MAX_RECORDS = 4096              # loadgen fleets are the realistic ceiling
_RECORDS: List[Dict[str, Any]] = []
_spawned_total = 0


def spawn(target: Callable[..., Any], *, name: str,
          args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None,
          daemon: bool = True, start: bool = True) -> threading.Thread:
    """Create (and by default start) a registered background thread.

    ``name`` is mandatory — an anonymous thread is un-auditable. With
    ``start=False`` the caller finishes its own bookkeeping (publish the
    handle, attach a stop event) before calling ``.start()`` itself.
    """
    if not name:
        raise ValueError("spawn() requires a non-empty thread name")
    thread = threading.Thread(target=target, name=name, args=args,
                              kwargs=kwargs or {}, daemon=daemon)
    record = {
        "name": name,
        "daemon": bool(daemon),
        "target": getattr(target, "__qualname__", None) or repr(target),
        "created": time.time(),
        "ref": weakref.ref(thread),
    }
    global _spawned_total
    with _LOCK:
        _spawned_total += 1
        _RECORDS.append(record)
        if len(_RECORDS) > _MAX_RECORDS:
            del _RECORDS[: len(_RECORDS) - _MAX_RECORDS]
    if start:
        thread.start()
    return thread


def inventory() -> List[Dict[str, Any]]:
    """Snapshot of every recorded spawn (newest last): name, target,
    daemon-ness, and whether the thread is still alive. Dead threads
    whose objects were collected stay listed with ``alive=False`` —
    the inventory is a history, not just a census."""
    with _LOCK:
        records = list(_RECORDS)
    out = []
    for r in records:
        thread = r["ref"]()
        out.append({
            "name": r["name"],
            "target": r["target"],
            "daemon": r["daemon"],
            "created": r["created"],
            "alive": bool(thread is not None and thread.is_alive()),
        })
    return out

def live() -> List[str]:
    """Names of registered threads currently alive."""
    return [r["name"] for r in inventory() if r["alive"]]


def counts() -> Dict[str, int]:
    inv = inventory()
    return {
        "spawned_total": _spawned_total,
        "recorded": len(inv),
        "alive": sum(1 for r in inv if r["alive"]),
        "non_daemon": sum(1 for r in inv if not r["daemon"]),
    }


def clear() -> None:
    """Test hook: drop the history (does not touch live threads)."""
    global _spawned_total
    with _LOCK:
        _RECORDS.clear()
        _spawned_total = 0
