"""Runtime thread sanitizer: instrumented locks for the serving and
training fleet — the port of ``deeplearning_tpu/analysis/threadsan.py``.

``DLTPU_STRICT=threads`` (through ``analysis/strict.py``) swaps the
``threading.Lock`` / ``RLock`` constructors seen by the instrumented
modules for wrappers that:

- record every acquire and release into a bounded ring (thread name, lock
  site, wall time, the locks held), the flight recorder's idiom applied to
  locks;
- keep the per-thread held stack and the process-wide runtime lock-order
  graph, seeded from the STATIC graph that
  ``analysis/concurrency.py::lock_order_graph()`` computes: both key locks
  by the ``<path from the checkout root>:<line>`` of their creation site,
  so a ``with a: with b`` order proven in source and the reverse order
  observed live join into one cycle check;
- check consistency where the information exists: at acquire time (does
  this edge close a cycle in the runtime and static edges?) and at release
  time (LIFO discipline; releasing a lock this thread does not hold).

On a violation the sanitizer writes an autopsy (the ring, this thread's
held stack, the offending edge and the cycle it closes) to stderr and to
the flight recorder when ``obs.flight`` is loaded, and raises
:class:`LockOrderError`. A single-threaded interleaving is enough to trip
the order check (A then B now, B then A later), so a seeded cycle is
caught deterministically, not by a timing lottery.

Standard library only. Tests and the serve CLI arm it directly; the
Trainer through ``strict.maybe_enable_threads``. Instrument BEFORE
constructing the objects whose locks matter: ``enable()`` patches each
module's ``threading`` attribute, so locks created earlier stay raw, and a
module that did ``from threading import Lock`` is not watched (every
module of ``DEFAULT_MODULES`` calls ``threading.Lock()``).

Differences from the JAX module, by decision:
- ``enable()`` lets a failure of ``seed_static_edges`` raise; JAX's
  swallows it, which would leave the static half of the check off
  unseen.
- ``acquires()`` counts the acquires seen since ``reset()`` (the ring
  keeps only the last ``RING_SIZE`` events); ``status()`` and
  ``autopsy()`` keep JAX's keys.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "InstrumentedLock", "enable", "disable",
    "enabled", "seed_static_edges", "status", "autopsy", "reset",
    "acquires", "DEFAULT_MODULES", "RING_SIZE",
]

# modules whose locks the fleet contends on (the port's counterparts of
# JAX's list; ``obs.fleet`` comes with the fleet); enable() only touches
# the ones already imported, it never imports
DEFAULT_MODULES: Tuple[str, ...] = (
    "deeplearning_tpu_torch.serve.zoo",
    "deeplearning_tpu_torch.serve.batcher",
    "deeplearning_tpu_torch.serve.engine",
    "deeplearning_tpu_torch.obs.flight",
    "deeplearning_tpu_torch.obs.metrics",
    "deeplearning_tpu_torch.obs.xla",
    "deeplearning_tpu_torch.obs.threads",
    "deeplearning_tpu_torch.elastic.signals",
    "deeplearning_tpu_torch.elastic.heartbeat",
    "deeplearning_tpu_torch.elastic.supervisor",
    "deeplearning_tpu_torch.data.device_prefetch",
)

RING_SIZE = 512

# originals, captured before any proxying can occur
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_THIS_FILE = os.path.abspath(__file__)


class LockOrderError(RuntimeError):
    """A lock-discipline violation caught live; carries the autopsy."""

    def __init__(self, msg: str, report: Dict[str, Any]):
        super().__init__(msg)
        self.report = report


class _State:
    """Process-wide sanitizer state, guarded by a RAW lock."""

    def __init__(self) -> None:
        self.mu = _ORIG_LOCK()
        self.enabled = False
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.static_edges: Set[Tuple[str, str]] = set()
        self.ring: "collections.deque" = collections.deque(
            maxlen=RING_SIZE)
        self.locks: Dict[str, "InstrumentedLock"] = {}
        self.violations = 0
        self.acquires = 0
        # fuse: after a violation the sanitizer is record-only until
        # reset() — the raise unwinds through __exit__ calls that would
        # otherwise cascade secondary violations masking the first
        self.tripped = False
        self.patched: List[Tuple[Any, Any]] = []   # (module, old attr)


_S = _State()
_TLS = threading.local()


def _held() -> List["InstrumentedLock"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _creation_site() -> str:
    """file:line of the frame that called Lock()/RLock(), skipping the
    sanitizer's own frames — the same key the static graph uses."""
    frame = sys._getframe(1)
    while frame is not None:
        fn = frame.f_code.co_filename
        if os.path.abspath(fn) != _THIS_FILE:
            rel = os.path.relpath(fn, _REPO_ROOT).replace(os.sep, "/")
            return f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>:0"


def _record(action: str, site: str) -> None:
    _S.ring.append({
        "t": time.time(),
        "thread": threading.current_thread().name,
        "action": action,
        "lock": site,
        "held": [lk.site for lk in _held()],
    })


def _adjacency() -> Dict[str, Set[str]]:
    adj: Dict[str, Set[str]] = {}
    for (a, b) in _S.edges:
        adj.setdefault(a, set()).add(b)
    for (a, b) in _S.static_edges:
        adj.setdefault(a, set()).add(b)
    return adj


def _path_between(adj: Dict[str, Set[str]], src: str, dst: str
                  ) -> Optional[List[str]]:
    """A src→dst path in the edge set, if one exists (BFS)."""
    prev: Dict[str, str] = {}
    todo = collections.deque([src])
    seen = {src}
    while todo:
        node = todo.popleft()
        if node == dst:
            out = [node]
            while node != src:
                node = prev[node]
                out.append(node)
            return out[::-1]
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                prev[nxt] = node
                todo.append(nxt)
    return None


def _violate(kind: str, msg: str, **extra: Any) -> None:
    _S.violations += 1
    _S.tripped = True
    report = autopsy()
    report["violation"] = {"kind": kind, "msg": msg, **extra}
    try:
        sys.stderr.write(f"[threadsan] {kind}: {msg}\n")
        for ev in list(_S.ring)[-16:]:
            sys.stderr.write(
                f"[threadsan]   {ev['thread']} {ev['action']} "
                f"{ev['lock']} held={ev['held']}\n")
    # dltpu: allow(DLT104) stderr reporting must never mask the raise below
    except Exception:  # noqa: BLE001
        pass
    try:  # flightrec autopsy ride-along, when obs.flight is loaded
        flight = sys.modules.get("deeplearning_tpu_torch.obs.flight")
        if flight is not None:
            flight.record("threadsan_violation", kind=kind, msg=msg)
    # dltpu: allow(DLT104) ride-along telemetry; the raise below still fires
    except Exception:  # noqa: BLE001
        pass
    raise LockOrderError(f"{kind}: {msg}", report)


def _on_acquired(lock: "InstrumentedLock") -> None:
    held = _held()
    with _S.mu:
        _S.acquires += 1
        _record("acquire", lock.site)
        for h in held:
            if h.site == lock.site:
                continue           # RLock re-entry: no fresh edge
            edge = (h.site, lock.site)
            if edge in _S.edges:
                _S.edges[edge]["count"] += 1
                continue
            adj = _adjacency()
            back = _path_between(adj, lock.site, h.site)
            _S.edges[edge] = {
                "count": 1,
                "thread": threading.current_thread().name,
            }
            if back is not None and not _S.tripped:
                cycle = back + [lock.site]
                held_sites = [lk.site for lk in held]
                # raising inside the with below would hold mu; record
                # first, raise after
                _S.ring.append({
                    "t": time.time(),
                    "thread": threading.current_thread().name,
                    "action": "cycle", "lock": lock.site,
                    "held": held_sites,
                })
                kind = "lock-order-inversion"
                msg = (f"acquiring {lock.site} while holding "
                       f"{held_sites} closes the cycle "
                       f"{' -> '.join(cycle)}")
                break
        else:
            held.append(lock)
            return
    held.append(lock)              # the acquire DID succeed
    _violate(kind, msg, cycle=cycle)


def _on_release(lock: "InstrumentedLock") -> None:
    held = _held()
    with _S.mu:
        _record("release", lock.site)
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            if (i != len(held) - 1 and not lock.reentrant
                    and not _S.tripped):
                _violate(
                    "non-lifo-release",
                    f"releasing {lock.site} while "
                    f"{[lk.site for lk in held[i + 1:]]} acquired "
                    "after it are still held")
            del held[i]
            return
    if _S.tripped:
        return
    _violate("release-unheld",
             f"thread {threading.current_thread().name} releases "
             f"{lock.site} it does not hold")


class InstrumentedLock:
    """Drop-in Lock/RLock wrapper feeding the sanitizer state."""

    def __init__(self, reentrant: bool = False):
        self._inner = _ORIG_RLOCK() if reentrant else _ORIG_LOCK()
        self.reentrant = reentrant
        self.site = _creation_site()
        with _S.mu:
            _S.locks[self.site] = self

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _on_acquired(self)
        return ok

    def release(self) -> None:
        _on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        try:
            return self._inner.locked()
        except AttributeError:     # RLock pre-3.12 has no .locked()
            return any(lk is self for lk in _held())

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"<InstrumentedLock {kind} {self.site}>"


class _ThreadingProxy:
    """Per-module stand-in for the ``threading`` module: Lock/RLock
    construct instrumented wrappers, everything else forwards. Swapping
    a module's ``threading`` attribute (not the global module) keeps
    the blast radius to the instrumented fleet."""

    def __init__(self) -> None:
        self.__dict__["_real"] = threading

    def Lock(self) -> InstrumentedLock:  # noqa: N802 - stand-in name
        return InstrumentedLock(reentrant=False)

    def RLock(self) -> InstrumentedLock:  # noqa: N802
        return InstrumentedLock(reentrant=True)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["_real"], name)


def seed_static_edges(graph: Optional[Dict[str, Any]] = None) -> int:
    """Load ``concurrency.lock_order_graph()`` edges (or a precomputed
    graph dict) into the runtime check. Returns edges seeded."""
    if graph is None:
        from . import concurrency
        graph = concurrency.lock_order_graph()
    locks = graph.get("locks", {})

    def site(lock_id: str) -> Optional[str]:
        meta = locks.get(lock_id)
        if meta is None:
            return None
        return f"{meta['path']}:{meta['line']}"

    n = 0
    with _S.mu:
        for e in graph.get("edges", ()):
            a, b = site(e["src"]), site(e["dst"])
            if a and b and a != b:
                _S.static_edges.add((a, b))
                n += 1
    return n


def enable(modules: Optional[Iterable[Any]] = None,
           seed_static: bool = True) -> List[str]:
    """Arm the sanitizer: patch each module's ``threading`` attribute.

    ``modules`` may be module objects or dotted names; default is every
    :data:`DEFAULT_MODULES` entry already imported. Idempotent.
    Returns the names actually patched this call."""
    targets: List[Any] = []
    if modules is None:
        for name in DEFAULT_MODULES:
            mod = sys.modules.get(name)
            if mod is not None:
                targets.append(mod)
    else:
        for m in modules:
            mod = sys.modules.get(m) if isinstance(m, str) else m
            if mod is not None:
                targets.append(mod)
    patched: List[str] = []
    with _S.mu:
        already = {id(mod) for mod, _old in _S.patched}
        for mod in targets:
            if id(mod) in already:
                continue
            old = getattr(mod, "threading", None)
            if old is None or isinstance(old, _ThreadingProxy):
                continue
            mod.threading = _ThreadingProxy()
            _S.patched.append((mod, old))
            patched.append(getattr(mod, "__name__", repr(mod)))
        _S.enabled = True
    if seed_static:
        seed_static_edges()
    return patched


def disable() -> None:
    """Restore every patched module and stop recording. Existing
    InstrumentedLock instances keep working (they only log)."""
    with _S.mu:
        for mod, old in _S.patched:
            mod.threading = old
        _S.patched.clear()
        _S.enabled = False


def enabled() -> bool:
    return _S.enabled


def reset() -> None:
    """Drop recorded state (edges/ring/locks) but keep patches — test
    isolation between cases sharing one process."""
    with _S.mu:
        _S.edges.clear()
        _S.static_edges.clear()
        _S.ring.clear()
        _S.locks.clear()
        _S.violations = 0
        _S.acquires = 0
        _S.tripped = False
    # this thread's held stack may reference pre-reset locks (a raise
    # mid-__enter__ leaves them); other threads' stacks live in their
    # own TLS and drain as those threads unwind
    _TLS.stack = []


def acquires() -> int:
    """Acquires of instrumented locks seen since the last ``reset()``."""
    with _S.mu:
        return _S.acquires


def status() -> Dict[str, Any]:
    with _S.mu:
        return {
            "enabled": _S.enabled,
            "locks_instrumented": len(_S.locks),
            "runtime_edges": len(_S.edges),
            "static_edges": len(_S.static_edges),
            "ring_events": len(_S.ring),
            "violations": _S.violations,
            "tripped": _S.tripped,
            "modules_patched": len(_S.patched),
        }


def autopsy() -> Dict[str, Any]:
    """Flightrec-style snapshot: the ring, the graphs, the held stacks
    (this thread's; other threads' stacks live in their TLS and show up
    through the ring's ``held`` field)."""
    with _S.mu:
        return {
            "ring": list(_S.ring),
            "edges": {f"{a} -> {b}": dict(meta)
                      for (a, b), meta in _S.edges.items()},
            "static_edges": sorted(f"{a} -> {b}"
                                   for a, b in _S.static_edges),
            "locks": sorted(_S.locks),
            "violations": _S.violations,
            "held_here": [lk.site for lk in _held()],
        }
