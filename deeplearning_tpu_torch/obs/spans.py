"""Thread-aware ring-buffered host span tracer.

The run-wide timeline the ROADMAP's on-chip calibration items consume:
every layer that owns a thread (Trainer hot loop, DevicePrefetcher
worker, MicroBatcher dispatch, the obs HBM sampler) marks its phases
with ``span("data_wait")`` blocks, and the tracer serializes them as
Chrome trace-event JSON (``runs/<dir>/trace.json``) that Perfetto /
``chrome://tracing`` loads directly — one timeline across threads
instead of four disjoint counter surfaces.

Cost discipline (the hot-loop rule from README "Hot-loop sync policy"
extended to instrumentation):
- **Disabled** (the default): ``span(...)`` allocates one slotted object
  and performs two ``is None`` checks — no lock, no clock read, no
  allocation growth. The bench obs-overhead smoke asserts the enabled
  path stays within 2% of this.
- **Enabled**: one ``perf_counter`` read on enter, one on exit, and a
  bounded ``deque.append`` under a lock. Never a device sync.

Device correlation: ``enable(xla_annotate=True)`` makes every span also
enter a ``torch.profiler.record_function`` range, so that when a
``torch.profiler`` trace is active, host spans land on the same timeline
as the CUDA kernels they bracket. ``step_span(step_num)`` names its range
``<name>#<step>``. (The flag keeps the JAX package's name so callers of
both packages pass the same keyword.)
"""

from __future__ import annotations

import collections
import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["SpanTracer", "enable", "disable", "get_tracer", "enabled",
           "span", "step_span", "traced"]

# module-level pointer: the `is None` check is the entire disabled-path
# cost, so spans stay near-free in un-instrumented processes
_TRACER: Optional["SpanTracer"] = None


class SpanTracer:
    """Bounded ring of completed host spans, one ring per process.

    Events are recorded with absolute wall-clock microsecond timestamps
    (``ts = epoch + perf_counter delta``) so traces from cooperating
    processes can be merged by a viewer without re-basing.
    """

    def __init__(self, capacity: int = 65536, xla_annotate: bool = False):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.capacity = capacity
        self.xla_annotate = xla_annotate
        self.dropped = 0          # spans evicted from the ring
        self.recorded = 0
        # perf_counter -> wall-clock anchor, taken once
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # ------------------------------------------------------- recording
    def _abs_us(self, t_perf: float) -> float:
        return (self._wall0 + (t_perf - self._perf0)) * 1e6

    def record(self, name: str, t_start: float, duration: float,
               args: Optional[Dict[str, Any]] = None) -> None:
        """Append one completed span; ``t_start`` is a ``perf_counter``
        value, ``duration`` in seconds."""
        th = threading.current_thread()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self.recorded += 1
            self._ring.append((name, th.ident, th.name,
                               self._abs_us(t_start), duration * 1e6,
                               args))

    def record_instant(self, name: str,
                       args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (rendered as an instant event)."""
        self.record(name, time.perf_counter(), 0.0, args)

    # -------------------------------------------------------- snapshot
    def events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event dicts for every retained span, prefixed
        with per-thread name metadata events."""
        with self._lock:
            ring = list(self._ring)
        pid = os.getpid()
        threads = {}
        for _, tid, tname, _, _, _ in ring:
            threads.setdefault(tid, tname)
        out: List[Dict[str, Any]] = [
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in threads.items()]
        for name, tid, _, ts, dur, args in ring:
            ev: Dict[str, Any] = {
                "ph": "X" if dur > 0 else "i", "name": name, "pid": pid,
                "tid": tid, "ts": round(ts, 3)}
            if dur > 0:
                ev["dur"] = round(dur, 3)
            else:
                ev["s"] = "t"          # instant event scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def dump(self, path: str) -> str:
        """Write ``trace.json`` (Chrome trace-event JSON). Loadable by
        Perfetto / chrome://tracing; ``tools/obs_report.py`` renders the
        phase breakdown from the same file; ``tools/trace_merge.py``
        joins per-replica dumps by the identity stamped here."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        events = self.events()
        other: Dict[str, Any] = {"recorded": self.recorded,
                                 "dropped": self.dropped}
        run_id = os.environ.get("DLTPU_RUN_ID")
        replica = os.environ.get("DLTPU_REPLICA")
        if run_id:
            other["run_id"] = run_id
        if replica is not None and replica != "":
            other["replica"] = replica
            # name the process row so a merged fleet timeline shows
            # "replica-N" instead of a bare pid
            events.insert(0, {
                "ph": "M", "name": "process_name", "pid": os.getpid(),
                "tid": 0, "args": {"name": f"replica-{replica}"}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": other}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.recorded = 0


# --------------------------------------------------------------- toggles
def enable(capacity: int = 65536,
           xla_annotate: bool = False) -> SpanTracer:
    """Install (or return) the process-wide tracer. Idempotent: a second
    enable keeps the existing ring so layered callers (Trainer + tests)
    share one timeline."""
    global _TRACER
    if _TRACER is None:
        _TRACER = SpanTracer(capacity=capacity, xla_annotate=xla_annotate)
    elif xla_annotate:
        _TRACER.xla_annotate = True
    return _TRACER


def disable() -> Optional[SpanTracer]:
    """Uninstall the tracer; returns it (un-dumped spans stay readable)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def get_tracer() -> Optional[SpanTracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


class span:
    """``with span("data_wait"): ...`` — records one host span.

    Slotted, lock-free and clock-free when tracing is disabled; when
    ``enable(xla_annotate=True)`` is active it also brackets the block
    in a ``torch.profiler.record_function`` so the device trace shows it.
    """

    __slots__ = ("name", "args", "_t0", "_ann")

    def __init__(self, name: str, **args: Any):
        self.name = name
        self.args = args or None
        self._t0 = None
        self._ann = None

    def __enter__(self) -> "span":
        tracer = _TRACER
        if tracer is None:
            return self
        if tracer.xla_annotate:
            try:
                import torch
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 - annotation is best-effort
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        tracer = _TRACER
        if tracer is not None and self._t0 is not None:
            t1 = time.perf_counter()
            if self._ann is not None:
                try:
                    self._ann.__exit__(*exc)
                except Exception:  # noqa: BLE001
                    pass
            tracer.record(self.name, self._t0, t1 - self._t0, self.args)
        self._t0 = None
        self._ann = None
        return False


class step_span:
    """Per-step span: a host ``span`` plus a
    ``torch.profiler.record_function`` range named ``<name>#<step>``.
    Annotation only happens while the tracer is enabled with
    ``xla_annotate`` so the disabled hot loop never constructs profiler
    objects."""

    __slots__ = ("_span", "_ann", "_name", "step_num")

    def __init__(self, name: str, step_num: int):
        self.step_num = step_num
        self._span = span(name, step=step_num)
        self._name = f"{name}#{step_num}"
        self._ann = None

    def __enter__(self) -> "step_span":
        tracer = _TRACER
        if tracer is not None and tracer.xla_annotate:
            try:
                import torch
                self._ann = torch.profiler.record_function(self._name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001
                self._ann = None
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:  # noqa: BLE001
                pass
            self._ann = None
        return False


def traced(name: Optional[str] = None):
    """Decorator form: ``@traced("checkpoint")`` wraps calls in a span."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _TRACER is None:       # fast path: no span object at all
                return fn(*args, **kwargs)
            with span(span_name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
