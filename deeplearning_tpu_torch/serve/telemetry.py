"""Serving telemetry: sync-free request/batch gauges for the dispatcher.

Same discipline as ``train/async_metrics.DeferredMetrics``: the thread
that talks to the device (the batcher's dispatch loop) must never pay a
D2H sync to record a number. Everything recorded here is host-side
bookkeeping — timestamps taken at submit/demux, queue depths read off a
``queue.Queue``, bucket occupancy known at padding time — appended to
bounded rings (``collections.deque(maxlen=...)``), so a snapshot is a
pure host computation over already-resolved floats.

Two latency views, deliberately distinct:
- ``dispatch``: submit → demux (futures resolved with DEVICE arrays; no
  sync happened yet). What the engine itself controls: queueing + batch
  formation + executable dispatch.
- ``e2e``: submit → result materialized on the host. Recorded by the
  CLIENT thread (``SubmitHandle.result()`` / tools/loadgen.py), which is
  the thread that pays the D2H anyway — the device wait lands on the
  requester, never on the dispatcher (the lagged-ring idiom).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Sequence

__all__ = ["ServeTelemetry", "percentile"]


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over a small host ring (no numpy import
    on the hot path; rings are <= maxlen floats)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(int(q / 100.0 * len(xs)), len(xs) - 1)
    return xs[idx]


class ServeTelemetry:
    """Bounded-ring counters and gauges for one engine+batcher pair.

    Thread-safe: submit paths, the dispatch thread, and client threads
    all record concurrently (one lock; every op is O(1) appends/adds).
    """

    def __init__(self, ring: int = 2048):
        self._lock = threading.Lock()
        self._dispatch_lat = collections.deque(maxlen=ring)
        self._e2e_lat = collections.deque(maxlen=ring)
        self._batch_real = collections.deque(maxlen=ring)
        self._batch_bucket = collections.deque(maxlen=ring)
        self._queue_depth = collections.deque(maxlen=ring)
        # event timestamps for windowed rates (the fleet aggregator sums
        # rates across replicas — cumulative counters alone can't say
        # "QPS now"). Same bounded-ring discipline: one append per event.
        self._submit_ts = collections.deque(maxlen=ring)
        self._reject_ts = collections.deque(maxlen=ring)
        self._complete_ts = collections.deque(maxlen=ring)
        self._born = time.monotonic()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.timed_out = 0
        self.batches = 0
        self.shed_batches = 0

    # ------------------------------------------------------- recording
    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            self._submit_ts.append(time.monotonic())

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1
            self._reject_ts.append(time.monotonic())

    def record_timeout(self, n: int = 1) -> None:
        with self._lock:
            self.timed_out += n

    def record_batch(self, bucket: int, n_real: int, queue_depth: int,
                     shed: bool = False) -> None:
        """One dispatched micro-batch: ``n_real`` requests padded into a
        ``bucket``-row executable, observed ``queue_depth`` left behind."""
        with self._lock:
            self.batches += 1
            if shed:
                self.shed_batches += 1
            self._batch_real.append(float(n_real))
            self._batch_bucket.append(float(bucket))
            self._queue_depth.append(float(queue_depth))

    def record_dispatch_latency(self, seconds: float, n: int = 1) -> None:
        with self._lock:
            self.completed += n
            self._dispatch_lat.append(float(seconds))
            now = time.monotonic()
            for _ in range(n):
                self._complete_ts.append(now)

    def record_e2e_latency(self, seconds: float) -> None:
        with self._lock:
            self._e2e_lat.append(float(seconds))

    # -------------------------------------------------------- snapshot
    def latency_ms(self, kind: str = "e2e") -> Dict[str, float]:
        """{p50, p90, p99} over the ring, in milliseconds."""
        with self._lock:
            ring = list(self._e2e_lat if kind == "e2e"
                        else self._dispatch_lat)
        return {f"p{q}": round(percentile(ring, q) * 1e3, 3)
                for q in (50, 90, 99)}

    @property
    def batch_occupancy(self) -> float:
        """Mean real-rows / bucket-rows over recent batches (1.0 = every
        executable ran full; low values mean latency-bound padding)."""
        with self._lock:
            if not self._batch_real:
                return 0.0
            return (sum(self._batch_real)
                    / max(sum(self._batch_bucket), 1.0))

    @property
    def queue_depth_mean(self) -> float:
        with self._lock:
            ring = self._queue_depth
            return sum(ring) / len(ring) if ring else 0.0

    def rates(self, window_s: float = 10.0) -> Dict[str, float]:
        """{requests_per_s, rejects_per_s, completions_per_s} over the
        trailing ``window_s``. The divisor is the *effective* window —
        min(window_s, age of this telemetry object) — so a short burst
        right after startup measures its true rate instead of being
        diluted by a window that predates the process."""
        now = time.monotonic()
        cut = now - window_s
        eff = max(min(window_s, now - self._born), 1e-6)
        with self._lock:
            counts = {
                "requests_per_s": sum(1 for t in self._submit_ts
                                      if t >= cut),
                "rejects_per_s": sum(1 for t in self._reject_ts
                                     if t >= cut),
                "completions_per_s": sum(1 for t in self._complete_ts
                                         if t >= cut),
            }
        out = {k: round(v / eff, 3) for k, v in counts.items()}
        out["window_s"] = round(eff, 3)
        return out

    def snapshot(self) -> Dict[str, float]:
        """One flat dict for bench rows / the serve CLI stats line."""
        disp = self.latency_ms("dispatch")
        e2e = self.latency_ms("e2e")
        with self._lock:
            out = {
                "submitted": float(self.submitted),
                "completed": float(self.completed),
                "rejected": float(self.rejected),
                "timed_out": float(self.timed_out),
                "batches": float(self.batches),
                "shed_batches": float(self.shed_batches),
            }
        out["batch_occupancy"] = round(self.batch_occupancy, 4)
        out["queue_depth_mean"] = round(self.queue_depth_mean, 2)
        out.update(self.rates())
        for k, v in disp.items():
            out[f"dispatch_ms_{k}"] = v
        for k, v in e2e.items():
            out[f"e2e_ms_{k}"] = v
        return out
