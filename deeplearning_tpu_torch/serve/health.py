"""Health surface: the one readiness/overload verdict for a serving
process — the port of ``deeplearning_tpu/serve/health.py``: ``health``
for one engine, ``zoo_health`` for a multi-tenant zoo process.

``GET /healthz`` answers from state the stack already tracks — no device
work, no synchronisation, safe to poll at any rate:

- **Ready?** The engine is *warm* once every batch bucket has run
  (``compile_count >= len(buckets)``); before that a request would pay
  the kernel build, so the process reports 503 "warming".
- **Degraded?** The admission policy sheds on the live queue depth: 503
  "degraded" while it does.
- **Draining?** 503 "draining" while the batcher refuses new work and
  flushes its queue.
- **Wedged?** ``DispatchWatch`` applies ``WedgeDetector`` to the
  dispatched-batch counter: work queued (or a batch in flight) with the
  counter frozen past the deadline reads "wedged" (highest precedence).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..elastic.supervisor import WedgeDetector

__all__ = ["health", "zoo_health", "DispatchWatch"]


class DispatchWatch:
    """Wedge verdict over a ``MicroBatcher``'s dispatch progress.

    Each ``verdict()`` call feeds the detector the dispatched-batch
    counter, plus a synthetic idle tick whenever there is genuinely
    nothing to do — so only "work waiting, counter frozen for
    ``deadline_s``" ever reads ``"wedged"``. Host-only; safe to poll
    from the healthz handler at any rate."""

    def __init__(self, batcher, deadline_s: float = 30.0):
        self.batcher = batcher
        self.detector = WedgeDetector(deadline_s)
        self._idle = 0

    def verdict(self, now: Optional[float] = None) -> str:
        if self.batcher.queue_depth == 0 and not self.batcher.busy:
            self._idle += 1           # idle is progress, not a wedge
        activity = int(self.batcher.dispatched) + self._idle
        return self.detector.observe(None, activity, now=now)

    def stalled_for(self, now: Optional[float] = None) -> float:
        return self.detector.stalled_for(now)


def health(engine, batcher=None,
           wedge: Optional[DispatchWatch] = None
           ) -> Tuple[int, Dict[str, Any]]:
    """(http_status, payload) for one engine (+ optional batcher).
    200 "ready": warm engine, not shedding; 503 "warming", "degraded",
    "draining" or "wedged" (precedence: wedged > draining > warming >
    degraded). Pure host reads."""
    warm = engine.compile_count >= len(engine.buckets)
    depth = batcher.queue_depth if batcher is not None else 0
    shed = (batcher.admission.overloaded(depth)
            if batcher is not None else False)
    wedged = wedge is not None and wedge.verdict() == "wedged"
    draining = bool(getattr(batcher, "draining", False))
    status = "wedged" if wedged else (
        "draining" if draining else (
            "ready" if warm and not shed else (
                "warming" if not warm else "degraded")))
    payload: Dict[str, Any] = {
        "status": status,
        "engine_warm": warm,
        "queue_depth": depth,
        "shed": shed,
        "model": engine.name,
        "task": engine.task,
        "buckets": list(engine.buckets),
        "wedged": wedged,
        "draining": draining,
        "drained": bool(getattr(batcher, "drained", False)),
    }
    if batcher is not None:
        payload["e2e_ms_p99"] = batcher.telemetry.latency_ms("e2e")["p99"]
        payload["rejected"] = batcher.telemetry.rejected
        payload["dispatched"] = batcher.dispatched
    if wedged:
        payload["stalled_s"] = round(wedge.stalled_for(), 3)
    return (200 if status == "ready" else 503), payload


def zoo_health(zoo, batcher=None,
               wedge: Optional[DispatchWatch] = None
               ) -> Tuple[int, Dict[str, Any]]:
    """(http_status, payload) for a multi-tenant zoo process.

    200 "ready" when no tenant is mid-load and no lane sheds — cold
    (registered/evicted) tenants do NOT block readiness, because a
    request for one triggers a hot-load rather than an error. 503
    "warming" while any load is in flight, "degraded" while any lane
    sheds, "draining" while the batcher flushes toward a requeue,
    "wedged" (precedence) on a frozen dispatch stream. The
    payload carries the full per-model state table (warm/evicted/
    loading, bytes, quotas, queue depths) so per-tenant posture is
    diagnosable from the probe alone. Pure host reads."""
    zs = zoo.stats()
    models: Dict[str, Any] = {}
    any_loading = False
    any_shed = False
    for alias, row in zs["models"].items():
        entry = dict(row)
        if batcher is not None:
            depth = batcher.lane_depth(alias)
            entry["queue_depth"] = depth
            entry["shed"] = zoo.admission_for(alias).overloaded(depth)
            any_shed = any_shed or entry["shed"]
            lane_tel = batcher.lane_telemetry(alias)
            if lane_tel is not None:
                entry["e2e_ms_p99"] = lane_tel.latency_ms("e2e")["p99"]
                entry["rejected"] = lane_tel.rejected
        any_loading = any_loading or row["state"] == "loading"
        models[alias] = entry
    wedged = wedge is not None and wedge.verdict() == "wedged"
    draining = bool(getattr(batcher, "draining", False))
    standby = bool(getattr(batcher, "standby", False))
    status = "wedged" if wedged else (
        "draining" if draining else (
            "standby" if standby else (
                "warming" if any_loading else (
                    "degraded" if any_shed else "ready"))))
    payload: Dict[str, Any] = {
        "status": status,
        "standby": standby,
        "zoo": {k: zs[k] for k in ("registered", "resident", "loads",
                                   "evictions", "rejected_loads",
                                   "alert_frac")},
        "models": models,
        "wedged": wedged,
        "draining": draining,
        "drained": bool(getattr(batcher, "drained", False)),
    }
    if batcher is not None:
        payload["queue_depth"] = batcher.queue_depth
        payload["dispatched"] = getattr(batcher, "dispatched", 0)
    if wedged:
        payload["stalled_s"] = round(wedge.stalled_for(), 3)
    return (200 if status == "ready" else 503), payload
