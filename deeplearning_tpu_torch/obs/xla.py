"""Device-memory telemetry — the port of ``deeplearning_tpu/obs/xla.py``'s
memory half (``hbm_snapshot``, ``HbmWatermark``, the alert fraction).

``hbm_snapshot()`` reads the card: ``torch.cuda.mem_get_info`` gives the
device-wide ``bytes_in_use`` (total less free: every process, the CUDA
context and the caching allocator's reserve) and ``bytes_limit`` (the
card's memory), which is the reading a zoo of tenants evicts by;
``torch.cuda.memory_stats`` adds this process's peak and reserve, and a
``live_arrays`` census of the tensors it holds. Neither call waits on a
stream. In a process that has not started CUDA (the CPU, or a card not
yet used) the device list carries no limit, so a consumer sees no
pressure — as the JAX snapshot on a CPU backend, which reports no
``memory_stats``.

``HbmWatermark`` samples that snapshot from its own thread
("obs-metrics") on an interval, tracking run-peak values; its samples
are spans, so the timeline shows memory next to the phases that
allocated it, and gauges of the metrics registry.

The compile half of the JAX module (``tracked_compile`` and its event
ring) has no counterpart: eager PyTorch compiles nothing ahead. Nor has
``set_hbm_alert_frac``: the Trainer hands its ``hbm_alert_frac`` to its
sampler, and the zoo has its own.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from . import flight, metrics, spans
from . import threads as obs_threads

__all__ = ["hbm_snapshot", "HbmWatermark"]

_ALERTED: set = set()          # device ids already alerted (edge-trigger)


def _env_alert_frac() -> Optional[float]:
    raw = os.environ.get("DLTPU_HBM_ALERT_FRAC")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _card_stats(index: int) -> Dict[str, int]:
    """One card's reading in the JAX snapshot's field names, plus this
    process's live tensors (``live_count``, ``live_bytes``)."""
    import torch
    free, total = torch.cuda.mem_get_info(index)
    stats = torch.cuda.memory_stats(index)
    return {"live_count": int(stats.get("active.all.current", 0)),
            "live_bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_in_use": int(total - free),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(stats.get(
                "allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get(
                "reserved_bytes.all.current", 0)),
            "num_allocs": int(stats.get("allocation.all.current", 0))}


def _mem_entry(index: int, kind: str, stats: Optional[Dict[str, int]],
               alert_frac: Optional[float]) -> Dict[str, Any]:
    """One device's snapshot entry, with the optional usage alert."""
    entry: Dict[str, Any] = {"id": index, "kind": kind}
    if not stats:
        return entry
    entry.update(stats)
    in_use, limit = entry.get("bytes_in_use"), entry.get("bytes_limit")
    if in_use is not None and limit:
        frac = in_use / limit
        entry["usage_frac"] = round(frac, 4)
        if alert_frac is not None and frac >= alert_frac:
            entry["alert"] = {"threshold_frac": alert_frac,
                              "usage_frac": round(frac, 4)}
            if index not in _ALERTED:      # edge-trigger: once per device
                _ALERTED.add(index)
                flight.record("hbm_alert", device=index,
                              usage_frac=round(frac, 4),
                              threshold_frac=alert_frac,
                              bytes_in_use=in_use, bytes_limit=limit)
        elif alert_frac is not None:
            _ALERTED.discard(index)        # re-arm once usage recedes
    return entry


def hbm_snapshot(alert_frac: Optional[float] = None) -> Dict[str, Any]:
    """One point-in-time device-memory reading; cheap enough to take at
    crash time and from the sampler thread, and it never synchronises.
    When an alert fraction is configured (the argument, else
    ``DLTPU_HBM_ALERT_FRAC``), a device crossing it gets an ``alert``
    sub-dict and an edge-triggered ``hbm_alert`` flight event."""
    if alert_frac is None:
        alert_frac = _env_alert_frac()
    snap: Dict[str, Any] = {"time": time.time()}
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            devices, count, nbytes = [], 0, 0
            for i in range(torch.cuda.device_count()):
                stats = _card_stats(i)
                count += stats.pop("live_count")
                nbytes += stats.pop("live_bytes")
                devices.append(_mem_entry(
                    i, torch.cuda.get_device_name(i), stats, alert_frac))
            snap["devices"] = devices
            snap["live_arrays"] = {"count": count, "nbytes": nbytes}
        else:
            snap["devices"] = [_mem_entry(0, "cpu", None, alert_frac)]
    except Exception:  # noqa: BLE001 - snapshot is best-effort
        pass
    return snap


class HbmWatermark:
    """Background memory sampler: one daemon thread ("obs-metrics")
    taking ``hbm_snapshot()`` every ``interval_s``, keeping run-peak
    watermarks and emitting each sample as a span from its own thread.

    An immediate first sample on ``start()`` guarantees even a 5-step
    smoke run records at least one memory point."""

    def __init__(self, interval_s: float = 0.5,
                 alert_frac: Optional[float] = None):
        self.interval_s = max(float(interval_s), 0.01)
        self.alert_frac = alert_frac
        self.samples = 0
        self.peak_live_bytes = 0
        self.peak_bytes_in_use = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> None:
        t0 = time.perf_counter()
        snap = hbm_snapshot(alert_frac=self.alert_frac)
        self.samples += 1
        live = snap.get("live_arrays", {}).get("nbytes", 0)
        self.peak_live_bytes = max(self.peak_live_bytes, live)
        for dev in snap.get("devices", []):
            in_use = dev.get("bytes_in_use", 0)
            self.peak_bytes_in_use = max(self.peak_bytes_in_use, in_use)
        tracer = spans.get_tracer()
        if tracer is not None:
            tracer.record("hbm_sample", t0,
                          time.perf_counter() - t0,
                          {"live_bytes": live,
                           "live_count":
                               snap.get("live_arrays", {}).get("count", 0),
                           "peak_live_bytes": self.peak_live_bytes})
        metrics.set_gauge("dltpu_hbm_live_bytes", float(live))
        metrics.set_gauge("dltpu_hbm_peak_live_bytes",
                          float(self.peak_live_bytes))
        metrics.set_gauge("dltpu_hbm_peak_bytes_in_use",
                          float(self.peak_bytes_in_use))

    def _run(self) -> None:
        self._sample()                       # guaranteed first point
        while not self._stop.wait(self.interval_s):
            try:
                self._sample()
            except Exception:  # noqa: BLE001 - sampling is best-effort
                pass

    def start(self) -> "HbmWatermark":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = obs_threads.spawn(
                self._run, name="obs-metrics", daemon=True)
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def watermark(self) -> Dict[str, float]:
        return {
            "hbm_samples": float(self.samples),
            "peak_live_bytes": float(self.peak_live_bytes),
            "peak_bytes_in_use": float(self.peak_bytes_in_use),
        }

    def __enter__(self) -> "HbmWatermark":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
