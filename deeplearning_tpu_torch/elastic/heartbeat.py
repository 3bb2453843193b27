"""Heartbeat file: the supervisor's window into a training process — a
copy of ``deeplearning_tpu/elastic/heartbeat.py``.

The Trainer touches a tiny in-memory :class:`Heartbeat` from the same
instrumentation points that emit obs spans (data_wait/dispatch/eval/
checkpoint) — a step watermark plus a monotonically increasing activity
counter. A daemon :class:`HeartbeatWriter` serializes it to a JSON file
on an interval with atomic replace, and the supervisor reads that file
to distinguish *slow* (activity advancing, steps not) from *wedged*
(neither advancing: the host thread is stuck, e.g. waiting on the card).

The writer thread keeps writing wall time even while the main thread is
wedged — deliberately. File freshness proves the *process* is alive;
only ``step``/``activity`` prove the *training loop* is. A supervisor
keying on mtime alone would never catch a wedged loop.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..obs import threads as obs_threads

__all__ = ["Heartbeat", "HeartbeatWriter", "read_heartbeat", "ENV_VAR",
           "RUN_ID_VAR", "REPLICA_VAR"]

# the supervisor hands its child the heartbeat path through this env var
ENV_VAR = "DLTPU_HEARTBEAT"

# fleet identity (tools/supervise.py exports these; obs/metrics.py uses
# the same names) — stamped into every heartbeat doc so supervisor
# heartbeats and fleet /metrics scrapes join on the same key
RUN_ID_VAR = "DLTPU_RUN_ID"
REPLICA_VAR = "DLTPU_REPLICA"


def _identity() -> Dict[str, str]:
    out: Dict[str, str] = {}
    run_id = os.environ.get(RUN_ID_VAR)
    replica = os.environ.get(REPLICA_VAR)
    if run_id:
        out["run_id"] = run_id
    if replica is not None and replica != "":
        out["replica"] = replica
    return out


class Heartbeat:
    """Shared mutable beat state. ``touch()`` is one int bump + two
    attribute stores — cheap enough for the hot loop, GIL-atomic enough
    to need no lock (the writer only ever reads)."""

    __slots__ = ("step", "activity", "phase")

    def __init__(self, step: int = 0):
        self.step = int(step)
        self.activity = 0
        self.phase = ""

    def touch(self, phase: Optional[str] = None,
              step: Optional[int] = None) -> None:
        if step is not None:
            self.step = int(step)
        if phase is not None:
            self.phase = phase
        self.activity += 1


class HeartbeatWriter:
    """Daemon thread ("elastic-heartbeat") serializing a Heartbeat to
    ``path`` every ``interval_s``. Writes are tmp + ``os.replace`` so a
    reader never sees a torn file; an immediate first write on start
    gives the supervisor a pid to key on before the first step lands."""

    def __init__(self, path: str, beat: Heartbeat,
                 interval_s: float = 0.5):
        self.path = os.path.abspath(path)
        self.beat = beat
        self.interval_s = max(float(interval_s), 0.05)
        self.writes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _write(self) -> None:
        doc = {"time": time.time(), "pid": os.getpid(),
               "step": self.beat.step, "activity": self.beat.activity,
               "phase": self.beat.phase, **_identity()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            self.writes += 1
        except OSError:
            pass                       # a missed beat is not a crash

    def _run(self) -> None:
        self._write()
        while not self._stop.wait(self.interval_s):
            self._write()

    def start(self) -> "HeartbeatWriter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = obs_threads.spawn(
                self._run, name="elastic-heartbeat", daemon=True)
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._write()                  # final beat: the exit watermark


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """Parse a heartbeat file; None when absent/torn (the writer's
    atomic replace makes torn reads rare but a crash can leave any
    garbage behind)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None
