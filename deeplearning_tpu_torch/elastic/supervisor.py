"""Wedge detection, copied out of ``deeplearning_tpu/elastic/supervisor.py``.

Only ``WedgeDetector`` is here: the serving health check
(``serve/health.DispatchWatch``) classifies a frozen dispatch stream
with it. The run supervisor itself (launch, requeue) comes with ROADMAP
Queue 1 item 8c.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..obs import threads as obs_threads

__all__ = ["WedgeDetector"]


class WedgeDetector:
    """Slow-vs-wedged classifier over (step, activity) watermarks.

    ``observe(step, activity)`` returns ``"ok"`` when either watermark
    moved, ``"slow"`` when activity moves but step doesn't, ``"wedged"``
    once NEITHER has moved for ``deadline_s``. The distinction is the
    whole point: a 10-minute compile is slow (spans still tick); a dead
    device tunnel is wedged (the host thread never comes back).
    """

    def __init__(self, deadline_s: float):
        self.deadline_s = float(deadline_s)
        self._step: Optional[int] = None
        self._activity: Optional[int] = None
        self._step_at = time.monotonic()
        self._moved_at = time.monotonic()

    def reset(self) -> None:
        self._step = None
        self._activity = None
        self._step_at = time.monotonic()
        self._moved_at = time.monotonic()

    def observe(self, step: Optional[int], activity: Optional[int],
                now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        moved = False
        if step is not None and step != self._step:
            self._step, self._step_at, moved = step, now, True
        if activity is not None and activity != self._activity:
            self._activity, moved = activity, True
        if moved:
            self._moved_at = now
            return "ok" if self._step_at == now else "slow"
        if now - self._moved_at >= self.deadline_s:
            return "wedged"
        return "slow" if now - self._step_at > now - self._moved_at else "ok"

    def stalled_for(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return now - self._moved_at

    # ------------------------------------------------- in-process watch
    def watch(self, activity_fn: Callable[[], int],
              on_wedge: Callable[[float], None], *,
              poll_s: float = 1.0,
              stop: Optional[threading.Event] = None,
              name: str = "wedge-watch") -> threading.Thread:
        """Background thread flavor for in-process use (bench.py health
        probes): poll ``activity_fn()`` and call ``on_wedge(stalled_s)``
        once when it freezes past the deadline. ``stop.set()`` ends the
        watch — the happy path never fires the callback."""
        stop = stop or threading.Event()
        self.reset()

        def _run() -> None:
            while not stop.wait(min(poll_s, self.deadline_s / 2)):
                try:
                    verdict = self.observe(None, int(activity_fn()))
                except Exception:  # noqa: BLE001 - probe itself died
                    verdict = "wedged"
                if verdict == "wedged":
                    try:
                        on_wedge(self.stalled_for())
                    except Exception:  # noqa: BLE001
                        pass
                    return

        thread = obs_threads.spawn(_run, name=name, daemon=True,
                                   start=False)
        thread.stop = stop  # type: ignore[attr-defined]
        thread.start()
        return thread
