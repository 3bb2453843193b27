"""Admission control: bounded queues, deadlines, and overload shedding.

A serving queue with no admission policy converts overload into
unbounded latency — every request is eventually served, long after its
caller stopped waiting. This module makes the three overload decisions
explicit and testable, decoupled from the batcher mechanics:

- **Backpressure**: the queue has a hard depth bound. A submit against a
  full queue raises ``Rejected`` carrying a ``retry_after_s`` hint
  (estimated from the recent drain rate) instead of enqueueing — the
  client sees a fast 429, not a slow timeout.
- **Deadlines**: every request may carry an absolute deadline. The
  dispatcher drops expired requests *before* padding them into an
  executable (``DeadlineExceeded`` on the future) — device cycles are
  never spent on an answer nobody is waiting for.
- **Degradation**: past ``shed_threshold`` queued requests the policy
  stops optimizing latency and targets the LARGEST batch bucket only
  (max throughput per dispatch), reporting the shed via telemetry so
  operators see the mode switch, not just a p99 cliff.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

__all__ = ["Ewma", "AdmissionController", "TenantAdmission", "Rejected",
           "DeadlineExceeded"]


class Ewma:
    """Exponentially-weighted moving average with first-sample seeding:
    the first ``update`` sets the value outright, later ones fold in at
    ``alpha`` — the "sustained, not instantaneous" smoothing used for
    the admission drain rate and the fleet controller's scaling signals
    (one smoothing rule, one set of tests)."""

    __slots__ = ("alpha", "value", "samples")

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.value = 0.0
        self.samples = 0

    def update(self, sample: float) -> float:
        sample = float(sample)
        self.value = (sample if self.samples == 0
                      else (1.0 - self.alpha) * self.value
                      + self.alpha * sample)
        self.samples += 1
        return self.value

    def reset(self) -> None:
        self.value = 0.0
        self.samples = 0


class Rejected(Exception):
    """Queue-full backpressure: retry after ``retry_after_s`` seconds.

    ``model`` names the tenant whose queue rejected the request (None in
    single-model serving); ``reason`` distinguishes a full per-model
    queue (``"queue_full"``) from zoo capacity pressure with nothing
    evictable (``"hbm_pressure"``). Both surface in the 429 body."""

    def __init__(self, depth: int, retry_after_s: float,
                 model: Optional[str] = None,
                 reason: str = "queue_full"):
        self.depth = depth
        self.retry_after_s = retry_after_s
        self.model = model
        self.reason = reason
        who = f"model {model!r} " if model else ""
        super().__init__(
            f"serve {who}{reason.replace('_', ' ')} ({depth} pending); "
            f"retry after {retry_after_s:.3f}s")


class DeadlineExceeded(Exception):
    """The request's deadline passed while it waited in the queue."""


class AdmissionController:
    """Pure policy object consulted by the batcher (no threads, no
    queue ownership — everything takes the observed depth as input, so
    tests drive it directly).

    - ``max_queue``: hard pending-request bound (backpressure trigger).
    - ``shed_threshold``: depth at which batching degrades to
      largest-bucket-only dispatch (default: the largest bucket — once a
      full max-throughput batch is waiting, padding smaller buckets only
      burns cycles).
    - ``default_timeout_s``: deadline applied to requests that don't
      carry one (None = wait forever).
    """

    def __init__(self, buckets: Sequence[int], *, max_queue: int = 256,
                 shed_threshold: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 model: Optional[str] = None):
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("admission needs at least one batch bucket")
        self.max_queue = int(max_queue)
        self.shed_threshold = (int(shed_threshold) if shed_threshold
                               is not None else self.buckets[-1])
        self.default_timeout_s = default_timeout_s
        self.model = model
        # drain-rate estimate for retry_after hints (EWMA of req/s seen
        # at each dispatch; updated by the batcher). Per-controller
        # state: in multi-tenant serving every model owns one controller
        # (see TenantAdmission), so a 429's retry_after always quotes
        # the TARGET model's drain — never a hotter neighbor's.
        self._drain = Ewma(alpha=0.2)

    # ----------------------------------------------------- backpressure
    def admit(self, queue_depth: int) -> None:
        """Raise ``Rejected`` when the queue cannot take one more."""
        if queue_depth >= self.max_queue:
            raise Rejected(queue_depth, self.retry_after_s(queue_depth),
                           model=self.model)

    @property
    def _drain_rate(self) -> float:
        return self._drain.value

    def retry_after_s(self, queue_depth: int) -> float:
        """Time until the backlog plausibly has room: depth over the
        observed drain rate, clamped to a sane hint window."""
        if self._drain_rate > 0:
            return min(max(queue_depth / self._drain_rate, 1e-3), 30.0)
        return 0.05     # no throughput observed yet: cheap quick retry

    def note_drained(self, n: int, seconds: float) -> None:
        """EWMA drain-rate update from the batcher: ``n`` requests left
        the queue over ``seconds`` of dispatch."""
        if seconds <= 0:
            return
        self._drain.update(n / seconds)

    # -------------------------------------------------------- deadlines
    def deadline_for(self, timeout_s: Optional[float],
                     now: Optional[float] = None) -> Optional[float]:
        """Absolute deadline for a new request (None = no deadline)."""
        timeout_s = (timeout_s if timeout_s is not None
                     else self.default_timeout_s)
        if timeout_s is None:
            return None
        return (now if now is not None else time.perf_counter()) \
            + timeout_s

    @staticmethod
    def expired(deadline: Optional[float],
                now: Optional[float] = None) -> bool:
        if deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            >= deadline

    # ------------------------------------------------------ degradation
    def overloaded(self, queue_depth: int) -> bool:
        return queue_depth >= self.shed_threshold

    def target_bucket(self, queue_depth: int) -> int:
        """Batch size the dispatcher should accumulate toward. Normal
        mode: the smallest bucket admitting the current backlog (+1 for
        the request already popped), so light traffic dispatches
        immediately at small buckets. Overload: the largest bucket only."""
        if self.overloaded(queue_depth):
            return self.buckets[-1]
        want = queue_depth + 1
        for b in self.buckets:
            if b >= want:
                return b
        return self.buckets[-1]


class TenantAdmission:
    """Per-tenant admission for multi-model serving: one
    :class:`AdmissionController` per model, each with its own queue
    quota, shed threshold, deadline default — and its own EWMA drain
    rate, which is the bugfix over sharing one controller: a cold
    tenant's ``Rejected.retry_after_s`` is computed from that tenant's
    OWN drain history, not from whichever hot neighbor last dispatched.

    ``configure`` registers a model's policy (the zoo does this at
    ``register`` time); ``for_model`` is the per-request lookup, falling
    back to a default-policy controller for unconfigured models so bare
    batcher usage keeps working."""

    def __init__(self, *, default_buckets: Sequence[int] = (1, 8, 32, 128),
                 default_max_queue: int = 256,
                 default_timeout_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._controllers: Dict[str, AdmissionController] = {}
        self.default_buckets = tuple(sorted(int(b)
                                            for b in default_buckets))
        self.default_max_queue = int(default_max_queue)
        self.default_timeout_s = default_timeout_s

    def configure(self, model: str, buckets: Sequence[int], *,
                  max_queue: Optional[int] = None,
                  shed_threshold: Optional[int] = None,
                  default_timeout_s: Optional[float] = None
                  ) -> AdmissionController:
        ctrl = AdmissionController(
            buckets,
            max_queue=(max_queue if max_queue is not None
                       else self.default_max_queue),
            shed_threshold=shed_threshold,
            default_timeout_s=(default_timeout_s
                               if default_timeout_s is not None
                               else self.default_timeout_s),
            model=model)
        with self._lock:
            self._controllers[model] = ctrl
        return ctrl

    def for_model(self, model: str) -> AdmissionController:
        ctrl = self._controllers.get(model)      # GIL-safe fast path
        if ctrl is None:
            with self._lock:
                ctrl = self._controllers.get(model)
            if ctrl is None:
                ctrl = self.configure(model, self.default_buckets)
        return ctrl

    def models(self) -> Dict[str, AdmissionController]:
        with self._lock:
            return dict(self._controllers)
