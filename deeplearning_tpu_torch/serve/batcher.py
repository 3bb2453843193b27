"""Dynamic micro-batching: many concurrent requests, one device stream.

The port of ``deeplearning_tpu/serve/batcher.py``, single-engine lane.
One dedicated dispatch thread owns the device; everything else talks to
it through one queue:

1. ``submit()`` runs admission control (backpressure/deadline stamping),
   enqueues, and returns a ``SubmitHandle`` future.
2. The dispatch thread pops the first request, then accumulates
   followers until the largest bucket is full or ``max_wait_ms``
   expires — light traffic dispatches at once in the smallest bucket,
   bursts fill big buckets. Past the admission shed threshold it pads to
   the largest bucket only.
3. The batch is padded to its bucket, run through the engine (device
   outputs, no synchronisation), and demultiplexed: each request's future
   resolves to ITS row. Padding rows are sliced away here.

The dispatch thread never waits on the card: demux hands out
(batch, row) pairs, and the FIRST ``result()`` of a batch pays one
device-to-host copy for the whole batch on the calling thread.

Multi-model lanes (the zoo), brownout, warm standby and the CLI's
preempt/crash fault callbacks come with the zoo slice; the batcher's own
fault hooks from ``elastic/faults.py`` (wedge, injected 503 and latency)
work as in JAX.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np

from ..elastic import faults
from ..obs import flight
from ..obs import threads as obs_threads
from ..obs.spans import span
from .admission import AdmissionController, DeadlineExceeded, Rejected
from .telemetry import ServeTelemetry

__all__ = ["MicroBatcher", "SubmitHandle"]


class _Request:
    __slots__ = ("rid", "image", "future", "deadline", "t_submit")

    def __init__(self, rid, image, future, deadline, t_submit):
        self.rid = rid
        self.image = image
        self.future = future
        self.deadline = deadline
        self.t_submit = t_submit


class _SharedBatch:
    """One dispatched batch's DEVICE output (a tensor, or a detection dict
    of tensors) with a lazily-cached host copy: the first requester pays
    one copy a tensor for the whole batch, every other row rides the
    cache. A dict demuxes per key, as the JAX batcher's ``tree.map``."""

    __slots__ = ("_device", "_host", "_lock")

    def __init__(self, device_out: Any):
        self._device = device_out
        self._host = None
        self._lock = threading.Lock()

    def row(self, i: int) -> Any:
        with self._lock:
            if self._host is None:
                out = self._device
                self._host = ({k: v.cpu().numpy() for k, v in out.items()}
                              if isinstance(out, dict)
                              else out.cpu().numpy())
                self._device = None     # free device memory once copied
        if isinstance(self._host, dict):
            return {k: v[i] for k, v in self._host.items()}
        return self._host[i]


class SubmitHandle:
    """Per-request future. ``result()`` blocks for the demuxed row and
    materialises it on the CALLING thread, recording e2e latency into
    telemetry exactly once."""

    def __init__(self, rid: int, future: Future, t_submit: float,
                 telemetry: Optional[ServeTelemetry]):
        self.rid = rid
        self._future = future
        self._t_submit = t_submit
        self._telemetry = telemetry
        self._recorded = False

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        shared, i = self._future.result(timeout)
        out = shared.row(i)
        if not self._recorded and self._telemetry is not None:
            self._recorded = True
            self._telemetry.record_e2e_latency(
                time.perf_counter() - self._t_submit)
        return out

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)


class MicroBatcher:
    """Dynamic micro-batching front of one ``InferenceEngine``.

    - ``max_wait_ms``: how long the dispatcher holds an underfull batch
      open for followers before padding and going.
    - ``admission``: an ``AdmissionController``; defaults to one sized on
      the engine's buckets with ``max_queue`` pending requests.
    - Runs its dispatch thread from construction; ``close()`` (or the
      context manager) stops it.
    """

    def __init__(self, engine, *,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = None,
                 admission: Optional[AdmissionController] = None,
                 telemetry: Optional[ServeTelemetry] = None,
                 start: bool = True):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1e3
        self.telemetry = telemetry or ServeTelemetry()
        self.admission = admission or AdmissionController(
            engine.buckets, max_queue=max_queue,
            default_timeout_s=default_timeout_s,
            model=getattr(engine, "name", None))
        self._cv = threading.Condition()
        self._q: "collections.deque[_Request]" = collections.deque()
        self.dispatched = 0            # batches the dispatch loop finished
        self._busy = False             # dispatch thread is inside a batch
        self._ids = itertools.count()
        self._stop = threading.Event()
        # drain() flips _draining: new submits 429 with reason="draining",
        # queued work still dispatches
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = obs_threads.spawn(
                self._dispatch_loop, name="serve-dispatch", daemon=True)

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def busy(self) -> bool:
        """True while the dispatch thread is inside a batch (collected
        but not yet demuxed) — a wedge detector must not call an
        in-flight batch idle."""
        return self._busy

    # ------------------------------------------------------------ drain
    def drain(self) -> None:
        """Stop ACCEPTING without stopping WORKING: new submits are
        rejected (429 reason="draining") while every queued request still
        dispatches. Idempotent."""
        if not self._draining.is_set():
            self._draining.set()
            flight.record("serve_drain", depth=self.queue_depth)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def drained(self) -> bool:
        """True once a drain has fully flushed: draining was requested,
        the queue is empty, and no batch is in flight."""
        return (self._draining.is_set() and not self._busy
                and self.queue_depth == 0)

    # ----------------------------------------------------------- submit
    def submit(self, image, timeout_s: Optional[float] = None
               ) -> SubmitHandle:
        """Admit one request. Raises ``Rejected`` on a full queue
        (backpressure, with a retry-after hint) or while draining; the
        handle's ``result()`` raises ``DeadlineExceeded`` if the request
        expired before dispatch. ``image`` is one model-ready
        (image_size, image_size, 3) frame."""
        size = self.engine.image_size
        image = np.asarray(image, np.float32)
        if image.shape != (size, size, 3):
            raise ValueError(f"request image shape {image.shape} != "
                             f"({size}, {size}, 3); resize client-side")
        depth = self.queue_depth
        try:
            if self._draining.is_set():
                raise Rejected(depth, 0.0, model=self.admission.model,
                               reason="draining")
            if faults.consume("e503", "submit", self.dispatched):
                raise Rejected(depth, 0.0, model=self.admission.model,
                               reason="injected")
            self.admission.admit(depth)
        except Exception:
            self.telemetry.record_reject()
            flight.record("serve_reject", depth=depth)
            raise
        now = time.perf_counter()
        req = _Request(next(self._ids), image, Future(),
                       self.admission.deadline_for(timeout_s, now), now)
        self.telemetry.record_submit()
        with self._cv:
            self._q.append(req)
            self._cv.notify_all()
        return SubmitHandle(req.rid, req.future, now, self.telemetry)

    # --------------------------------------------------------- dispatch
    def _expire(self, req: _Request, now: float) -> bool:
        """Cancel a request whose deadline passed BEFORE spending device
        time on it; True when the request was dropped."""
        if self.admission.expired(req.deadline, now):
            req.future.set_exception(DeadlineExceeded(
                f"request {req.rid} expired after "
                f"{now - req.t_submit:.3f}s in queue"))
            self.telemetry.record_timeout()
            return True
        return False

    def _collect(self) -> list:
        """Wait (≤50ms) for a first request, then hold the batch open for
        followers until the LARGEST bucket fills or ``max_wait_ms``
        expires."""
        with self._cv:
            self._cv.wait_for(lambda: self._stop.is_set() or self._q,
                              timeout=0.05)
            if self._stop.is_set() or not self._q:
                return []
            first = self._q.popleft()
        t0 = time.perf_counter()
        batch = [] if self._expire(first, t0) else [first]
        wait_until = t0 + self.max_wait_s
        big = self.engine.buckets[-1]
        while len(batch) < big:
            remaining = wait_until - time.perf_counter()
            if remaining <= 0:
                break
            with self._cv:
                if not self._q:
                    self._cv.wait(timeout=remaining)
                if not self._q:
                    continue            # spurious wakeup
                req = self._q.popleft()
            if not self._expire(req, time.perf_counter()):
                batch.append(req)
        return batch

    def _poll_faults(self) -> None:
        """The ``wedge_replica`` fault, polled once per dispatch-loop
        iteration: it freezes THIS thread, so ``dispatched`` stops with
        work queued — the signature ``DispatchWatch`` classifies."""
        if faults.consume("wedge_replica", "step", self.dispatched):
            deadline = time.monotonic() + faults.WEDGE_SLEEP_S
            while (not self._stop.is_set()
                   and time.monotonic() < deadline):
                self._stop.wait(0.25)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            self._poll_faults()
            batch = self._collect()
            if not batch:
                continue
            self._busy = True
            try:
                self._dispatch_one(batch)
            finally:
                # count the batch whether it ran or errored — both mean
                # the dispatch thread is ALIVE (what a wedge probe asks)
                self._busy = False
                self.dispatched += 1

    def _dispatch_one(self, batch: list) -> None:
        engine = self.engine
        t0 = time.perf_counter()
        depth = self.queue_depth
        shed = self.admission.overloaded(depth)
        bucket = (engine.buckets[-1] if shed
                  else engine.bucket_for(len(batch)))
        lat_ms = faults.consume_arg("latency", "step", self.dispatched)
        if lat_ms:
            time.sleep(lat_ms / 1e3)    # injected tail latency
        try:
            with span("serve/dispatch", bucket=bucket, n=len(batch),
                      depth=depth, shed=shed):
                padded = engine.pad_to_bucket(
                    np.stack([r.image for r in batch]), bucket)
                out = engine.run(bucket, padded)
        except BaseException as exc:  # noqa: BLE001 - to the futures
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return
        now = time.perf_counter()
        shared = _SharedBatch(out)
        for i, r in enumerate(batch):
            r.future.set_result((shared, i))
            self.telemetry.record_dispatch_latency(now - r.t_submit)
        self.telemetry.record_batch(bucket, len(batch), self.queue_depth,
                                    shed)
        self.admission.note_drained(len(batch), now - t0)
