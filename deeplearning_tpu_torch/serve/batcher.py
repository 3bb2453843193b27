"""Dynamic micro-batching: many concurrent requests, one device stream —
the port of ``deeplearning_tpu/serve/batcher.py``.

One dedicated dispatch thread owns the device; everything else talks to
it through per-model queues ("lanes"):

1. ``submit()`` runs admission control (backpressure/deadline stamping)
   against the TARGET model's lane, enqueues, and returns a
   ``SubmitHandle`` future.
2. The dispatch thread round-robins over lanes with waiting work (so
   one hot tenant cannot starve the rest), pops the first request, then
   accumulates same-model followers until the lane's largest bucket is
   full or ``max_wait_ms`` expires — light traffic dispatches
   immediately in the smallest bucket, bursts fill big buckets.
3. The batch is padded to its bucket, run through that model's engine
   (device outputs, no synchronisation), and demultiplexed: each
   request's future resolves to ITS row. Padding rows are sliced away
   here and never observable.

Two fronting modes share all of the above: ``MicroBatcher(engine)``
serves one model through one implicit lane, while
``MicroBatcher(zoo=...)`` serves every model a :class:`~.zoo.ModelZoo`
holds — ``submit(image, model=alias)`` routes to the tenant's lane, cold
tenants get a background hot-load kicked and their lane skipped until the
zoo's warm flag flips, and each lane owns its telemetry + admission
controller (per-model EWMA drain). A batch is bracketed by
``zoo.mark_dispatch`` so its engine is never evicted mid-run.

The resilience surface: ``drain()`` (new submits 429 "draining", queued
work still dispatches), a warm ``standby`` that refuses traffic until
``promote()``, and a per-tenant brownout ladder (``set_brownout``: step 1
pins the lane to its largest bucket, step 2 is the zoo's int8 demotion,
which the CLI drives, step 3 sheds one submit in four with reason
"brownout"). The batcher's fault hooks of ``elastic/faults.py`` (wedge,
injected 503 and latency) work as in JAX. Supervision: a ``heartbeat``
(``elastic.heartbeat.Heartbeat``) is touched ``("dispatch",
step=dispatched)`` after every dispatched batch, and the owner's
``on_preempt`` / ``on_crash`` callbacks run when a ``preempt_replica`` /
``crash_replica`` fault fires (consumed only once a callback is set, so a
spec cannot burn before the owner wires it).

The dispatch thread never waits on the card: demux hands out
(batch, row) pairs, and the FIRST ``result()`` of a batch pays one
device-to-host copy for the whole batch on the calling thread.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

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


class _Lane:
    """One model's wait queue + policy + counters. The deque is guarded
    by the batcher's condition variable; admission/telemetry objects are
    internally locked."""

    __slots__ = ("model", "q", "admission", "telemetry")

    def __init__(self, model: str, admission: AdmissionController,
                 telemetry: ServeTelemetry):
        self.model = model
        self.q: "collections.deque[_Request]" = collections.deque()
        self.admission = admission
        self.telemetry = telemetry


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
    materializes it on the CALLING thread (the D2H lands on the
    requester, keeping the dispatcher sync-free), recording e2e latency
    into telemetry exactly once (into the lane's AND the aggregate
    rings in zoo mode)."""

    def __init__(self, rid: int, future: Future, t_submit: float,
                 telemetry: Any):
        self.rid = rid
        self._future = future
        self._t_submit = t_submit
        if telemetry is None:
            telemetry = ()
        elif isinstance(telemetry, ServeTelemetry):
            telemetry = (telemetry,)
        self._telemetry = tuple(telemetry)
        self._recorded = False

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        shared, i = self._future.result(timeout)
        out = shared.row(i)
        if not self._recorded and self._telemetry:
            self._recorded = True
            e2e = time.perf_counter() - self._t_submit
            for t in self._telemetry:
                t.record_e2e_latency(e2e)
        return out

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)


class MicroBatcher:
    """Dynamic micro-batching front of one ``InferenceEngine`` or a
    whole ``ModelZoo``.

    - ``max_wait_ms``: how long the dispatcher holds an underfull batch
      open for followers before padding and going (the latency the
      lightest-traffic request pays for batching).
    - ``admission``: an ``AdmissionController``; single-engine mode
      defaults to one sized on the engine's buckets with ``max_queue``
      pending requests. Zoo mode ignores it — each tenant's controller
      comes from ``zoo.admission_for``.
    - Runs its dispatch thread from construction; ``close()`` (or the
      context manager) drains and stops it.
    """

    def __init__(self, engine=None, *, zoo=None,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = None,
                 admission: Optional[AdmissionController] = None,
                 telemetry: Optional[ServeTelemetry] = None,
                 heartbeat=None,
                 standby: bool = False,
                 start: bool = True):
        if (engine is None) == (zoo is None):
            raise ValueError("pass exactly one of engine= or zoo=")
        self.engine = engine
        self.zoo = zoo
        self.max_wait_s = max_wait_ms / 1e3
        self.telemetry = telemetry or ServeTelemetry()
        self._cv = threading.Condition()
        self._lanes: Dict[str, _Lane] = {}
        self._rr = 0                   # round-robin cursor over lanes
        if engine is not None:
            self.admission = admission or AdmissionController(
                engine.buckets, max_queue=max_queue,
                default_timeout_s=default_timeout_s,
                model=getattr(engine, "name", None))
            # the single-engine surface is one implicit lane sharing the
            # aggregate telemetry (so nothing records twice)
            self._default_lane = _Lane(
                getattr(engine, "name", "model"), self.admission,
                self.telemetry)
            self._lanes[self._default_lane.model] = self._default_lane
        else:
            self.admission = None
            self._default_lane = None
        # the activity watermark advances once a dispatched batch: the
        # liveness contract the Trainer gives its supervisor
        self._beat = heartbeat
        self.dispatched = 0            # batches the dispatch loop finished
        self._busy = False             # dispatch thread is inside a batch
        self._ids = itertools.count()
        self._stop = threading.Event()
        # drain() flips _draining: new submits 429 with reason="draining",
        # queued work still dispatches; on_preempt / on_crash, set by the
        # owning CLI, run once when a preempt_replica / crash_replica fault
        # targets this replica
        self._draining = threading.Event()
        self.on_preempt = None
        self.on_crash = None
        # resilience surface: a standby replica warms fully but refuses
        # traffic (healthz "standby") until promote(); brownout steps
        # per model degrade one hot tenant without touching the rest
        self._standby = threading.Event()
        if standby:
            self._standby.set()
        self._brownout: Dict[str, int] = {}     # model -> ladder step
        self._bo_count: Dict[str, int] = {}     # model -> submit ordinal
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
            return sum(len(lane.q) for lane in self._lanes.values())

    def lane_depth(self, model: str) -> int:
        with self._cv:
            lane = self._lanes.get(model)
            return len(lane.q) if lane is not None else 0

    def lane_telemetry(self, model: str) -> Optional[ServeTelemetry]:
        lane = self._lanes.get(model)
        return lane.telemetry if lane is not None else None

    @property
    def busy(self) -> bool:
        """True while the dispatch thread is inside a batch (collected
        but not yet demuxed) — a wedge detector must not call an
        in-flight batch idle."""
        return self._busy

    # ------------------------------------------------------------ drain
    def drain(self) -> None:
        """Stop ACCEPTING without stopping WORKING: new submits are
        rejected (429 reason="draining", retry elsewhere) while every
        already-queued request still dispatches — the graceful half of
        the controller's drain-and-requeue. Idempotent."""
        if not self._draining.is_set():
            self._draining.set()
            flight.record("serve_drain", depth=self.queue_depth)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def drained(self) -> bool:
        """True once a drain has fully flushed: draining was requested,
        the lanes are empty, and no batch is in flight."""
        return (self._draining.is_set() and not self._busy
                and self.queue_depth == 0)

    # ------------------------------------------------ standby/brownout
    @property
    def standby(self) -> bool:
        return self._standby.is_set()

    def promote(self) -> bool:
        """Flip a warm standby into rotation: healthz goes "standby" →
        "ready" on the next probe and submits are accepted immediately.
        The engine warmed at construction, so promotion costs a flag
        flip, not a warmup pass. True when this call did the flip."""
        if self._standby.is_set():
            self._standby.clear()
            flight.record("serve_promote", dispatched=self.dispatched)
            return True
        return False

    def set_brownout(self, model: str, step: int) -> int:
        """Set one tenant's degrade-ladder step (0 = full service).
        Step >= 1: the lane dispatches largest-bucket-only (max
        throughput posture). Step >= 3: additionally shed a fixed
        fraction of that lane's submits (deterministic 1-in-4, reason
        "brownout"). Step 2's int8-residency move belongs to the zoo —
        the serve CLI applies it when it owns one. Returns the step
        actually stored (clamped to [0, 3])."""
        step = max(0, min(int(step), 3))
        with self._cv:
            if step:
                self._brownout[model] = step
            else:
                self._brownout.pop(model, None)
                self._bo_count.pop(model, None)
        flight.record("serve_brownout", model=model, step=step)
        return step

    def brownout_step(self, model: str) -> int:
        with self._cv:
            return self._brownout.get(model, 0)

    # -------------------------------------------------------- lanes
    def _lane(self, model: Optional[str]) -> _Lane:
        if self._default_lane is not None:
            return self._default_lane
        if model is None:
            models = self.zoo.models()
            if len(models) != 1:
                raise ValueError(
                    f"zoo serves {models}; submit(model=...) required")
            model = models[0]
        lane = self._lanes.get(model)
        if lane is None:
            admission = self.zoo.admission_for(model)  # raises KeyError
            with self._cv:
                lane = self._lanes.get(model)
                if lane is None:
                    lane = _Lane(model, admission, ServeTelemetry())
                    self._lanes[model] = lane
        return lane

    def _tels(self, lane: _Lane) -> Tuple[ServeTelemetry, ...]:
        if lane.telemetry is self.telemetry:
            return (lane.telemetry,)
        return (lane.telemetry, self.telemetry)

    def _engine_for(self, lane: _Lane):
        """The lane's warm engine, or None (zoo lane still loading — the
        load was kicked at submit; the dispatcher just skips the lane)."""
        if self.engine is not None:
            return self.engine
        return self.zoo.engine(lane.model)

    # ----------------------------------------------------------- submit
    def submit(self, image, timeout_s: Optional[float] = None,
               model: Optional[str] = None) -> SubmitHandle:
        """Admit one request. Raises ``serve.Rejected`` on a full lane
        (backpressure, with the TARGET model's retry-after hint) or —
        zoo mode — when the model would need a load that memory pressure
        refuses; the returned handle's ``result()`` raises
        ``DeadlineExceeded`` if the request expired before dispatch.
        ``image`` must be one model-ready (image_size, image_size, 3)
        frame — resizing/normalizing is the client's job."""
        lane = self._lane(model)
        if self.engine is not None:
            size = self.engine.image_size
        else:
            size = self.zoo.image_size(lane.model)
        image = np.asarray(image, np.float32)
        if image.shape != (size, size, 3):
            raise ValueError(f"request image shape {image.shape} != "
                             f"({size}, {size}, 3); resize client-side")
        try:
            if self._standby.is_set():
                # a standby is warm but OUT of rotation — a request
                # reaching it is a routing error, not load to absorb
                raise Rejected(len(lane.q), 0.0, model=lane.model,
                               reason="standby")
            if self._draining.is_set():
                # a draining replica refuses new work outright — no
                # retry_after hint would help; the caller must reroute
                raise Rejected(len(lane.q), 0.0, model=lane.model,
                               reason="draining")
            if faults.consume("e503", "submit", self.dispatched):
                # seeded chaos: one injected 503 — exercises router
                # failover and the per-replica breaker for real
                raise Rejected(len(lane.q), 0.0, model=lane.model,
                               reason="injected")
            if self.brownout_step(lane.model) >= 3:
                n = 0
                with self._cv:
                    n = self._bo_count.get(lane.model, 0) + 1
                    self._bo_count[lane.model] = n
                if n % 4 == 0:
                    raise Rejected(
                        len(lane.q),
                        lane.admission.retry_after_s(len(lane.q)),
                        model=lane.model, reason="brownout")
            if self.zoo is not None:
                # warm fast-path: dict lookup. Cold: kicks a background
                # hot-load (may LRU-evict; raises Rejected on pressure)
                self.zoo.request(lane.model)
            lane.admission.admit(len(lane.q))
        except Exception:
            for t in self._tels(lane):
                t.record_reject()
            flight.record("serve_reject", model=lane.model,
                          depth=len(lane.q))
            raise
        now = time.perf_counter()
        req = _Request(next(self._ids), image, Future(),
                       lane.admission.deadline_for(timeout_s, now), now)
        for t in self._tels(lane):
            t.record_submit()
        with self._cv:
            lane.q.append(req)
            self._cv.notify_all()
        return SubmitHandle(req.rid, req.future, now, self._tels(lane))

    # --------------------------------------------------------- dispatch
    def _expire(self, lane: _Lane, req: _Request, now: float) -> bool:
        """Cancel a request whose deadline passed BEFORE spending device
        time on it; True when the request was dropped."""
        if lane.admission.expired(req.deadline, now):
            req.future.set_exception(DeadlineExceeded(
                f"request {req.rid} expired after "
                f"{now - req.t_submit:.3f}s in queue"))
            for t in self._tels(lane):
                t.record_timeout()
            return True
        return False

    def _purge_expired(self, lane: _Lane) -> None:
        """Deadline enforcement for a lane whose engine is still
        warming: expired requests fail now, not after the load."""
        now = time.perf_counter()
        with self._cv:
            keep = collections.deque()
            for req in lane.q:
                if not self._expire(lane, req, now):
                    keep.append(req)
            lane.q = keep

    def _pick_lane(self) -> Optional[Tuple[_Lane, Any]]:
        """Wait (≤50ms) for any lane with work, then round-robin to the
        next one whose engine is ready. Lanes of still-loading models
        are skipped (their hot-load is already running); round-robin
        across ready lanes is the anti-starvation guarantee — a
        saturated tenant gets one batch per turn, not the whole
        thread."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._stop.is_set()
                or any(lane.q for lane in self._lanes.values()),
                timeout=0.05)
            if self._stop.is_set():
                return None
            names: List[str] = [name for name, lane
                                in self._lanes.items() if lane.q]
        if not names:
            return None
        order = sorted(names)
        start = self._rr % len(order)
        cold = []
        for name in order[start:] + order[:start]:
            lane = self._lanes[name]
            engine = self._engine_for(lane)
            if engine is None:
                cold.append(lane)
                continue
            if lane.q:
                self._rr += 1
                return lane, engine
        for lane in cold:
            self._purge_expired(lane)
        if cold:
            # every pending lane is warming: don't spin on the CV (the
            # warm flag flips without a notify) — nap one poll tick
            self._stop.wait(0.01)
        return None

    def _collect(self, lane: _Lane, engine) -> list:
        """Pop one request from the lane, then hold the batch open for
        same-model followers until the LARGEST bucket fills or
        ``max_wait_ms`` expires — a burst rides one big bucket, a
        lone request pays at most ``max_wait_ms`` extra latency before
        going out in bucket 1."""
        with self._cv:
            if not lane.q:
                return []
            first = lane.q.popleft()
        t0 = time.perf_counter()
        batch = [] if self._expire(lane, first, t0) else [first]
        wait_until = t0 + self.max_wait_s
        big = engine.buckets[-1]
        while len(batch) < big:
            remaining = wait_until - time.perf_counter()
            if remaining <= 0:
                break
            with self._cv:
                if not lane.q:
                    self._cv.wait(timeout=remaining)
                if not lane.q:
                    continue            # spurious/other-lane wakeup
                req = lane.q.popleft()
            if not self._expire(lane, req, time.perf_counter()):
                batch.append(req)
        return batch

    def _poll_faults(self) -> None:
        """The replica faults, polled once per dispatch-loop iteration.
        ``wedge_replica`` freezes THIS thread, so ``dispatched`` stops with
        work queued — the signature ``DispatchWatch`` classifies.
        ``preempt_replica`` and ``crash_replica`` hand control to the
        owner's callbacks, and are consumed only once one is set."""
        if faults.consume("wedge_replica", "step", self.dispatched):
            deadline = time.monotonic() + faults.WEDGE_SLEEP_S
            while (not self._stop.is_set()
                   and time.monotonic() < deadline):
                self._stop.wait(0.25)
        cb = self.on_preempt
        if cb is not None and faults.consume(
                "preempt_replica", "step", self.dispatched):
            cb()
        cb = self.on_crash
        if cb is not None and faults.consume(
                "crash_replica", "step", self.dispatched):
            cb()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            self._poll_faults()
            picked = self._pick_lane()
            if picked is None:
                continue
            lane, engine = picked
            batch = self._collect(lane, engine)
            if not batch:
                continue
            self._busy = True
            try:
                self._dispatch_one(lane, engine, batch)
            finally:
                # count the batch whether it ran or errored — both mean
                # the dispatch thread is ALIVE (what a wedge probe asks)
                self._busy = False
                self.dispatched += 1
                if self._beat is not None:
                    self._beat.touch("dispatch", step=self.dispatched)

    def _dispatch_one(self, lane: _Lane, engine, batch: list) -> None:
        t0 = time.perf_counter()
        depth = len(lane.q)
        # brownout step >= 1 pins the lane to its max-throughput
        # posture (largest bucket) even before admission sheds
        shed = (lane.admission.overloaded(depth)
                or self.brownout_step(lane.model) >= 1)
        bucket = (engine.buckets[-1] if shed
                  else engine.bucket_for(len(batch)))
        lat_ms = faults.consume_arg("latency", "step", self.dispatched)
        if lat_ms:
            # seeded chaos: injected tail latency — the stimulus the
            # router's hedging policy exists to absorb
            time.sleep(lat_ms / 1e3)
        if self.zoo is not None:
            self.zoo.mark_dispatch(lane.model, +1)
        try:
            with span("serve/dispatch", model=lane.model, bucket=bucket,
                      n=len(batch), depth=depth, shed=shed):
                padded = engine.pad_to_bucket(
                    np.stack([r.image for r in batch]), bucket)
                out = engine.run(bucket, padded)
        except BaseException as exc:  # noqa: BLE001 - to the futures
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return
        finally:
            if self.zoo is not None:
                self.zoo.mark_dispatch(lane.model, -1)
        now = time.perf_counter()
        shared = _SharedBatch(out)
        tels = self._tels(lane)
        for i, r in enumerate(batch):
            # hand each request its row of the shared device batch —
            # no sync here; the first result() call materializes once
            r.future.set_result((shared, i))
            for t in tels:
                t.record_dispatch_latency(now - r.t_submit)
        for t in tels:
            t.record_batch(bucket, len(batch), len(lane.q), shed)
        # per-model EWMA: the drain estimate behind retry_after quotes
        # THIS tenant's dispatch history (the TenantAdmission bugfix)
        lane.admission.note_drained(len(batch), now - t0)
