"""Overlapped device feed: a threaded host-to-card prefetch stage — the
port of ``deeplearning_tpu/data/device_prefetch.py``.

``DevicePrefetcher`` wraps any loader and moves each batch to the card on
a background thread, behind a bounded queue of ``depth`` batches, so
batch k+1's fetch and copy overlap step k. It keeps the loader protocol
(``__len__``, ``set_epoch``, ``reseed``, ``element_spec``,
``last_data_wait``) and the JAX prefetcher's: ``start()`` begins the
current epoch early, a worker's exception is re-raised on the consumer
with its original traceback, an early ``break`` shuts the thread down,
and ``stats()`` / ``reset_stats()`` report the feed. On a CUDA device
the prefetcher reads a loader's ``host_batches()`` where it has one (a
``DataLoader``), so each batch moves once, on the worker, and the loader
itself is left as it was.

On a CUDA device the copy is the reference's YOLOX ``DataPrefetcher``
(SURVEY §3.4): each host leaf is written into a **pinned** staging buffer
and copied with ``non_blocking=True`` on a **side stream**, and an event
recorded after the copies travels with the batch. The consumer's stream
waits on that event (no host wait), and every handed-over tensor is
``record_stream``-ed on the consumer's stream, so the caching allocator
does not give its memory back to the side stream while the step still
reads it. A staging buffer is refilled only after its last copy's event
has completed (polled, so the worker never blocks the card). A CPU
device, or none, passes batches through unchanged; on CUDA there is no
fallback to a synchronous copy.

Telemetry (feeds the Trainer's ``feed/*`` scalars and ``throughput``):
- ``last_data_wait`` / ``data_wait_total``: time the consumer blocked on
  the queue (true feed starvation);
- ``h2d_wait_total``: worker time staging and issuing copies;
- ``occupancy_mean``: queue depth seen at each get (near ``depth``: the
  feed keeps up; near 0: input-bound).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..obs import spans
from ..obs import threads as obs_threads

__all__ = ["DevicePrefetcher"]

_END = object()          # producer exhausted its epoch normally
_SLOTS = 2               # pinned staging buffers: fill one, copy the other
_POLL_S = 1e-4


class _WorkerError:
    """Exception carrier: re-raised on the consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Slot:
    """One set of pinned staging buffers (by leaf name) and the event of
    the last copies out of them."""

    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None


class DevicePrefetcher:
    """Bounded background-thread device feed wrapping any loader.

    - ``depth``: most batches on the card ahead of the consumer.
    - Batches go to the wrapped loader's ``device``; none, or a CPU
      device, passes the loader's batches through unchanged.
    """

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = max(int(depth), 1)
        device = getattr(loader, "device", None)
        self.device = None if device is None else torch.device(device)
        self._cuda = self.device is not None and self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.epoch = getattr(loader, "epoch", 0)
        self._stream: Optional[torch.cuda.Stream] = None   # made at start
        self.last_data_wait: Optional[float] = None
        self.data_wait_total = 0.0
        self.h2d_wait_total = 0.0
        self.source_wait_total = 0.0
        self.batches_fed = 0
        self._occ_sum = 0
        self._occ_n = 0
        self._active: Optional[Dict[str, Any]] = None   # started pipeline

    # ------------------------------------------------- loader protocol
    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)
        # a pipeline started for another epoch is stale: discard it
        if self._active is not None and self._active["epoch"] != epoch:
            self._shutdown(self._active)
            self._active = None

    def element_spec(self):
        """The wrapped loader's batch spec (None without one)."""
        fn = getattr(self.loader, "element_spec", None)
        return fn() if fn is not None else None

    def reseed(self, salt: int) -> None:
        """Reseed the wrapped loader and discard a started pipeline: its
        batches came from the old permutation."""
        fn = getattr(self.loader, "reseed", None)
        if fn is not None:
            fn(salt)
        if self._active is not None:
            self._shutdown(self._active)
            self._active = None

    # ---------------------------------------------------- device place
    def _to_device(self, batch: Dict[str, Any], slot: _Slot):
        """Stage ``batch`` into ``slot``'s pinned buffers and issue the
        copies on the side stream; returns (device batch, copy event, the
        names of the leaves that were copied)."""
        if not self._cuda:
            return batch, None, ()
        if slot.event is not None:
            # refill only after the slot's previous copies have landed;
            # polled, so nothing here counts as a synchronising call
            while not slot.event.query():
                time.sleep(_POLL_S)
        out, copied = {}, []
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if isinstance(v, torch.Tensor) and v.device == self.device:
                    out[k] = v                 # already there: no copy
                    continue
                host = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.ascontiguousarray(v))
                buf = slot.bufs.get(k)
                if buf is None or buf.shape != host.shape or \
                        buf.dtype != host.dtype:
                    buf = torch.empty(host.shape, dtype=host.dtype,
                                      pin_memory=True)
                    slot.bufs[k] = buf
                buf.copy_(host)
                out[k] = buf.to(self.device, non_blocking=True)
                copied.append(k)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return out, event, tuple(copied)

    # -------------------------------------------------------- pipeline
    def _worker(self, it, q: "queue.Queue", stop: threading.Event) -> None:
        # staging buffers of this pipeline only: a stale pipeline's thread
        # may still finish a batch after a new one started
        slots = [_Slot() for _ in range(_SLOTS)]
        try:
            n = 0
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                item = self._to_device(batch, slots[n % _SLOTS])
                n += 1
                t2 = time.perf_counter()
                self.source_wait_total += t1 - t0
                self.h2d_wait_total += t2 - t1
                tracer = spans.get_tracer()
                if tracer is not None:
                    tracer.record("feed/fetch", t0, t1 - t0)
                    tracer.record("feed/h2d", t1, t2 - t1)
                while not stop.is_set():           # bounded, responsive put
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            if not stop.is_set():
                q.put(_END)
        except BaseException as exc:  # noqa: BLE001 - relayed to consumer
            # the same responsive put: a crash is re-raised by the
            # consumer with exc.__traceback__, never dropped on a full queue
            while not stop.is_set():
                try:
                    q.put(_WorkerError(exc), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self) -> None:
        """Start producing the current epoch's batches now; ``__iter__``
        then consumes this pipeline instead of starting another."""
        if self._active is None:
            self._active = self._start()

    def _start(self) -> Dict[str, Any]:
        if self._cuda and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        host = getattr(self.loader, "host_batches", None)
        it = host() if self._cuda and host is not None else iter(self.loader)
        thread = obs_threads.spawn(
            self._worker, args=(it, q, stop),
            name="device-prefetch", daemon=True)
        return {"queue": q, "stop": stop, "thread": thread,
                "epoch": self.epoch}

    @staticmethod
    def _shutdown(pipe: Dict[str, Any]) -> None:
        pipe["stop"].set()
        try:                      # unblock a producer stuck in put()
            while True:
                pipe["queue"].get_nowait()
        except queue.Empty:
            pass
        pipe["thread"].join(timeout=5.0)

    def _hand_over(self, item) -> Dict[str, Any]:
        """The consumer's side of a copied batch: its stream waits on the
        copy event, and each copied tensor is marked as used there."""
        batch, event, copied = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for k in copied:
                batch[k].record_stream(stream)
        return batch

    def __iter__(self) -> Iterator[Any]:
        pipe, self._active = (self._active or self._start()), None
        q = pipe["queue"]
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.last_data_wait = time.perf_counter() - t0
                self.data_wait_total += self.last_data_wait
                if item is _END:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                self._occ_sum += q.qsize()
                self._occ_n += 1
                self.batches_fed += 1
                yield self._hand_over(item)
        finally:
            self._shutdown(pipe)

    # ------------------------------------------------------- telemetry
    @property
    def occupancy_mean(self) -> float:
        """Mean queue depth seen at each consumer get (0..depth)."""
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    def stats(self) -> Dict[str, float]:
        """Feed telemetry snapshot."""
        busy = self.source_wait_total + self.h2d_wait_total
        return {
            "prefetch_depth": float(self.depth),
            "prefetch_occupancy": self.occupancy_mean,
            "batches_fed": float(self.batches_fed),
            "data_wait_total": self.data_wait_total,
            "h2d_wait_total": self.h2d_wait_total,
            "h2d_wait_frac": (self.h2d_wait_total / busy) if busy else 0.0,
        }

    def reset_stats(self) -> None:
        self.last_data_wait = None
        self.data_wait_total = 0.0
        self.h2d_wait_total = 0.0
        self.source_wait_total = 0.0
        self.batches_fed = 0
        self._occ_sum = 0
        self._occ_n = 0
