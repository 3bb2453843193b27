"""Input pipeline: fixed-shape batches, optionally moved to a device — the
port of ``deeplearning_tpu/data/loader.py``.

``ArraySource`` / ``MapSource`` are the datasets, ``epoch_indices`` the
per-epoch permutation (numpy, seeded by (seed, epoch): the same index
order as the JAX loader's, element for element), and ``DataLoader`` the
batching loop with ``set_epoch``, ``reseed``, ``element_spec``, threaded
workers and drop-last batches (every batch has one shape).

``device=`` is the device the batches are moved to (a ``torch.device``
or name), or None for host numpy batches. Over a ``torch.distributed``
group each rank materialises its contiguous slice of every global batch
of the same shuffled order (the JAX loader's per-process slice): with
``mesh=`` (``parallel.mesh.Mesh``) the slice of its index on data x fsdp,
``global_batch / (data x fsdp)`` rows, so the ranks that differ only on
``seq`` or ``model`` read the same rows; without, the slice of its world
rank. One rank of each data x fsdp index, concatenated, gives the
single-process batch.

``quarantine=`` (a ``QuarantineLog`` or a manifest path) switches the
fetch to one sample at a time: a sample whose fetch raises is logged and
replaced by a good sample of the same batch, so every batch stays full;
past the log's ``max_poisoned_frac`` it raises ``PoisonedData``. Without
a log, or for a failure that is not a sample's fault (``MemoryError``,
interrupts), the fetch error is re-raised on the consumer thread with
its original traceback. The ``bad_sample@step:N`` fault
(``DLTPU_FAULTS``) fails fetch number N through the same path.

``prefetch_to_device`` is the minimal generator form of the overlap;
``data/device_prefetch.DevicePrefetcher`` is the one the Trainer uses.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import time
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Union)

import numpy as np
import torch

from ..elastic import faults
from ..parallel.mesh import world_size
from ..parallel.sharding import host_local_slice
from .quarantine import PoisonedData, QuarantineLog, quarantinable

__all__ = ["ArraySource", "MapSource", "epoch_indices", "ArraySpec",
           "DataLoader", "prefetch_to_device"]

Device = Union[str, torch.device]


class ArraySource:
    """In-memory dataset of parallel arrays (images, labels, ...)."""

    def __init__(self, **arrays: np.ndarray):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"Array length mismatch: {sizes}")
        self.arrays = arrays
        self.size = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class MapSource:
    """Lazy dataset: indices -> sample dict via ``fetch`` (per-sample
    decode and augmentation live in fetch)."""

    def __init__(self, size: int,
                 fetch: Callable[[int], Dict[str, np.ndarray]]):
        self.size = size
        self.fetch = fetch

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.fetch(int(idx))
        samples = [self.fetch(int(i)) for i in idx]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def epoch_indices(size: int, *, shuffle: bool, seed: int, epoch: int,
                  drop_last_to: Optional[int] = None) -> np.ndarray:
    """Deterministic per-epoch permutation: seeding by (seed, epoch) is
    the sampler's ``set_epoch``."""
    idx = np.arange(size)
    if shuffle:
        idx = np.random.default_rng((seed, epoch)).permutation(size)
    if drop_last_to:
        idx = idx[: (size // drop_last_to) * drop_last_to]
    return idx


class ArraySpec(NamedTuple):
    """Shape, dtype and device of one leaf of a batch (the JAX loader's
    ``jax.ShapeDtypeStruct``); ``device`` None for a host array."""
    shape: tuple
    dtype: np.dtype
    device: Optional[torch.device]


def _to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, Any]:
    """Host leaves to ``device`` with a plain (blocking) copy; tensors
    already there pass through."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


class DataLoader:
    """Fixed-shape batches of ``global_batch`` rows (this rank's
    ``host_batch`` of them over a process group), optionally moved to
    ``device``.

    - ``num_workers > 0`` fetches samples on a thread pool, keeping
      ``lookahead`` batches in flight; the batches equal the serial
      path's.
    - ``infinite`` runs epochs back to back from ``self.epoch``.
    - ``host_batches()`` yields the same batches left on the host: a
      wrapping ``DevicePrefetcher`` reads those and owns the transfer, so
      each batch moves once, on its thread.
    """

    def __init__(self, source, global_batch: int, *, shuffle: bool = True,
                 seed: int = 0, device: Optional[Device] = None,
                 transform: Optional[Callable[[Dict], Dict]] = None,
                 infinite: bool = False, num_workers: int = 0,
                 lookahead: int = 4, quarantine=None, mesh=None):
        self.source = source
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        self.transform = transform
        self.infinite = infinite
        self.epoch = 0
        self.num_workers = num_workers
        self.lookahead = max(lookahead, 1)
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # a QuarantineLog (or a manifest path to build one) switches the
        # fetch to per-sample, so a failing sample is substituted and
        # logged instead of killing the epoch; None keeps the batched read
        self.quarantine: Optional[QuarantineLog] = (
            QuarantineLog(quarantine) if isinstance(quarantine, str)
            else quarantine)
        self._fetch_counter = itertools.count(1)  # bad_sample fault site
        self._last_good: Optional[Dict[str, Any]] = None
        # reseed(salt) perturbs the shuffle seed so a replayed window
        # draws another permutation (divergence rollback)
        self._seed_salt = 0
        # starvation telemetry (parallel path only): time the consumer
        # blocked on the last yielded batch's fetches, and the epoch's
        # total; None on the serial path (the Trainer then uses wall time)
        self.last_data_wait: Optional[float] = None
        self.data_wait_total = 0.0
        # a mesh cuts the batch by data x fsdp (host_local_slice)
        self.mesh = mesh
        n_proc = (world_size() if mesh is None
                  else mesh.axis_size(("data", "fsdp")))
        if global_batch % n_proc:
            raise ValueError(f"global_batch {global_batch} not divisible by "
                             f"process count {n_proc}")
        self.host_batch = global_batch // n_proc

    def __len__(self) -> int:
        return len(self.source) // self.global_batch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def reseed(self, salt: int) -> None:
        """Perturb the effective shuffle seed (idempotent per ``salt``)."""
        self._seed_salt = int(salt)

    def _effective_seed(self) -> int:
        return self.seed + self._seed_salt * 1_000_003

    def _batch_indices(self, epoch: int) -> Iterator[np.ndarray]:
        idx = epoch_indices(len(self.source), shuffle=self.shuffle,
                            seed=self._effective_seed(), epoch=epoch,
                            drop_last_to=self.global_batch)
        # this rank's contiguous slice of each global batch
        lo, hi = host_local_slice(self.global_batch, self.mesh)
        for start in range(0, len(idx), self.global_batch):
            yield idx[start:start + self.global_batch][lo:hi]

    def _finalize(self, batch: Dict[str, Any],
                  to_device: bool) -> Dict[str, Any]:
        if self.transform:
            batch = self.transform(batch)
        if self.device is not None and to_device:
            batch = _to_device(batch, self.device)
        return batch

    def element_spec(self) -> Optional[Dict[str, ArraySpec]]:
        """Shape, dtype and device of one yielded batch, from ONE source
        sample pushed through ``transform`` (one decode, not a batch).
        None when the source holds less than one batch."""
        try:
            first = int(next(iter(self._batch_indices(self.epoch)))[0])
        except StopIteration:
            return None
        sample = self.source[np.asarray([first])]
        if self.transform:
            sample = self.transform(sample)
        return {k: ArraySpec((self.host_batch, *np.shape(v)[1:]),
                             np.asarray(v).dtype, self.device)
                for k, v in sample.items()}

    # ------------------------------------------------ per-sample fetch
    def _fetch_one(self, i: int) -> Dict[str, np.ndarray]:
        """One sample through the fault harness (``bad_sample@step:N``
        counts FETCHES); exceptions propagate to the caller, since the
        quarantine decision lives on the consumer thread."""
        ordinal = next(self._fetch_counter)
        if faults.consume("bad_sample", "step", step=ordinal):
            raise faults.InjectedBadSample(
                f"injected bad sample at fetch {ordinal} (index {i})")
        return self.source[int(i)]

    def _quarantine_or_raise(self, i: int, exc: BaseException) -> None:
        """Quarantine a per-sample failure, or re-raise it on the
        consumer thread with its original traceback when it is not a
        sample's fault (interrupts, escalation, out of memory)."""
        if self.quarantine is None or not quarantinable(exc):
            raise exc
        self.quarantine.record(int(i), exc, step=self.epoch)

    def _assemble(self, local, samples) -> Dict[str, Any]:
        """Stack per-sample dicts into one full batch, substituting
        quarantined slots (None) with good samples of the batch. A batch
        with NO survivors and none seen before is a hard error: there is
        nothing honest to substitute."""
        good = [s for s in samples if s is not None]
        if good:
            self._last_good = good[-1]
            if self.quarantine is not None:
                self.quarantine.note_ok(len(good))
        elif self._last_good is not None:
            good = [self._last_good]
        else:
            raise PoisonedData(
                f"every sample in batch {list(map(int, local))} failed "
                "with none seen before it — nothing to substitute")
        samples = [s if s is not None else good[j % len(good)]
                   for j, s in enumerate(samples)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _epoch_iter(self, epoch: int,
                    to_device: bool) -> Iterator[Dict[str, Any]]:
        if self.num_workers:
            yield from self._epoch_iter_parallel(epoch, to_device)
            return
        for local in self._batch_indices(epoch):
            if self.quarantine is None:
                yield self._finalize(self.source[local], to_device)
                continue
            samples = []
            for i in local:
                try:
                    samples.append(self._fetch_one(int(i)))
                except BaseException as exc:  # noqa: BLE001 - re-raised
                    self._quarantine_or_raise(int(i), exc)
                    samples.append(None)
            yield self._finalize(self._assemble(local, samples), to_device)

    def _epoch_iter_parallel(self, epoch: int,
                             to_device: bool) -> Iterator[Dict[str, Any]]:
        """Fetch samples on a thread pool (decode that releases the GIL
        overlaps), ``lookahead`` batches of futures in flight. A worker's
        exception surfaces here, on the consumer thread, with its
        original traceback (``f.result()``): a quarantinable one is
        substituted and logged, any other kills the epoch."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="loader-fetch")
        pending: collections.deque = collections.deque()
        it = self._batch_indices(epoch)
        self.data_wait_total = 0.0

        def submit(local):
            pending.append((local, [self._pool.submit(self._fetch_one, i)
                                    for i in local]))
        try:
            for local in itertools.islice(it, self.lookahead):
                submit(local)
            while pending:
                local, futs = pending.popleft()
                # blocking on not-yet-done futures is the starvation
                # signal (done futures return at once)
                t0 = time.perf_counter()
                samples = []
                for i, f in zip(local, futs):
                    try:
                        samples.append(f.result())
                    except BaseException as exc:  # noqa: BLE001
                        self._quarantine_or_raise(int(i), exc)
                        samples.append(None)
                self.last_data_wait = time.perf_counter() - t0
                self.data_wait_total += self.last_data_wait
                yield self._finalize(self._assemble(local, samples),
                                     to_device)
                for local in itertools.islice(it, 1):
                    submit(local)
        finally:
            for _, futs in pending:
                for f in futs:
                    f.cancel()

    def _iter(self, to_device: bool) -> Iterator[Dict[str, Any]]:
        if not self.infinite:
            yield from self._epoch_iter(self.epoch, to_device)
            return
        for epoch in itertools.count(self.epoch):
            yield from self._epoch_iter(epoch, to_device)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self._iter(to_device=True)

    def host_batches(self) -> Iterator[Dict[str, Any]]:
        """The batches ``__iter__`` yields, before the move to
        ``device``."""
        return self._iter(to_device=False)


def prefetch_to_device(iterator, size: int = 2,
                       device: Optional[Device] = None) -> Iterator:
    """Keep ``size`` batches' host-to-device copies in flight ahead of the
    consumer (flax's ``prefetch_to_device`` surface): host leaves are
    pinned and copied with ``non_blocking=True`` on the current stream, so
    the copies queue behind the steps already issued and the host runs
    ahead. Tensors already on ``device`` pass through. ``device`` None is
    the current CUDA device."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    queue: collections.deque = collections.deque()

    def place(x):
        if isinstance(x, torch.Tensor) and x.device == dev:
            return x
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)

    it = iter(iterator)
    for b in itertools.islice(it, size):
        queue.append({k: place(v) for k, v in b.items()})
    while queue:
        yield queue.popleft()
        for b in itertools.islice(it, 1):
            queue.append({k: place(v) for k, v in b.items()})
