"""Real-image input pipeline builder — the port of
``deeplearning_tpu/data/build.py``.

Capability surface of classification/swin_transformer/dataLoader/build.py
(:38 build_loader — ImageFolder/zip dataset + DistributedSampler + torch
DataLoader(num_workers, pin_memory) + mixup) and its ~16 per-project
copies (classification/mnist/dataLoader/dataSet.py etc.):

- JPEG decode + augmentation run on a thread pool (``num_workers``),
  overlapped with the step; ``device_iterator`` adds the pinned,
  side-stream host-to-card copy (``DevicePrefetcher``);
- batches are fixed-shape (drop-last), so every step sees one shape.

``device=`` is where the loaders move their batches, and
``jax.process_count()`` is the ``torch.distributed`` world size (or 1
when no group is initialised), or with ``mesh=`` its data x fsdp extent:
each rank's loaders yield its slice of every global batch, and the
validation split is padded to a multiple of that count as JAX pads it. ``quarantine=`` (a
``QuarantineLog`` or a manifest path) goes to both loaders.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..parallel.mesh import world_size
from .datasets import folder_source, read_split_data, write_class_indices
from .device_prefetch import DevicePrefetcher
from .loader import DataLoader, prefetch_to_device  # noqa: F401 - re-export
from .quarantine import QuarantineLog
from .transforms import eval_image_transform, get_train_transform

__all__ = ["LoaderConfig", "build_classification_loaders",
           "device_iterator", "measure_throughput"]


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    """Knobs of build_loader (dataLoader/build.py:38)."""
    global_batch: int = 128
    image_size: int = 224
    val_rate: float = 0.2
    num_workers: int = 8
    lookahead: int = 4
    seed: int = 0
    prefetch: int = 2
    augment: str = "imagenet"        # imagenet | light | none


def build_classification_loaders(
        root: str, cfg: LoaderConfig = LoaderConfig(), *,
        device=None, class_indices_path: Optional[str] = None,
        train_transform: Optional[Callable] = None,
        eval_transform: Optional[Callable] = None,
        quarantine=None, mesh=None,
) -> Tuple[DataLoader, DataLoader, Dict[str, int]]:
    """(train_loader, val_loader, class_to_idx) from an ImageFolder root.

    Decode/augment happen per sample inside folder_source's fetch, so the
    DataLoader's worker pool parallelizes the full decode+augment path.
    """
    if isinstance(quarantine, str):
        quarantine = QuarantineLog(quarantine)
    split = read_split_data(root, val_rate=cfg.val_rate, seed=cfg.seed)
    if class_indices_path:
        write_class_indices(split["class_to_idx"], class_indices_path)
    size = (cfg.image_size, cfg.image_size)
    tt = train_transform or get_train_transform(cfg.augment, size,
                                                seed=cfg.seed)
    et = eval_transform or eval_image_transform(size)
    train = DataLoader(
        folder_source(split["train_paths"], split["train_labels"], tt),
        cfg.global_batch, shuffle=True, seed=cfg.seed, device=device,
        num_workers=cfg.num_workers, lookahead=cfg.lookahead,
        quarantine=quarantine, mesh=mesh)
    # clamp the val batch so a split smaller than global_batch still
    # yields batches (drop-last would otherwise drop the whole set);
    # keep it divisible by process count, repeating tail paths when the
    # split is smaller than the process count (multi-host degenerate
    # case — a duplicated val image beats an empty evaluation)
    n_proc = world_size() if mesh is None else mesh.axis_size(
        ("data", "fsdp"))
    val_paths = list(split["val_paths"])
    val_labels = list(split["val_labels"])
    orig_len = len(val_paths)
    while val_paths and len(val_paths) % n_proc:
        # round-robin distinct tail entries so no single image dominates
        val_paths.append(val_paths[len(val_paths) % orig_len])
        val_labels.append(val_labels[len(val_labels) % orig_len])
    val_batch = min(cfg.global_batch,
                    max(len(val_paths) // n_proc, 1) * n_proc)
    val = DataLoader(
        folder_source(val_paths, np.asarray(val_labels), et),
        val_batch, shuffle=False, seed=cfg.seed, device=device,
        num_workers=cfg.num_workers, lookahead=cfg.lookahead,
        quarantine=quarantine, mesh=mesh)
    return train, val, split["class_to_idx"]


def device_iterator(loader: DataLoader, cfg: LoaderConfig
                    ) -> DevicePrefetcher:
    """Loader wrapped in a threaded host-to-card prefetch stage of depth
    ``cfg.prefetch``: a :class:`DevicePrefetcher` (the full loader
    protocol, so the Trainer takes it as it is), which reads the
    loader's host batches and moves each once, on its worker thread."""
    return DevicePrefetcher(loader, depth=cfg.prefetch)


def measure_throughput(loader: DataLoader, n_batches: int = 30,
                       warmup: int = 2) -> float:
    """Host-pipeline images/sec (decode+augment+batch, no device work),
    cycling epochs if the loader is shorter than warmup+n_batches."""
    import itertools
    import time

    def cycle():
        while True:
            got_any = False
            for item in iter(loader):
                got_any = True
                yield item
            if not got_any:
                raise ValueError(
                    "loader yielded zero batches (fewer images than one "
                    "global batch under drop-last?) — cannot measure "
                    "throughput")

    it = cycle()
    n = 0
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for batch in itertools.islice(it, n_batches):
        n += len(next(iter(batch.values())))
    dt = time.perf_counter() - t0
    return n / dt
