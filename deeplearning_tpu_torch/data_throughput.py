"""Input-pipeline throughput CLI of the port: is the feed the ceiling?
The counterpart of ``tools/data_throughput.py``.

  python -m deeplearning_tpu_torch.data_throughput --folder .data/digits/cls

Measures the images/s of (a) the decoded memmap cache
(``data/zip_cache.MemmapCache``: decode once, then stream batches from a
memmapped cache at memory rate, the zipreader / cached-dataset
capability of dataLoader/zipreader.py:23), and, given ``--folder``,
(b) the native C++ decode + resize of a batch (``data/native_decode``,
native/imagedec.cpp's thread pool, no augment; skipped when the library
does not build) and (c) the JPEG folder path with its worker pool, decode
and augment through ``data/build.build_classification_loaders``, each
batch moved to ``--device`` by the loader, measured by
``data/build.measure_throughput``.

Differences from ``tools/data_throughput.py``, by decision: the folder
path moves its batches to ``--device`` (default ``cuda``; ``cpu`` keeps
them on the host), so (c) includes the host-to-card copy the Trainer
pays; the JAX tool's rate of a training step on its own chip does not
come across (the port records its own in PERF.md).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def bench_jpeg_folder(root: str, image_size: int, batch: int,
                      num_workers: int, n_batches: int, device) -> float:
    from .data.build import (LoaderConfig, build_classification_loaders,
                             measure_throughput)
    cfg = LoaderConfig(global_batch=batch, image_size=image_size,
                       num_workers=num_workers, val_rate=0.05)
    train, _, _ = build_classification_loaders(root, cfg, device=device)
    return measure_throughput(train, n_batches=n_batches)


def bench_memmap(image_size: int, batch: int, n_batches: int,
                 n_images: int = 2048) -> float:
    from .data.zip_cache import MemmapCache
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cache")
        cache = MemmapCache(path, shape=(n_images, image_size,
                                         image_size, 3),
                            dtype=np.uint8)
        rng = np.random.default_rng(0)
        sample = rng.integers(0, 255, (image_size, image_size, 3),
                              dtype=np.uint8)
        for i in range(n_images):
            cache.get(i, lambda _i: sample)
        idx_rng = np.random.default_rng(1)
        _ = np.asarray(cache.arr[np.arange(batch)])   # warm
        t0 = time.perf_counter()
        n = 0
        for _ in range(n_batches):
            idx = np.sort(idx_rng.integers(0, n_images, batch))
            arr = np.asarray(cache.arr[idx])
            arr = arr.astype(np.float32)  # the normalize-cost stand-in
            n += batch
        return n / (time.perf_counter() - t0)


def bench_native_batch(root: str, image_size: int, batch: int,
                       num_workers: int, n_batches: int) -> float:
    """Raw C++ decode_resize_batch rate (native/imagedec.cpp thread pool,
    no augment): the upper bound of the native input path; 0.0 when the
    library is unavailable or the folder holds no JPEG."""
    from .data.native_decode import available, decode_resize_batch
    if not available():
        return 0.0
    paths = []
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.lower().endswith((".jpg", ".jpeg"))]
    if not paths:
        return 0.0
    blobs = []
    for p in sorted(paths)[:batch]:
        with open(p, "rb") as f:
            blobs.append(f.read())
    decode_resize_batch(blobs, image_size, image_size, num_workers)  # warm
    t0 = time.perf_counter()
    n = 0
    for i in range(n_batches):
        sel = [blobs[(i * 7 + j) % len(blobs)] for j in range(batch)]
        decode_resize_batch(sel, image_size, image_size, num_workers)
        n += batch
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.data_throughput",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--folder", default=None)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .core.device import resolve_device
    dev = resolve_device(args.device)

    mm = bench_memmap(args.image_size, args.batch, args.batches)
    print(f"memmap_cache: {mm:,.0f} img/s "
          f"({args.image_size}px, batch {args.batch}, 1 host thread)")
    if args.folder:
        nb = bench_native_batch(args.folder, args.image_size, args.batch,
                                args.workers, args.batches)
        if nb:
            print(f"native_decode_resize: {nb:,.0f} img/s "
                  f"(C++ pool, {args.workers} threads)")
        jf = bench_jpeg_folder(args.folder, args.image_size, args.batch,
                               args.workers, args.batches, dev)
        print(f"jpeg_decode+augment: {jf:,.0f} img/s "
              f"({args.workers} workers on {os.cpu_count()} core(s), "
              f"batches moved to {dev})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
