"""Zip-backed image source + shared-memory array cache — a copy of
``deeplearning_tpu/data/zip_cache.py``.

Surface of the swin loader's zip-cache path (classification/
swin_transformer/dataLoader/zipreader.py:23 + build.py CACHE_MODE: read
images straight out of a .zip so one file serves many workers) and
YOLOX's RAM cache (numpy memmap shared across forked workers,
yolox/core/launch.py:72-80). Data loading is host-side; these sources
slot into MapSource/DataLoader. PIL is imported only when a member that
is not ``.npy`` is read.
"""

from __future__ import annotations

import io
import os
import threading
import zipfile
from typing import Tuple

import numpy as np

__all__ = ["ZipImageSource", "MemmapCache"]


class ZipImageSource:
    """Lazy image reads from a zip archive; one handle per thread (zip
    handles are not thread-safe — zipreader's is_zip_path/read pattern)."""

    def __init__(self, zip_path: str, extensions=(".png", ".jpg", ".jpeg",
                                                  ".bmp", ".npy")):
        self.zip_path = zip_path
        self._local = threading.local()
        with zipfile.ZipFile(zip_path) as z:
            self.names = sorted(
                n for n in z.namelist()
                if n.lower().endswith(extensions) and not n.endswith("/"))

    def _handle(self) -> zipfile.ZipFile:
        if not hasattr(self._local, "z"):
            self._local.z = zipfile.ZipFile(self.zip_path)
        return self._local.z

    def __len__(self) -> int:
        return len(self.names)

    def read_bytes(self, idx: int) -> bytes:
        return self._handle().read(self.names[idx])

    def read_image(self, idx: int) -> np.ndarray:
        name = self.names[idx]
        raw = self.read_bytes(idx)
        if name.lower().endswith(".npy"):
            return np.load(io.BytesIO(raw))
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


class MemmapCache:
    """Decode-once image cache in a disk-backed memmap shared across
    processes (the YOLOX cache_mode analog)."""

    def __init__(self, cache_path: str, shape: Tuple[int, ...],
                 dtype=np.uint8):
        self.cache_path = cache_path
        self.shape = shape
        exists = os.path.exists(cache_path)
        self.arr = np.memmap(cache_path, dtype=dtype,
                             mode="r+" if exists else "w+", shape=shape)
        flag_path = cache_path + ".filled"
        self._filled = np.memmap(flag_path, dtype=np.uint8,
                                 mode="r+" if os.path.exists(flag_path)
                                 else "w+", shape=(shape[0],))

    def get(self, idx: int, produce) -> np.ndarray:
        if not self._filled[idx]:
            self.arr[idx] = produce(idx)
            self._filled[idx] = 1
        return np.asarray(self.arr[idx])

    @property
    def fill_fraction(self) -> float:
        return float(np.mean(self._filled))
