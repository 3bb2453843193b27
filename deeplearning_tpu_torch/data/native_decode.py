"""ctypes binding for the native JPEG decode worker
(``native/imagedec.cpp``) — a copy of
``deeplearning_tpu/data/native_decode.py`` over the port's builder.

Drops into the data pipeline as a fast path: ``decode_jpeg`` replaces
PIL for single images (datasets.load_image), ``decode_resize_batch``
decodes+resizes a whole batch off the GIL with a C++ thread pool — the
native input-path analog of the reference's cv2/torchvision decode
underneath its DataLoaders. Falls back cleanly when g++/libjpeg are
absent: ``available()`` gates every call site.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..native.build import load

_CACHE = {"lib": False}  # False = not tried, None = unavailable


def _lib():
    if _CACHE["lib"] is False:
        lib = load("imagedec")
        if lib is not None:
            lib.decode_jpeg_info.restype = ctypes.c_int
            lib.decode_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.decode_jpeg.restype = ctypes.c_int
            lib.decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
            lib.decode_resize_batch.restype = ctypes.c_int
            lib.decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _CACHE["lib"] = lib
    return _CACHE["lib"]


def available() -> bool:
    return _lib() is not None


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or None on failure."""
    lib = _lib()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.decode_jpeg_info(data, len(data), ctypes.byref(w),
                            ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.decode_jpeg(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    return out if rc == 0 else None


def decode_resize_batch(blobs: List[bytes], out_h: int, out_w: int,
                        n_threads: int = 4,
                        strict: bool = False) -> Optional[np.ndarray]:
    """List of JPEG byte strings -> (N, out_h, out_w, 3) uint8, decoded
    and bilinear-resized by a C++ thread pool (GIL released for the whole
    batch). Returns None only if the native lib is unavailable.

    Failed decodes come back as zero images. The C worker reports how many
    failed: with ``strict=True`` any failure raises; otherwise a warning
    is logged so corrupt inputs can't silently poison a training batch."""
    lib = _lib()
    if lib is None:
        return None
    n = len(blobs)
    out = np.zeros((n, out_h, out_w, 3), np.uint8)
    if n == 0:
        return out
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_long * n)(*[len(b) for b in blobs])
    n_errors = lib.decode_resize_batch(
        bufs, lens, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if n_errors:
        if strict:
            raise ValueError(
                f"decode_resize_batch: {n_errors}/{n} JPEG decodes failed")
        import logging
        logging.getLogger(__name__).warning(
            "decode_resize_batch: %d/%d JPEG decodes failed "
            "(zero-filled in output)", n_errors, n)
    return out
