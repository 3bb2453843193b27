"""Multi-scale detection training over a fixed list of sizes — the port of
``deeplearning_tpu/train/multiscale.py``.

YOLOX's ``random_resize`` draws a new training size every few iterations.
Here the size comes from a fixed bucket list, a pure function of (seed,
window): ``np.random.default_rng([seed, window])`` draws the bucket
exactly as the JAX package does, so both pick the same sizes and every
process agrees without a broadcast.

``resize_detection_batch`` resizes the images on the batch's device with
the separable triangle kernel that ``jax.image.resize(..., "bilinear")``
computes (``jax.image.scale_and_translate``): half-pixel centres, the
kernel widened by the downscale factor (antialiasing), weights
normalised over the input pixels they reach; each axis is one matmul
with its weight matrix (``ops/resize.triangle_weights``, the one copy
of those weights). ``F.interpolate``'s antialiased bilinear differs
from it by up to ~3e-5 on [0, 1] images at these ratios; this differs by
the order of float32 sums only. The box coordinates scale by the same
ratios.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import triangle_weights

__all__ = ["YOLOX_SIZES", "MultiScaleSchedule", "resize_detection_batch",
           "make_multiscale_step"]

# YOLOX default buckets: [448..832] step 32
YOLOX_SIZES: Tuple[int, ...] = tuple(range(448, 833, 32))


class MultiScaleSchedule:
    """Deterministic bucketed size schedule: ``size_for_step(step)`` is
    constant within windows of ``change_every`` steps, pseudo-random across
    windows, and the same on every process for the same seed."""

    def __init__(self, sizes: Sequence[int] = YOLOX_SIZES,
                 change_every: int = 10, seed: int = 0):
        if not sizes:
            raise ValueError("need at least one size bucket")
        self.sizes = tuple(int(s) for s in sizes)
        self.change_every = max(int(change_every), 1)
        self.seed = seed

    def size_for_step(self, step: int) -> int:
        window = int(step) // self.change_every
        idx = np.random.default_rng(
            [self.seed, window]).integers(len(self.sizes))
        return self.sizes[int(idx)]

    def __iter__(self):
        step = 0
        while True:
            yield self.size_for_step(step)
            step += 1


def _resize_images(images: torch.Tensor, hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """(B, H, W, C) float images to (B, h, w, C), on their device."""
    _, h, w, _ = images.shape
    out = images
    if h != hw[0]:
        out = torch.einsum("bhwc,hk->bkwc", out,
                           triangle_weights(h, hw[0], images.device))
    if w != hw[1]:
        out = torch.einsum("bhwc,wk->bhkc", out,
                           triangle_weights(w, hw[1], images.device))
    return out.contiguous()


def resize_detection_batch(batch: Dict[str, torch.Tensor], size: int
                           ) -> Dict[str, torch.Tensor]:
    """A padded detection batch resized to (size, size), the box pixel
    coordinates scaled by the same ratios. The batch as it is when it is
    at that size already."""
    imgs = batch["image"]
    _, h, w, _ = imgs.shape
    if (h, w) == (size, size):
        return batch
    out = dict(batch)
    out["image"] = _resize_images(imgs, (size, size))
    if "boxes" in batch:
        sx, sy = size / w, size / h
        b = batch["boxes"]
        # python scalars: no host-to-device copy inside a guarded step
        out["boxes"] = torch.stack([b[..., 0] * sx, b[..., 1] * sy,
                                    b[..., 2] * sx, b[..., 3] * sy], dim=-1)
    return out


def make_multiscale_step(step_fn, schedule: MultiScaleSchedule,
                         resize=resize_detection_batch,
                         start_step: int = 0):
    """Wrap a train step: each call resizes the batch to the scheduled
    bucket first. The step counter is a host integer (``start_step`` when
    resuming), so the schedule never reads the device."""
    counter = {"n": int(start_step)}

    def wrapped(state, batch, *rest):
        size = schedule.size_for_step(counter["n"])
        counter["n"] += 1
        return step_fn(state, resize(batch, size), *rest)

    return wrapped
