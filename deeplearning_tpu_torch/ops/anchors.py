"""Anchor generation for FPN detectors: the port's own copy of
``deeplearning_tpu/ops/anchors.py`` (numpy, host side).

Per-level (sizes × ratios) anchor grids in image coordinates, returned as
one concatenated (A, 4) float32 array plus per-level counts. The
arithmetic is the JAX package's, operation for operation, so the arrays
are equal bit for bit; the detectors upload them once per (image size,
device).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["base_anchors", "grid_anchors", "pyramid_anchors",
           "retinanet_sizes"]


def base_anchors(sizes: Sequence[float], ratios: Sequence[float]
                 ) -> np.ndarray:
    """(len(sizes)*len(ratios), 4) centred zero-origin anchors."""
    sizes_arr = np.asarray(sizes, np.float32)
    ratios_arr = np.asarray(ratios, np.float32)
    h_ratios = np.sqrt(ratios_arr)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * sizes_arr[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * sizes_arr[None, :]).reshape(-1)
    return np.stack([-ws, -hs, ws, hs], axis=1) / 2.0


def grid_anchors(feature_hw: Tuple[int, int], stride: int,
                 cell_anchors: np.ndarray) -> np.ndarray:
    """(H*W*A, 4) anchors for one level, in (y, x, anchor) order."""
    h, w = feature_hw
    shifts_x = (np.arange(w, dtype=np.float32) + 0.0) * stride
    shifts_y = (np.arange(h, dtype=np.float32) + 0.0) * stride
    sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                      axis=1)
    anchors = shifts[:, None, :] + cell_anchors[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def pyramid_anchors(
    feature_shapes: Dict[str, Tuple[int, int]],
    strides: Dict[str, int],
    sizes_per_level: Dict[str, Sequence[float]],
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> Tuple[np.ndarray, List[int]]:
    """All-level anchors concatenated + per-level counts (levels in order
    p2 < p3 < ...)."""
    out, counts = [], []
    for name in sorted(feature_shapes, key=lambda k: int(k[1:])):
        cell = base_anchors(sizes_per_level[name], ratios)
        a = grid_anchors(feature_shapes[name], strides[name], cell)
        out.append(a)
        counts.append(len(a))
    return np.concatenate(out, axis=0), counts


def retinanet_sizes(levels: Sequence[int] = (3, 4, 5, 6, 7)
                    ) -> Dict[str, Sequence[float]]:
    """RetinaNet 3-scale-per-level sizes: 2^lvl*4 * {1, 2^(1/3), 2^(2/3)}."""
    return {f"p{l}": tuple(2 ** l * 4 * 2 ** (i / 3) for i in range(3))
            for l in levels}
