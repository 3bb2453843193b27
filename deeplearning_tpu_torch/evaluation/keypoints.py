"""Keypoint evaluation — the port of
``deeplearning_tpu/evaluation/keypoints.py``: heatmap decoding on the
device, and the host-side OKS, PCK, OKS-AP and heatmap targets (numpy,
copied as they are).

``decode_heatmaps`` takes JAX's layout, (B, H, W, K) heatmaps, and
returns keypoints (B, K, 2) in input pixels with their scores (B, K):
the argmax (the first maximum in row-major order, as ``jnp.argmax``)
plus a quarter-pixel shift toward the larger neighbour, for strictly
interior peaks only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["COCO_SIGMAS", "decode_heatmaps", "oks", "pck", "oks_ap",
           "make_heatmap_targets"]

# COCO person sigmas; custom datasets pass their own
COCO_SIGMAS = np.asarray([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])


def decode_heatmaps(heatmaps: torch.Tensor, stride: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, K) → keypoints (B, K, 2) xy in input coordinates and
    scores (B, K)."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k)
    scores, idx = torch.max(flat, dim=1)              # first maximum
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()

    def neighbor(dy, dx):
        yy = torch.clamp(ys + dy, 0, h - 1).long()
        xx = torch.clamp(xs + dx, 0, w - 1).long()
        return flat.gather(1, (yy * w + xx)[:, None, :])[:, 0, :]
    right, left = neighbor(0, 1), neighbor(0, -1)
    down, up = neighbor(1, 0), neighbor(-1, 0)
    zero = torch.zeros_like(xs)
    x_interior = (xs > 0) & (xs < w - 1)
    y_interior = (ys > 0) & (ys < h - 1)
    xs = xs + torch.where(x_interior, 0.25 * torch.sign(right - left), zero)
    ys = ys + torch.where(y_interior, 0.25 * torch.sign(down - up), zero)
    return torch.stack([xs, ys], dim=-1) * stride, scores


def oks(pred: np.ndarray, gt: np.ndarray, visible: np.ndarray,
        area: float, sigmas: Optional[np.ndarray] = None) -> float:
    """Object keypoint similarity between one predicted and one gt pose.
    pred/gt (K, 2); visible (K,) >0 counts."""
    k = len(gt)
    sigmas = COCO_SIGMAS[:k] if sigmas is None else np.asarray(sigmas)[:k]
    vars_ = (2 * sigmas) ** 2
    v = visible > 0
    if not v.any():
        return 0.0
    d2 = np.sum((np.asarray(pred) - np.asarray(gt)) ** 2, axis=1)
    e = d2 / (vars_ * 2 * max(area, 1e-9))
    return float(np.mean(np.exp(-e[v])))


def pck(pred: np.ndarray, gt: np.ndarray, visible: np.ndarray,
        threshold_px: float) -> float:
    """Percentage of correct keypoints within a pixel threshold."""
    v = visible > 0
    if not v.any():
        return 0.0
    d = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=1)
    return float(np.mean(d[v] <= threshold_px))


def oks_ap(predictions: Sequence[Dict], groundtruths: Sequence[Dict],
           thresholds: np.ndarray = np.linspace(0.5, 0.95, 10)
           ) -> Dict[str, float]:
    """Single-pose-per-image OKS AP (the Insulator dataset setting):
    predictions [{keypoints (K,2), score}], groundtruths
    [{keypoints (K,2), visible (K,), area}]."""
    oks_vals = np.asarray([
        oks(p["keypoints"], g["keypoints"], g["visible"], g["area"])
        for p, g in zip(predictions, groundtruths)])
    scores = np.asarray([p.get("score", 1.0) for p in predictions])
    order = np.argsort(-scores)
    oks_sorted = oks_vals[order]
    out = {}
    aps = []
    for t in thresholds:
        tp = np.cumsum(oks_sorted >= t)
        fp = np.cumsum(oks_sorted < t)
        recall = tp / max(len(groundtruths), 1)
        precision = tp / np.maximum(tp + fp, 1e-9)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            idx = np.searchsorted(recall, r, side="left")
            ap += (precision[idx] if idx < len(precision) else 0.0) / 101
        aps.append(ap)
    out["AP"] = float(np.mean(aps))
    out["AP50"] = float(aps[0])
    out["AP75"] = float(aps[5])
    out["mean_oks"] = float(np.mean(oks_vals)) if len(oks_vals) else 0.0
    return out


def make_heatmap_targets(keypoints: np.ndarray, visible: np.ndarray,
                         out_hw: Tuple[int, int], stride: int = 4,
                         sigma: float = 2.0) -> np.ndarray:
    """Gaussian heatmap targets (Insulator coco_transforms heatmap gen).
    keypoints (K, 2) in input coords → (H, W, K)."""
    h, w = out_hw
    k = len(keypoints)
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.zeros((h, w, k), np.float32)
    for i, ((x, y), v) in enumerate(zip(keypoints, visible)):
        if v <= 0:
            continue
        cx, cy = x / stride, y / stride
        heat[:, :, i] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                               / (2 * sigma ** 2))
    return heat
