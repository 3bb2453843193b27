"""Evaluation metrics — the port of part of
``deeplearning_tpu/evaluation/metrics.py``: ``topk_correct`` (counts, not
rates, stay on the device: the caller divides by the number of examples
once, on the host), and the host-side precision helpers of detection,
``interp_precision_at_recall`` (COCO's interpolated precision, which
``coco_eval`` accumulates with) and ``precision_recall_curve`` (numpy).
The confusion-matrix and dice helpers come with the segmentation slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["topk_correct", "interp_precision_at_recall",
           "precision_recall_curve"]


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """{"top{k}": int32 count of rows whose label is among the k largest
    logits, ..., "count": rows}."""
    maxk = min(max(ks), logits.shape[-1])
    pred = torch.topk(logits, maxk, dim=-1).indices
    correct = pred == labels[:, None].to(pred.dtype)
    out = {}
    for k in ks:
        k_eff = min(k, maxk)
        out[f"top{k}"] = correct[:, :k_eff].any(dim=-1).sum().to(torch.int32)
    out["count"] = torch.tensor(labels.shape[0], dtype=torch.int32,
                                device=logits.device)
    return out


def interp_precision_at_recall(precision: np.ndarray, recall: np.ndarray,
                               rec_points: np.ndarray) -> np.ndarray:
    """COCO-convention interpolated precision: the envelope (non-increasing
    from the right), sampled at ``rec_points`` by a left searchsorted."""
    pr = np.asarray(precision, np.float64)
    envelope = np.maximum.accumulate(pr[::-1])[::-1]
    idx = np.searchsorted(recall, rec_points, side="left")
    out = np.zeros(len(rec_points))
    valid = idx < len(envelope)
    out[valid] = envelope[idx[valid]]
    return out


def precision_recall_curve(scores: np.ndarray, is_tp: np.ndarray,
                           n_gt: int) -> Dict[str, np.ndarray]:
    """One class's PR curve and 101-point AP from scored detections.
    scores (N,); is_tp (N,) bool, whether each detection matched an
    unmatched gt; n_gt the ground-truth count. Returns precision, recall
    and scores by descending confidence, and ``ap``."""
    order = np.argsort(-np.asarray(scores, np.float64))
    tp = np.asarray(is_tp, np.float64)[order]
    fp = 1.0 - tp
    tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
    recall = tp_cum / max(n_gt, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    rec_points = np.linspace(0.0, 1.0, 101)
    ap = float(np.mean(interp_precision_at_recall(
        precision, recall, rec_points))) if len(tp) else 0.0
    return {"precision": precision, "recall": recall,
            "scores": np.asarray(scores, np.float64)[order], "ap": ap}
