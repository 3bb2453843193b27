"""Box ops: IoU, encode/decode, clip — the port of
``deeplearning_tpu/ops/boxes.py``.

Boxes are (x1, y1, x2, y2) float tensors with any leading dimensions.
``box_iou`` keeps the JAX operation order (areas from widths clamped at 0,
``inter / max(area1 + area2 - inter, 1e-9)``) because NMS compares its
result with a threshold: the CUDA NMS kernel (``csrc/nms_sweep.cu``)
computes the very same float32 operations, so the plain and kernel keep
sets agree exactly.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["BBOX_XFORM_CLIP", "box_area", "box_iou", "generalized_box_iou",
           "elementwise_box_iou", "encode_boxes", "decode_boxes",
           "clip_boxes", "remove_small_boxes_mask"]

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) × (..., M, 4) → (..., N, M) IoU matrix."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU matrix, (N, 4) × (M, 4) → (N, M)."""
    iou = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    inter = iou * (area1[:, None] + area2[None, :]) / (1 + iou)  # recover
    union = area1[:, None] + area2[None, :] - inter
    return iou - (hull - union) / hull.clamp(min=1e-9)


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                        kind: str = "iou") -> torch.Tensor:
    """Paired IoU / GIoU / DIoU / CIoU of equal-shaped (..., 4) boxes."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (box_area(boxes1) + box_area(boxes2) - inter).clamp(min=1e-9)
    iou = inter / union
    if kind == "iou":
        return iou
    hull_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    hull_rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    hull_wh = (hull_rb - hull_lt).clamp(min=0)
    if kind == "giou":
        hull = (hull_wh[..., 0] * hull_wh[..., 1]).clamp(min=1e-9)
        return iou - (hull - union) / hull
    c2 = hull_wh.square().sum(-1) + 1e-9
    ctr1 = (boxes1[..., :2] + boxes1[..., 2:]) / 2
    ctr2 = (boxes2[..., :2] + boxes2[..., 2:]) / 2
    rho2 = (ctr2 - ctr1).square().sum(-1)
    if kind == "diou":
        return iou - rho2 / c2
    if kind == "ciou":
        w1 = boxes1[..., 2] - boxes1[..., 0]
        h1 = (boxes1[..., 3] - boxes1[..., 1]).clamp(min=1e-9)
        w2 = boxes2[..., 2] - boxes2[..., 0]
        h2 = (boxes2[..., 3] - boxes2[..., 1]).clamp(min=1e-9)
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                  - torch.atan(w1 / h1)).square()
        alpha = (v / (1 - iou + v).clamp(min=1e-9)).detach()
        return iou - rho2 / c2 - alpha * v
    raise ValueError(kind)


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1, 1, 1, 1)
                 ) -> torch.Tensor:
    """Regression targets (dx, dy, dw, dh) of ``reference`` (gt) w.r.t.
    ``proposals`` (anchors)."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) / 2
    py = (proposals[..., 1] + proposals[..., 3]) / 2
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    gx = (reference[..., 0] + reference[..., 2]) / 2
    gy = (reference[..., 1] + reference[..., 3]) / 2
    gw = (reference[..., 2] - reference[..., 0]).clamp(min=1e-6)
    gh = (reference[..., 3] - reference[..., 1]).clamp(min=1e-6)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)],
                       dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1, 1, 1, 1)
                 ) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchors, with the log-space clip."""
    wx, wy, ww, wh = weights
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    h, w = size_hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor,
                            min_size: float) -> torch.Tensor:
    """Validity mask instead of an index list (static shapes)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)
