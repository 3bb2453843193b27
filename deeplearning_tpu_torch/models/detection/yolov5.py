"""YOLOv5: the port of ``deeplearning_tpu/models/detection/yolov5.py``: the
network, the grid, the decode, the training targets and loss, the
autoanchor helpers and the postprocess.

The v5.0 layout (Focus stem, C3 stages, SPP, a PANet head and three 1×1
Detect convs) built from the port's YOLOX blocks (``ConvBnSiLU``,
``CSPLayer``, ``SPPBottleneck``: the same math, BatchNorm eps 1e-3 and
flax momentum 0.97). Parameter names are flax's (``focus``, ``c1``..,
``csp1``.., ``h1``.., ``hcsp1``.., ``detect0``..). Each Detect output is
permuted to NHWC before the reshape, so rows are (y, x, anchor) with
(x, y, w, h, obj, cls…) columns, levels at strides 8, 16, 32, in the
order of ``yolov5_grid``.

Training: ``build_targets`` assigns a prediction slot to a gt when their
width and height ratios are within ``anchor_t`` and the gt's centre lies
in the slot's cell or the one lateral or vertical neighbour within half a
cell (the v5 three-neighbour rule); several gts resolve to the smallest
ratio. ``yolov5_loss`` is CIoU box loss, objectness BCE against the
detached clipped CIoU and class BCE, each a per-level mean over the whole
batch, the levels taken over the static ``STRIDES``. CIoU goes through
``ops/boxes.elementwise_box_iou``. ``kmean_anchors`` and
``check_anchors`` are numpy copies of JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import boxes as box_ops
from ...ops import losses as L
from ..layers import conv, init_flax_
from .retinanet import nhwc_rows
from .yolox import ConvBnSiLU, CSPLayer, SPPBottleneck, postprocess_decoded

__all__ = ["STRIDES", "DEFAULT_ANCHORS", "YOLOv5", "yolov5_grid",
           "decode_yolov5", "build_targets", "yolov5_loss",
           "yolov5_postprocess", "kmean_anchors", "check_anchors", "focus"]

STRIDES = (8, 16, 32)
# default COCO anchors (per level, (w, h) pairs)
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


def focus(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth of an NCHW tensor in the flax channel order."""
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                      x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


def _up(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize`` to twice the size, "nearest"."""
    return F.interpolate(x, scale_factor=2, mode="nearest-exact")


class YOLOv5(nn.Module):
    """Input (B, H, W, 3) NHWC float32; output (B, A, 5 + C) float32 raw
    Detect rows."""

    def __init__(self, num_classes: int = 80, depth_mult: float = 0.33,
                 width_mult: float = 0.5,
                 anchors: Sequence = DEFAULT_ANCHORS,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def w(c):
            return int(c * width_mult)

        def d(n):
            return max(int(round(n * depth_mult)), 1)
        self.num_classes, self.dtype = num_classes, dtype
        self.anchors = tuple(tuple(tuple(a) for a in lvl) for lvl in anchors)
        self.focus = ConvBnSiLU(12, w(64), 3, dtype=dtype)
        self.c1 = ConvBnSiLU(w(64), w(128), 3, 2, dtype=dtype)
        self.csp1 = CSPLayer(w(128), w(128), d(3), dtype=dtype)
        self.c2 = ConvBnSiLU(w(128), w(256), 3, 2, dtype=dtype)
        self.csp2 = CSPLayer(w(256), w(256), d(9), dtype=dtype)
        self.c3 = ConvBnSiLU(w(256), w(512), 3, 2, dtype=dtype)
        self.csp3 = CSPLayer(w(512), w(512), d(9), dtype=dtype)
        self.c4 = ConvBnSiLU(w(512), w(1024), 3, 2, dtype=dtype)
        self.spp = SPPBottleneck(w(1024), w(1024), dtype)
        self.csp4 = CSPLayer(w(1024), w(1024), d(3), shortcut=False,
                             dtype=dtype)
        self.h1 = ConvBnSiLU(w(1024), w(512), 1, dtype=dtype)
        self.hcsp1 = CSPLayer(w(512) + w(512), w(512), d(3), False, dtype)
        self.h2 = ConvBnSiLU(w(512), w(256), 1, dtype=dtype)
        self.hcsp2 = CSPLayer(w(256) + w(256), w(256), d(3), False, dtype)
        self.h3 = ConvBnSiLU(w(256), w(256), 3, 2, dtype=dtype)
        self.hcsp3 = CSPLayer(w(256) + w(256), w(512), d(3), False, dtype)
        self.h4 = ConvBnSiLU(w(512), w(512), 3, 2, dtype=dtype)
        self.hcsp4 = CSPLayer(w(512) + w(512), w(1024), d(3), False, dtype)
        na = len(self.anchors[0])
        for li, c in enumerate((w(256), w(512), w(1024))):
            setattr(self, f"detect{li}",
                    nn.Conv2d(c, na * (5 + num_classes), 1))
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype)   # NCHW view
        y = self.c1(self.focus(focus(x)))
        y = self.c2(self.csp1(y))
        p3 = self.csp2(y)
        p4 = self.csp3(self.c3(p3))
        p5 = self.csp4(self.spp(self.c4(p4)))
        h5 = self.h1(p5)
        h4 = self.h2(self.hcsp1(torch.cat([_up(h5), p4], dim=1)))
        o3 = self.hcsp2(torch.cat([_up(h4), p3], dim=1))
        o4 = self.hcsp3(torch.cat([self.h3(o3), h4], dim=1))
        o5 = self.hcsp4(torch.cat([self.h4(o4), h5], dim=1))
        outs = [nhwc_rows(conv(f, getattr(self, f"detect{li}"), self.dtype),
                          5 + self.num_classes)
                for li, f in enumerate((o3, o4, o5))]
        return torch.cat(outs, dim=1).float()


def yolov5_grid(image_hw: Tuple[int, int],
                anchors: Sequence = DEFAULT_ANCHORS
                ) -> Dict[str, np.ndarray]:
    """Per-prediction grid cell xy, anchor wh and stride (A_total, ...)."""
    h, w = image_hw
    cells, awh, strides = [], [], []
    for (s, lvl_anchors) in zip(STRIDES, anchors):
        fh, fw = math.ceil(h / s), math.ceil(w / s)
        ys, xs = np.mgrid[0:fh, 0:fw].astype(np.float32)
        grid = np.stack([xs, ys], -1).reshape(-1, 1, 2)
        grid = np.tile(grid, (1, len(lvl_anchors), 1)).reshape(-1, 2)
        cells.append(grid)
        a = np.tile(np.asarray(lvl_anchors, np.float32)[None],
                    (fh * fw, 1, 1)).reshape(-1, 2)
        awh.append(a)
        strides.append(np.full(fh * fw * len(lvl_anchors), s, np.float32))
    return {"cell": np.concatenate(cells), "anchor": np.concatenate(awh),
            "stride": np.concatenate(strides)}


def decode_yolov5(raw: torch.Tensor, grid: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """v5 decode: xy = (2σ(p) − 0.5 + cell) · stride; wh = (2σ(p))² ·
    anchor; boxes xyxy, then the raw obj and class logits."""
    xy = (2 * torch.sigmoid(raw[..., :2]) - 0.5 + grid["cell"]) \
        * grid["stride"][:, None]
    wh = torch.square(2 * torch.sigmoid(raw[..., 2:4])) * grid["anchor"]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    return torch.cat([boxes, raw[..., 4:]], dim=-1)


def build_targets(grid: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  anchor_t: float = 4.0) -> Dict[str, torch.Tensor]:
    """{pos (B, A) bool, matched_gt (B, A)}: a slot is positive for a gt
    whose width / height ratio to the slot's anchor is below ``anchor_t``
    on both sides and whose centre lies in the slot's cell or one lateral
    or vertical neighbour's half-cell band, never the diagonal. Several
    gts take the smallest ratio, the first on a tie. ``gt_labels`` is not
    read (JAX's signature)."""
    del gt_labels
    gwh = torch.stack([gt_boxes[..., 2] - gt_boxes[..., 0],
                       gt_boxes[..., 3] - gt_boxes[..., 1]], dim=-1)
    gxy = torch.stack([(gt_boxes[..., 0] + gt_boxes[..., 2]) / 2,
                       (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2], dim=-1)
    ratio = gwh[:, :, None, :] / grid["anchor"].clamp(min=1e-6)
    max_ratio = torch.maximum(ratio, 1.0 / ratio).amax(dim=-1)  # (B, G, A)
    wh_ok = max_ratio < anchor_t
    cell_xy = gxy[:, :, None, :] / grid["stride"][:, None]
    d = torch.abs(cell_xy - (grid["cell"] + 0.5))
    near = (d.amax(dim=-1) < 1.0) & (d.amin(dim=-1) < 0.5)
    cand = wh_ok & near & gt_valid[:, :, None]
    cost = torch.where(cand, max_ratio, torch.full_like(max_ratio,
                                                         math.inf))
    best_gt = torch.argmin(cost, dim=1)
    pos = cand.any(dim=1)
    return {"pos": pos, "matched_gt": torch.where(pos, best_gt, 0)}


def yolov5_loss(raw: torch.Tensor, grid: Dict[str, torch.Tensor],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, num_classes: int,
                box_gain: float = 0.05, obj_gain: float = 1.0,
                cls_gain: float = 0.5,
                balance: Sequence[float] = (4.0, 1.0, 0.4)
                ) -> Dict[str, torch.Tensor]:
    """Per level, over the whole batch: 1 − CIoU over the level's
    positives, objectness BCE against the detached CIoU clipped to [0, 1]
    over every slot (weighted by ``balance``), class BCE over the
    positives' classes (only with more than one class); then the gains.
    The reference's final ``· batch`` factor is left out, as in JAX."""
    decoded = decode_yolov5(raw, grid)
    targets = build_targets(grid, gt_boxes, gt_labels, gt_valid)
    pos = targets["pos"].to(torch.float32)                   # (B, A)
    mg = targets["matched_gt"]
    tgt_boxes = torch.gather(gt_boxes, 1, mg[..., None].expand(-1, -1, 4))
    ciou = box_ops.elementwise_box_iou(decoded[..., :4], tgt_boxes, "ciou")
    obj_t = torch.where(pos > 0, ciou.detach().clamp(0.0, 1.0), 0.0)
    obj_bce = L.binary_cross_entropy(raw[..., 4], obj_t, reduction="none")
    cls_t = F.one_hot(torch.gather(gt_labels, 1, mg).long(),
                      num_classes).to(torch.float32)
    cls_bce = L.binary_cross_entropy(raw[..., 5:], cls_t, reduction="none")
    box_loss = raw.new_zeros(())
    obj_loss = raw.new_zeros(())
    cls_loss = raw.new_zeros(())
    for li, s in enumerate(STRIDES):
        m = (grid["stride"] == s).to(torch.float32)          # (A,)
        n_slots = m.sum().clamp(min=1.0)
        pm = pos * m
        denom = pm.sum().clamp(min=1.0)
        box_loss = box_loss + torch.sum((1.0 - ciou) * pm) / denom
        obj_loss = obj_loss + (torch.sum(obj_bce * m)
                               / (raw.shape[0] * n_slots)) \
            * balance[min(li, len(balance) - 1)]
        if num_classes > 1:
            cls_loss = cls_loss + torch.sum(cls_bce * pm[..., None]) \
                / (denom * num_classes)
    return {"box_loss": box_gain * box_loss,
            "obj_loss": obj_gain * obj_loss,
            "cls_loss": cls_gain * cls_loss}


def yolov5_postprocess(raw: torch.Tensor, grid: Dict[str, torch.Tensor],
                       score_thresh: float = 0.25, nms_thresh: float = 0.45,
                       max_det: int = 100,
                       nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Decode, then YOLOX's scoring and one class-aware NMS launch a
    batch: score = σ(obj) · max σ(cls), label its argmax."""
    return postprocess_decoded(decode_yolov5(raw, grid),
                               score_thresh=score_thresh,
                               nms_thresh=nms_thresh, max_det=max_det,
                               nms_impl=nms_impl)


def kmean_anchors(wh: np.ndarray, n: int = 9,
                  iterations: int = 30, seed: int = 0) -> np.ndarray:
    """Autoanchor: k-means++ then plain k-means over the gt (w, h) of at
    least 2 px, the centres sorted by area."""
    rng = np.random.default_rng(seed)
    wh = np.asarray(wh, np.float64)
    wh = wh[(wh >= 2.0).all(1)]
    centers = [wh[rng.integers(len(wh))]]
    for _ in range(n - 1):
        d2 = np.min([np.sum((wh - c) ** 2, 1) for c in centers], axis=0)
        probs = d2 / d2.sum()
        centers.append(wh[rng.choice(len(wh), p=probs)])
    centers = np.stack(centers)
    for _ in range(iterations):
        d = np.linalg.norm(wh[:, None] - centers[None], axis=-1)
        assign = np.argmin(d, 1)
        for k in range(n):
            sel = wh[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    return centers[np.argsort(centers.prod(1))]


def check_anchors(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0
                  ) -> dict:
    """Best-possible recall of ``anchors`` over the gt (w, h): {bpr, the
    share of gts some anchor matches within ``thr`` on its worse side;
    aat, the anchors above that threshold a gt}. The reference recomputes
    anchors when bpr < 0.98."""
    wh = np.asarray(wh, np.float64)
    wh = wh[(wh > 0).all(1)]
    if len(wh) == 0:
        raise ValueError(
            "check_anchors: no valid gt boxes (all empty or non-positive "
            "wh) — a nan BPR would silently pass the < 0.98 gate")
    anchors = np.asarray(anchors, np.float64).reshape(-1, 2)
    r = wh[:, None] / anchors[None]                    # (G, A, 2)
    x = np.minimum(r, 1.0 / r).min(2)                  # worse side
    best = x.max(1)
    return {"bpr": float((best > 1.0 / thr).mean()),
            "aat": float((x > 1.0 / thr).sum(1).mean())}


_VARIANTS = {"yolov5s": (0.33, 0.5), "yolov5m": (0.67, 0.75),
             "yolov5l": (1.0, 1.0), "yolov5x": (1.33, 1.25)}


def _factory(name: str, depth: float, width: float):
    @MODELS.register(name)
    def build(num_classes: int = 80, **kw):
        defaults = dict(depth_mult=depth, width_mult=width)
        return YOLOv5(num_classes=num_classes, **{**defaults, **kw})
    build.__name__ = name
    return build


for _name, (_d, _w) in _VARIANTS.items():
    _factory(_name, _d, _w)
