"""FCOS: the port of ``deeplearning_tpu/models/detection/fcos.py``: the
network, the locations, the training targets and loss, and the
postprocess.

Anchor-free per-pixel detection with centre-ness: a ResNet backbone
(c3-c5), an FPN with P6/P7 convs, and one head shared by the five levels
(four 3×3 convs + ReLU a tower, class / centre-ness / box predictions,
and a learnable per-level scale on the clipped exp of the box branch).
Parameter names are flax's; ``ScaleExp``'s flax ``scale`` is its
``weight`` here, as the converter maps every ``scale``. Predictions are
permuted to NHWC before the reshape that enumerates locations, so row i
is location i of ``fcos_locations``, levels at strides 8..128.

Training: ``fcos_targets`` makes a location positive when it lies inside
a gt, within 1.5 strides of its centre, and its largest side distance
falls in its level's range; several gts resolve to the smallest.
``fcos_loss`` is the focal loss over the positives' count, the
centre-ness BCE on the positives and a GIoU loss weighted by the
centre-ness target. Both are batched over the images (JAX vmaps a
per-image function).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import boxes as box_ops
from ...ops import losses as L
from ...ops import nms as nms_ops
from ...ops.topk import topk_stable
from ..classification.resnet import ResNet
from ..layers import conv, init_flax_
from .fpn import FPN
from .retinanet import PRIOR_BIAS, nhwc_rows

__all__ = ["LEVEL_RANGES", "STRIDES", "ScaleExp", "FCOSHead", "FCOS",
           "fcos_locations", "fcos_targets", "fcos_loss",
           "fcos_postprocess"]

# per-level regression ranges (used by the training targets)
LEVEL_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
STRIDES = (8, 16, 32, 64, 128)


class ScaleExp(nn.Module):
    """exp(clip(x · scale, −10, 8)), one learnable scale (flax ``scale``,
    initialised to 1)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(torch.clamp(x * self.weight, -10.0, 8.0))


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int, num_convs: int = 4,
                 channels: int = 256, num_levels: int = len(STRIDES),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_convs, self.num_classes, self.dtype = (num_convs,
                                                        num_classes, dtype)
        for tower in ("cls", "reg"):
            for i in range(num_convs):
                setattr(self, f"{tower}_conv{i}",
                        nn.Conv2d(channels, channels, 3, padding=1))
        self.cls_pred = nn.Conv2d(channels, num_classes, 3, padding=1)
        self.ctr_pred = nn.Conv2d(channels, 1, 3, padding=1)
        self.reg_pred = nn.Conv2d(channels, 4, 3, padding=1)
        for li in range(num_levels):
            setattr(self, f"scale{li}", ScaleExp())

    def _tower(self, x: torch.Tensor, tower: str) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(conv(x, getattr(self, f"{tower}_conv{i}"),
                            self.dtype))
        return x

    def forward(self, feats: Dict[str, torch.Tensor]):
        cls_out, ctr_out, reg_out = [], [], []
        for li, name in enumerate(sorted(feats, key=lambda k: int(k[1:]))):
            x = feats[name]
            c = self._tower(x, "cls")
            r = self._tower(x, "reg")
            cls_out.append(nhwc_rows(conv(c, self.cls_pred, self.dtype),
                                     self.num_classes).float())
            ctr_out.append(nhwc_rows(conv(r, self.ctr_pred, self.dtype),
                                     1)[..., 0].float())
            ltrb = getattr(self, f"scale{li}")(
                conv(r, self.reg_pred, self.dtype).float())
            reg_out.append(nhwc_rows(ltrb, 4))
        return (torch.cat(cls_out, 1), torch.cat(ctr_out, 1),
                torch.cat(reg_out, 1))


class FCOS(nn.Module):
    """Input (B, H, W, 3) NHWC float32; returns {cls_logits (B, L, K),
    centerness (B, L), ltrb (B, L, 4)} float32."""

    def __init__(self, num_classes: int = 20,
                 backbone_sizes: Sequence[int] = (3, 4, 6, 3),
                 fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNet(backbone_sizes, return_features=True,
                               dtype=dtype)
        c = self.backbone.out_channels
        self.fpn = FPN({"c3": c // 4, "c4": c // 2, "c5": c}, fpn_channels,
                       "p6p7", dtype)
        self.head = FCOSHead(num_classes, channels=fpn_channels, dtype=dtype)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults, the class prediction's 1% prior bias, every
        level's scale 1."""
        self.backbone.init_weights(generator)
        init_flax_(self.fpn, generator)
        init_flax_(self.head, generator)
        self.head.cls_pred.bias.fill_(PRIOR_BIAS)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(images)
        pyramid = self.fpn({k: feats[k] for k in ("c3", "c4", "c5")})
        cls_logits, centerness, ltrb = self.head(pyramid)
        return {"cls_logits": cls_logits, "centerness": centerness,
                "ltrb": ltrb}


def fcos_locations(image_hw: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """All-level (x, y) centres + per-location level index."""
    h, w = image_hw
    locs, lvl = [], []
    for li, s in enumerate(STRIDES):
        fh, fw = math.ceil(h / s), math.ceil(w / s)
        ys, xs = np.mgrid[0:fh, 0:fw].astype(np.float32)
        pts = np.stack([(xs + 0.5) * s, (ys + 0.5) * s],
                       axis=-1).reshape(-1, 2)
        locs.append(pts)
        lvl.append(np.full(len(pts), li))
    return np.concatenate(locs), np.concatenate(lvl)


@functools.lru_cache(maxsize=None)
def _level_tables(device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``LEVEL_RANGES`` and ``STRIDES`` as float32 tensors on ``device``,
    made once: a host table copied to the card every step would
    synchronise."""
    return (torch.tensor(LEVEL_RANGES, dtype=torch.float32, device=device),
            torch.tensor(STRIDES, dtype=torch.float32, device=device))


def fcos_targets(locations: torch.Tensor, level_idx: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, center_radius: float = 1.5
                 ) -> Dict[str, torch.Tensor]:
    """Targets of every location (L,) for each image: {cls (B, L), −1 the
    background; reg (B, L, 4) ltrb; ctr (B, L) centre-ness; pos (B, L)}.
    Ties in area take the first gt, as ``jnp.argmin`` does."""
    range_table, stride_table = _level_tables(locations.device)
    ranges = range_table[level_idx]                          # (L, 2)
    strides = stride_table[level_idx][:, None]               # (L, 1)
    x = locations[:, 0][:, None]                             # (L, 1)
    y = locations[:, 1][:, None]
    bx = gt_boxes[:, None]                                   # (B, 1, G, 4)
    ltrb = torch.stack([x - bx[..., 0], y - bx[..., 1], bx[..., 2] - x,
                        bx[..., 3] - y], dim=-1)             # (B, L, G, 4)
    in_box = ltrb.amin(dim=-1) > 0
    max_reg = ltrb.amax(dim=-1)
    in_level = (max_reg >= ranges[:, 0:1]) & (max_reg <= ranges[:, 1:2])
    cx = (bx[..., 0] + bx[..., 2]) / 2
    cy = (bx[..., 1] + bx[..., 3]) / 2
    near = ((torch.abs(x - cx) <= center_radius * strides)
            & (torch.abs(y - cy) <= center_radius * strides))
    cand = in_box & in_level & near & gt_valid[:, None, :]
    area = box_ops.box_area(gt_boxes)[:, None, :]            # (B, 1, G)
    area_mat = torch.where(cand, area, torch.full_like(area, math.inf))
    best_gt = torch.argmin(area_mat, dim=-1)                 # (B, L)
    pos = cand.any(dim=-1)
    cls_target = torch.where(pos, torch.gather(gt_labels, 1, best_gt), -1)
    b, n = best_gt.shape
    reg_target = torch.gather(
        ltrb, 2, best_gt.reshape(b, n, 1, 1).expand(b, n, 1, 4))[:, :, 0]
    # slices, not index lists: a list index is a host tensor copied to the
    # card, which synchronises
    lr = reg_target[..., 0::2]                               # (l, r)
    tb = reg_target[..., 1::2]                               # (t, b)
    ctr_target = torch.sqrt(torch.clamp(
        (lr.amin(-1) / lr.amax(-1).clamp(min=1e-9))
        * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-9)), 0, 1))
    return {"cls": cls_target, "reg": reg_target, "ctr": ctr_target,
            "pos": pos}


def fcos_loss(outputs: Dict[str, torch.Tensor],
              targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per image: focal loss summed over the positives' count, centre-ness
    BCE on the positives (over the same count), and 1 − GIoU of the
    ltrb boxes weighted by the centre-ness target; then the batch's
    means."""
    cls_logits, ctr, ltrb = (outputs["cls_logits"], outputs["centerness"],
                             outputs["ltrb"])
    tgt_cls, tgt_reg, tgt_ctr = targets["cls"], targets["reg"], targets["ctr"]
    pos = targets["pos"].to(torch.float32)
    fg = tgt_cls >= 0
    onehot = F.one_hot(torch.where(fg, tgt_cls, 0).long(),
                       cls_logits.shape[-1]).to(torch.float32) * fg[..., None]
    n_pos = pos.sum(dim=1)
    num_pos = n_pos.clamp(min=1)
    cls_loss = L.sigmoid_focal_loss(cls_logits, onehot, reduction="none"
                                    ).sum(dim=(1, 2)) / num_pos
    bce = L.binary_cross_entropy(ctr, tgt_ctr, reduction="none")
    ctr_loss = (torch.sum(bce * pos, dim=1) / n_pos.clamp(min=1.0)) \
        * n_pos / num_pos

    def corners(d):
        return torch.stack([-d[..., 0], -d[..., 1], d[..., 2], d[..., 3]],
                           dim=-1)
    giou = box_ops.elementwise_box_iou(corners(ltrb), corners(tgt_reg),
                                       "giou")
    w = pos * tgt_ctr
    reg_loss = torch.sum((1 - giou) * w, dim=1) / w.sum(dim=1).clamp(
        min=1e-6)
    return {"cls_loss": cls_loss.mean(), "ctr_loss": ctr_loss.mean(),
            "reg_loss": reg_loss.mean()}


def fcos_postprocess(outputs: Dict, locations: torch.Tensor,
                     image_hw: Tuple[int, int], score_thresh: float = 0.05,
                     nms_thresh: float = 0.6, topk: int = 1000,
                     max_det: int = 100,
                     nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """sqrt(σ(cls) · σ(ctr)) scores → boxes from the locations and ltrb →
    clip → top-k (location, class) pairs (JAX's tie order) → one
    class-aware NMS launch a batch."""
    cls_logits, ctr, ltrb = (outputs["cls_logits"], outputs["centerness"],
                             outputs["ltrb"])
    b, _, nc = cls_logits.shape
    scores = torch.sqrt(torch.sigmoid(cls_logits)
                        * torch.sigmoid(ctr)[..., None])
    boxes = torch.stack([
        locations[:, 0] - ltrb[..., 0], locations[:, 1] - ltrb[..., 1],
        locations[:, 0] + ltrb[..., 2], locations[:, 1] + ltrb[..., 3]],
        dim=-1)
    boxes = box_ops.clip_boxes(boxes, image_hw)
    flat = scores.reshape(b, -1)
    top_s, top_i = topk_stable(flat, min(topk, flat.shape[1]))
    loc_i = top_i // nc
    cls_i = top_i % nc
    cand = boxes.gather(1, loc_i[..., None].expand(-1, -1, 4))
    keep_idx, keep_valid = nms_ops.batched_nms(
        cand, top_s, cls_i, nms_thresh, max_det,
        score_threshold=score_thresh, impl=nms_impl)
    bsel, ssel, csel = nms_ops.gather_nms_outputs(
        keep_idx, keep_valid, cand, top_s, cls_i, fill=(0, 0, -1))
    return {"boxes": bsel, "scores": ssel, "labels": csel,
            "valid": keep_valid}


@MODELS.register("fcos_resnet50_fpn")
def fcos_resnet50_fpn(num_classes: int = 20, **kw):
    return FCOS(num_classes=num_classes, **kw)


@MODELS.register("fcos_resnet18_fpn")
def fcos_resnet18_fpn(num_classes: int = 20, **kw):
    return FCOS(num_classes=num_classes, backbone_sizes=(2, 2, 2, 2), **kw)
