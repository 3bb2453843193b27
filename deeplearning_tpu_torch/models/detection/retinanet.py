"""RetinaNet: the port of ``deeplearning_tpu/models/detection/retinanet.py``:
the network, the anchors, the postprocess and the loss.

A ResNet backbone (c3-c5), an FPN with P6/P7 convs, and two shared towers
(four 3×3 convs + ReLU, then a 3×3 prediction: K·A sigmoid logits with a
1% prior bias, or 4·A box deltas). Parameter names are flax's, so a flax
tree converts one to one (``utils/convert.from_flax_params``). Each
level's predictions are permuted to NHWC before the reshape that
enumerates anchors, so row a of ``cls_logits`` / ``bbox_deltas`` is anchor
a of ``retinanet_anchors``, in (y, x, anchor) order, levels p3..p7.

``retinanet_postprocess`` keeps the JAX arithmetic over the whole batch
in one call: sigmoid scores, the top 1 000 of the image's (anchor, class)
pairs with JAX's tie order (``ops/topk.topk_stable``), decode, clip, one
class-aware NMS launch a batch (``ops/nms.batched_nms``: K3 on the card).

``retinanet_loss`` matches every anchor of every image in one call
(``ops/matcher.match_anchors`` at 0.5 / 0.4 with low-quality matches):
the focal loss over the anchors that are not ignored, plain L1 (not
smooth-L1) on the positives' encoded deltas, both normalised by each
image's own positives (at least 1), then averaged over the batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import anchors as anc
from ...ops import boxes as box_ops
from ...ops import losses as L
from ...ops import matcher as M
from ...ops import nms as nms_ops
from ...ops.topk import topk_stable
from ..classification.resnet import ResNet
from ..layers import conv, init_flax_
from .fpn import FPN

__all__ = ["RetinaHead", "RetinaNet", "retinanet_anchors",
           "retinanet_loss", "retinanet_postprocess", "nhwc_rows"]

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def nhwc_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, A·width, H, W) → (B, H·W·A, width) rows in (y, x, a) order: the
    flax NHWC reshape of a per-location prediction."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class RetinaHead(nn.Module):
    """Shared-conv classification or regression tower: ``channels`` wide
    (256, as the flax head, whatever the pyramid's width), reading
    ``in_channels`` (default ``channels``)."""

    def __init__(self, num_outputs: int, num_convs: int = 4,
                 channels: int = 256, prior_bias: Optional[float] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 in_channels: Optional[int] = None):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            cin = (in_channels or channels) if i == 0 else channels
            setattr(self, f"conv{i}", nn.Conv2d(cin, channels, 3,
                                                padding=1))
        self.pred = nn.Conv2d(channels, num_outputs, 3, padding=1)
        self.prior_bias, self.dtype = prior_bias, dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The prediction conv: normal(0.01) kernel, the prior bias (or
        0); the tower keeps flax's defaults."""
        self.pred.weight.normal_(0.0, 0.01, generator=generator)
        self.pred.bias.fill_(self.prior_bias or 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(conv(x, getattr(self, f"conv{i}"), self.dtype))
        return conv(x, self.pred, self.dtype)


class RetinaNet(nn.Module):
    """Input (B, H, W, 3) NHWC float32; returns {cls_logits (B, A, K),
    bbox_deltas (B, A, 4)} float32 and the levels' ``feature_shapes``."""

    def __init__(self, num_classes: int = 20,
                 backbone_sizes: Sequence[int] = (3, 4, 6, 3),
                 anchors_per_loc: int = 9, fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_frozen_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNet(backbone_sizes, return_features=True,
                               dtype=dtype, frozen_bn=backbone_frozen_bn)
        c = self.backbone.out_channels
        self.fpn = FPN({"c3": c // 4, "c4": c // 2, "c5": c}, fpn_channels,
                       "p6p7", dtype)
        self.cls_head = RetinaHead(num_classes * anchors_per_loc,
                                   in_channels=fpn_channels,
                                   prior_bias=PRIOR_BIAS, dtype=dtype)
        self.reg_head = RetinaHead(4 * anchors_per_loc,
                                   in_channels=fpn_channels, dtype=dtype)
        self.num_classes = num_classes
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_flax_(self.fpn, generator)
        init_flax_(self.cls_head, generator)
        init_flax_(self.reg_head, generator)
        self.backbone.init_weights(generator)
        self.cls_head.init_weights(generator)
        self.reg_head.init_weights(generator)

    def forward(self, images: torch.Tensor) -> Dict:
        feats = self.backbone(images)
        pyramid = self.fpn({k: feats[k] for k in ("c3", "c4", "c5")})
        cls_logits, bbox_deltas, shapes = [], [], {}
        for name, f in pyramid.items():
            shapes[name] = tuple(f.shape[2:])
            cls_logits.append(nhwc_rows(self.cls_head(f),
                                        self.num_classes).float())
            bbox_deltas.append(nhwc_rows(self.reg_head(f), 4).float())
        return {"cls_logits": torch.cat(cls_logits, dim=1),
                "bbox_deltas": torch.cat(bbox_deltas, dim=1),
                "feature_shapes": shapes}


def retinanet_anchors(image_hw: Tuple[int, int]) -> np.ndarray:
    """All-level anchors for a fixed image size (host-side constant)."""
    h, w = image_hw
    shapes = {f"p{l}": (math.ceil(h / 2 ** l), math.ceil(w / 2 ** l))
              for l in (3, 4, 5, 6, 7)}
    strides = {k: 2 ** int(k[1]) for k in shapes}
    all_anchors, _ = anc.pyramid_anchors(shapes, strides,
                                         anc.retinanet_sizes())
    return all_anchors


def retinanet_loss(outputs: Dict, anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{cls_loss, reg_loss}: the focal loss and the L1 loss, each per
    image over its positives, averaged over the batch. anchors (A, 4);
    gt_boxes (B, G, 4), gt_labels (B, G), gt_valid (B, G)."""
    cls_logits, deltas = outputs["cls_logits"], outputs["bbox_deltas"]
    num_classes = cls_logits.shape[-1]
    with torch.no_grad():
        iou = box_ops.box_iou(gt_boxes, anchors)                # (B, G, A)
        matches = M.match_anchors(iou, gt_valid, 0.5, 0.4,
                                  allow_low_quality=True)       # (B, A)
    pos = matches >= 0
    ignore = matches == M.BETWEEN
    safe = torch.clamp(matches, min=0)
    target_cls = F.one_hot(gt_labels.gather(1, safe).long(),
                           num_classes).float() * pos[..., None]
    cls_loss = L.sigmoid_focal_loss(cls_logits, target_cls,
                                    reduction="none")
    cls_loss = torch.sum(cls_loss * (~ignore)[..., None], dim=(1, 2))
    matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, 4))
    reg_targets = box_ops.encode_boxes(matched, anchors)
    reg_loss = torch.sum(torch.abs(deltas - reg_targets) * pos[..., None],
                         dim=(1, 2))
    num_pos = torch.clamp(pos.sum(1), min=1)
    return {"cls_loss": torch.mean(cls_loss / num_pos),
            "reg_loss": torch.mean(reg_loss / num_pos)}


def retinanet_postprocess(outputs: Dict, anchors: torch.Tensor,
                          image_hw: Tuple[int, int],
                          score_thresh: float = 0.05,
                          nms_thresh: float = 0.5,
                          topk_candidates: int = 1000,
                          max_det: int = 100,
                          nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Sigmoid scores → top-k (anchor, class) pairs an image → decode →
    clip → class-aware NMS → {boxes (B, max_det, 4), scores, labels (−1
    on padded slots), valid}."""
    cls_logits, deltas = outputs["cls_logits"], outputs["bbox_deltas"]
    b, _, nc = cls_logits.shape
    flat = torch.sigmoid(cls_logits).reshape(b, -1)
    top_scores, top_idx = topk_stable(flat, min(topk_candidates,
                                                flat.shape[1]))
    anchor_idx = top_idx // nc
    class_idx = top_idx % nc
    boxes = box_ops.decode_boxes(
        deltas.gather(1, anchor_idx[..., None].expand(-1, -1, 4)),
        anchors[anchor_idx])
    boxes = box_ops.clip_boxes(boxes, image_hw)
    keep_idx, keep_valid = nms_ops.batched_nms(
        boxes, top_scores, class_idx, nms_thresh, max_det,
        score_threshold=score_thresh, impl=nms_impl)
    out_boxes, out_scores, out_classes = nms_ops.gather_nms_outputs(
        keep_idx, keep_valid, boxes, top_scores, class_idx,
        fill=(0, 0, -1))
    return {"boxes": out_boxes, "scores": out_scores, "labels": out_classes,
            "valid": keep_valid}


@MODELS.register("retinanet_resnet50_fpn")
def retinanet_resnet50_fpn(num_classes: int = 20, **kw):
    return RetinaNet(num_classes=num_classes, **kw)


@MODELS.register("retinanet_resnet18_fpn")
def retinanet_resnet18_fpn(num_classes: int = 20, **kw):
    # small variant for tests and smoke runs (bottleneck blocks 2/2/2/2)
    return RetinaNet(num_classes=num_classes, backbone_sizes=(2, 2, 2, 2),
                     **kw)
