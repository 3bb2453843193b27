"""Faster R-CNN: the port of
``deeplearning_tpu/models/detection/faster_rcnn.py`` (serving half: the
network, the anchors, the proposals and the postprocess).

A ResNet backbone (c2-c5), an FPN with the pooled P6, an RPN head shared
by p2..p6 (3×3 conv + ReLU, objectness and box deltas, normal(0.01)
kernels), 7×7 RoIAlign over p2..p5 (``ops/roi_align``), a two-layer MLP
box head and the class / box predictor. Parameter names are flax's. The
RPN's outputs are permuted to NHWC before the reshape, so they enumerate
(y, x, anchor) as ``fasterrcnn_anchors`` does; the RoI features are
(R, 7, 7, C) and ``TwoMLPHead`` flattens them in that (H, W, C) order, so
``fc6``'s converted weight needs no permutation.

The two-call API is JAX's: ``model(images)`` returns the pyramid and the
RPN heads; ``model(images, proposals=..., pyramid=out["pyramid"])`` runs
the RoI stage on that pyramid without recomputing the backbone. Every
stage keeps a fixed shape: per-level top-k (JAX's tie order) and one NMS
launch a batch to ``post_nms_top_n`` proposals with a validity mask, then
one class-aware NMS launch a batch over the (proposal, class) pairs, the
padded proposals masked out (−∞ scores), since zero-area padded boxes do
not suppress each other.

``rpn_loss``, ``sample_rois`` and ``roi_head_loss`` (training) come with
the detection training slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import anchors as anc
from ...ops import boxes as box_ops
from ...ops import nms as nms_ops
from ...ops.roi_align import multiscale_roi_align
from ...ops.topk import topk_stable
from ..classification.resnet import ResNet
from ..layers import conv, dense, init_flax_
from .fpn import FPN
from .retinanet import nhwc_rows

__all__ = ["RPNHead", "TwoMLPHead", "FastRCNNPredictor", "FasterRCNN",
           "fasterrcnn_anchors", "generate_proposals",
           "fasterrcnn_postprocess"]


class RPNHead(nn.Module):
    def __init__(self, channels: int, anchors_per_loc: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, anchors_per_loc, 1)
        self.deltas = nn.Conv2d(channels, 4 * anchors_per_loc, 1)
        self.dtype = dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.conv, self.objectness, self.deltas):
            layer.weight.normal_(0.0, 0.01, generator=generator)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(conv(x, self.conv, self.dtype))
        obj = conv(x, self.objectness, self.dtype)
        deltas = conv(x, self.deltas, self.dtype)
        return (nhwc_rows(obj, 1)[..., 0].float(),
                nhwc_rows(deltas, 4).float())


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, hidden: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc6 = nn.Linear(in_features, hidden)
        self.fc7 = nn.Linear(hidden, hidden)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)            # (R, S·S·C), HWC order
        x = F.relu(dense(x, self.fc6, self.dtype))
        return F.relu(dense(x, self.fc7, self.dtype))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, 4 * num_classes)
        self.num_classes, self.dtype = num_classes, dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = dense(x, self.cls_score, self.dtype)
        deltas = dense(x, self.bbox_pred, self.dtype)
        return scores.float(), deltas.reshape(
            x.shape[0], self.num_classes, 4).float()


class FasterRCNN(nn.Module):
    """Input (B, H, W, 3) NHWC float32. ``num_classes`` includes the
    background class 0."""

    def __init__(self, num_classes: int = 21,
                 backbone_sizes: Sequence[int] = (3, 4, 6, 3),
                 fpn_channels: int = 256, anchors_per_loc: int = 3,
                 roi_output_size: int = 7, roi_align_impl: str = "onepass",
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_frozen_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNet(backbone_sizes, return_features=True,
                               dtype=dtype, frozen_bn=backbone_frozen_bn)
        c = self.backbone.out_channels
        self.fpn = FPN({"c2": c // 8, "c3": c // 4, "c4": c // 2, "c5": c},
                       fpn_channels, "pool", dtype)
        self.rpn = RPNHead(fpn_channels, anchors_per_loc, dtype)
        s = roi_output_size
        self.box_head = TwoMLPHead(s * s * fpn_channels, dtype=dtype)
        self.box_predictor = FastRCNNPredictor(1024, num_classes, dtype)
        self.num_classes, self.roi_output_size = num_classes, s
        self.roi_align_impl, self.dtype = roi_align_impl, dtype
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        for m in (self.fpn, self.box_head, self.box_predictor):
            init_flax_(m, generator)
        self.rpn.init_weights(generator)

    def forward(self, images: torch.Tensor,
                proposals: Optional[torch.Tensor] = None,
                pyramid: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """Without ``pyramid``: {pyramid, rpn_obj (B, A), rpn_deltas
        (B, A, 4), level_counts}. With ``proposals`` (B, P, 4): also
        {roi_scores (B, P, K), roi_deltas (B, P, K, 4)}, on the given
        ``pyramid`` when there is one."""
        if pyramid is None:
            pyramid = self.fpn(self.backbone(images))
            obj, deltas, counts = [], [], []
            for f in pyramid.values():
                o, d = self.rpn(f)
                obj.append(o)
                deltas.append(d)
                counts.append(o.shape[1])
            out = {"pyramid": pyramid, "rpn_obj": torch.cat(obj, dim=1),
                   "rpn_deltas": torch.cat(deltas, dim=1),
                   "level_counts": counts}
        else:
            out = {"pyramid": pyramid}
        if proposals is not None:
            scores, box_deltas = self.roi_heads(pyramid, proposals)
            out["roi_scores"], out["roi_deltas"] = scores, box_deltas
        return out

    def roi_heads(self, pyramid: Dict[str, torch.Tensor],
                  proposals: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoIAlign over p2..p5 (the pooled P6 is the RPN's only), one
        image at a time (one image's float32 corner reads at a time), then
        the box head on the whole batch's RoIs."""
        levels = sorted(pyramid, key=lambda k: int(k[1:]))[:-1]
        strides = {k: 2 ** int(k[1:]) for k in levels}
        b, p = proposals.shape[:2]
        feats = [multiscale_roi_align(
            {k: pyramid[k][i].permute(1, 2, 0) for k in levels},
            proposals[i], self.roi_output_size, strides=strides,
            impl=self.roi_align_impl) for i in range(b)]
        roi_feats = torch.cat(feats, dim=0)           # (B·P, S, S, C) f32
        h = self.box_head(roi_feats.to(self.dtype))
        scores, deltas = self.box_predictor(h)
        return (scores.reshape(b, p, self.num_classes),
                deltas.reshape(b, p, self.num_classes, 4))


# ---------------------------------------------------------------- anchors
def fasterrcnn_anchors(image_hw: Tuple[int, int]) -> np.ndarray:
    """FPN anchors: one size per level ((32..512) × 3 ratios) on p2..p6."""
    h, w = image_hw
    shapes = {f"p{l}": (math.ceil(h / 2 ** l), math.ceil(w / 2 ** l))
              for l in (2, 3, 4, 5, 6)}
    strides = {k: 2 ** int(k[1]) for k in shapes}
    sizes = {f"p{l}": (2 ** (l + 3),) for l in (2, 3, 4, 5, 6)}
    all_anchors, _ = anc.pyramid_anchors(shapes, strides, sizes)
    return all_anchors


# -------------------------------------------------------------- proposals
def generate_proposals(outputs: Dict, anchors: torch.Tensor,
                       image_hw: Tuple[int, int],
                       pre_nms_top_n: int = 1000,
                       post_nms_top_n: int = 256,
                       nms_thresh: float = 0.7,
                       min_size: float = 1.0,
                       nms_impl: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, post_nms_top_n, 4) proposals + validity: decode, clip, small
    boxes at −1e9, the top ``pre_nms_top_n`` of each level, then one
    class-agnostic NMS launch over the batch's candidates."""
    boxes = box_ops.decode_boxes(outputs["rpn_deltas"], anchors)
    boxes = box_ops.clip_boxes(boxes, image_hw)
    valid = box_ops.remove_small_boxes_mask(boxes, min_size)
    scores = torch.where(valid, outputs["rpn_obj"],
                         torch.full_like(outputs["rpn_obj"], -1e9))
    sel_boxes, sel_scores = [], []
    start = 0
    for count in outputs["level_counts"]:
        top_s, top_i = topk_stable(scores[:, start:start + count],
                                   min(pre_nms_top_n, count))
        lvl = boxes[:, start:start + count]
        sel_boxes.append(lvl.gather(1, top_i[..., None].expand(-1, -1, 4)))
        sel_scores.append(top_s)
        start += count
    cand_boxes = torch.cat(sel_boxes, dim=1)
    cand_scores = torch.cat(sel_scores, dim=1)
    keep_idx, keep_valid = nms_ops.nms(cand_boxes, cand_scores, nms_thresh,
                                       post_nms_top_n, score_threshold=-1e8,
                                       impl=nms_impl)
    props, = nms_ops.gather_nms_outputs(keep_idx, keep_valid, cand_boxes)
    return props, keep_valid


def fasterrcnn_postprocess(roi_scores: torch.Tensor, roi_deltas: torch.Tensor,
                           proposals: torch.Tensor,
                           image_hw: Tuple[int, int],
                           prop_valid: Optional[torch.Tensor] = None,
                           score_thresh: float = 0.05,
                           nms_thresh: float = 0.5,
                           max_det: int = 100,
                           nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Softmax → per-class decode → class-aware NMS → fixed ``max_det``
    slots; labels are the model's classes (1.., 0 the background), −1 on
    padded slots. ``prop_valid`` masks padded proposals out (−∞ scores)."""
    b, p, num_classes = roi_scores.shape
    if prop_valid is None:
        prop_valid = torch.ones((b, p), dtype=torch.bool,
                                device=roi_scores.device)
    probs = torch.softmax(roi_scores, dim=-1)
    fg = torch.where(prop_valid[..., None], probs[..., 1:],
                     torch.full_like(probs[..., 1:], float("-inf")))
    fg = fg.reshape(b, -1)
    classes = torch.arange(1, num_classes, device=roi_scores.device
                           ).repeat(p)[None].expand(b, -1)
    boxes = box_ops.decode_boxes(
        roi_deltas[:, :, 1:].reshape(b, -1, 4),
        proposals.repeat_interleave(num_classes - 1, dim=1),
        weights=(10, 10, 5, 5))
    boxes = box_ops.clip_boxes(boxes, image_hw)
    keep_idx, keep_valid = nms_ops.batched_nms(
        boxes, fg, classes, nms_thresh, max_det,
        score_threshold=score_thresh, impl=nms_impl)
    out_boxes, out_scores, out_classes = nms_ops.gather_nms_outputs(
        keep_idx, keep_valid, boxes, fg, classes, fill=(0, 0, -1))
    return {"boxes": out_boxes, "scores": out_scores, "labels": out_classes,
            "valid": keep_valid}


@MODELS.register("fasterrcnn_resnet50_fpn")
def fasterrcnn_resnet50_fpn(num_classes: int = 21, **kw):
    return FasterRCNN(num_classes=num_classes, **kw)


@MODELS.register("fasterrcnn_resnet18_fpn")
def fasterrcnn_resnet18_fpn(num_classes: int = 21, **kw):
    return FasterRCNN(num_classes=num_classes,
                      backbone_sizes=(2, 2, 2, 2), **kw)
