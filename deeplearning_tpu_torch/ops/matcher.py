"""Anchor-to-gt matching as a fixed-shape op — the port of
``match_anchors`` in ``deeplearning_tpu/ops/matcher.py``.

The IoU-threshold assignment of torchvision's ``Matcher`` with
``allow_low_quality_matches``: gt boxes are padded to a fixed count with a
validity mask, and a match is a gt index or one of the codes
``BELOW_LOW`` / ``BETWEEN``. Any leading batch dimensions pass through,
so a batch of images is matched in one call with no host sync.
``balanced_sample`` (Faster R-CNN's sampler) comes with ROADMAP Queue 1
item 5d.
"""

from __future__ import annotations

import torch

__all__ = ["BELOW_LOW", "BETWEEN", "match_anchors"]

BELOW_LOW = -1
BETWEEN = -2


def match_anchors(iou: torch.Tensor, gt_valid: torch.Tensor,
                  high_threshold: float, low_threshold: float,
                  allow_low_quality: bool = True) -> torch.Tensor:
    """iou (..., G, A) with padded gt rows masked by gt_valid (..., G) →
    matches (..., A) int64: the gt index, or BELOW_LOW / BETWEEN. Ties
    take the first gt, as ``jnp.argmax`` does."""
    iou = torch.where(gt_valid[..., :, None], iou, -1.0)
    best_gt = torch.argmax(iou, dim=-2)                     # (..., A)
    best_iou = torch.amax(iou, dim=-2)
    matches = torch.where(
        best_iou >= high_threshold, best_gt,
        torch.where(best_iou >= low_threshold, BETWEEN, BELOW_LOW))
    if allow_low_quality:
        # force-match each valid gt's highest-IoU anchors (ties within
        # 1e-7 included) to the anchor's OWN best gt, as torchvision
        # restores its pre-threshold match
        best_anchor_iou = torch.amax(iou, dim=-1, keepdim=True)  # (..., G, 1)
        is_best = ((iou >= best_anchor_iou - 1e-7) & (best_anchor_iou > 0)
                   & gt_valid[..., :, None])
        matches = torch.where(is_best.any(dim=-2), best_gt, matches)
    return matches
