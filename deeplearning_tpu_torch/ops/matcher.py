"""Anchor-to-gt matching as a fixed-shape op — the port of
``match_anchors`` in ``deeplearning_tpu/ops/matcher.py``.

The IoU-threshold assignment of torchvision's ``Matcher`` with
``allow_low_quality_matches``: gt boxes are padded to a fixed count with a
validity mask, and a match is a gt index or one of the codes
``BELOW_LOW`` / ``BETWEEN``. Any leading batch dimensions pass through,
so a batch of images is matched in one call with no host sync.
``balanced_sample`` is Faster R-CNN's sampler: an exact-count random
subset under fixed shapes, its uniform keys drawn with ``torch.rand`` from
the step's ``torch.Generator`` (JAX draws them from ``jax.random``, so one
seed gives other subsets; the counts and the candidates hold in both).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["BELOW_LOW", "BETWEEN", "match_anchors", "balanced_sample"]

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


def _pick(cand: torch.Tensor, keys: torch.Tensor,
          limit: Union[int, torch.Tensor]) -> torch.Tensor:
    """The ``min(#cand, limit)`` candidates of highest key, a row at a
    time: a rank from a descending sort, kept where below the count."""
    n_cand = cand.sum(dim=-1, keepdim=True)
    # an int limit clamps on the device: a host scalar made a tensor on
    # the card would be a synchronising copy
    take = (n_cand.clamp(max=limit) if isinstance(limit, int)
            else torch.minimum(n_cand, limit))
    scores = torch.where(cand, keys, torch.full_like(keys, -1.0))
    order = torch.argsort(scores, dim=-1, descending=True)
    ranks = torch.arange(cand.shape[-1], device=cand.device
                         ).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    return cand & (rank < take)


def balanced_sample(matches: torch.Tensor, generator: torch.Generator,
                    batch_size_per_image: int, positive_fraction: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """matches (..., A) → (pos_mask, neg_mask) (..., A) bool: up to
    ``int(batch_size_per_image · positive_fraction)`` positives (matches
    >= 0) and ``batch_size_per_image`` less the positives taken of
    negatives (``BELOW_LOW``), each a uniform random subset of its
    candidates; ``BETWEEN`` is never sampled. Positive keys are drawn
    first, then negative keys, from ``generator`` (on the matches'
    device). No host sync: the counts stay on the device."""
    dev = matches.device
    pos_cand = matches >= 0
    neg_cand = matches == BELOW_LOW
    num_pos_target = int(batch_size_per_image * positive_fraction)
    pos_keys = torch.rand(matches.shape, generator=generator, device=dev)
    neg_keys = torch.rand(matches.shape, generator=generator, device=dev)
    pos = _pick(pos_cand, pos_keys, num_pos_target)
    num_pos = pos.sum(dim=-1, keepdim=True)
    neg = _pick(neg_cand, neg_keys, batch_size_per_image - num_pos)
    return pos, neg
