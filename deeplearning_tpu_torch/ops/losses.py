"""Losses — the port of the part of ``deeplearning_tpu/ops/losses.py``
the classification and one-stage detection training steps use:
``cross_entropy`` (integer labels, label smoothing, labels < 0 ignored,
optional weights), ``soft_target_cross_entropy`` (mixup targets),
``binary_cross_entropy`` (with ``pos_weight``), ``sigmoid_focal_loss``
(RetinaNet) and ``smooth_l1``. They reduce with an explicit weight mask,
so padded or invalid rows drop out of the mean: the weighted mean divides
by ``max(sum(weights), 1)`` over the weights as given, before they
broadcast against the losses (an (A, 1) mask over (A, C) losses divides
by its A entries, not by A·C). ``safe_normalize`` serves Swin v2's cosine
attention. The dense-prediction, contrastive and metric-learning losses
(JAX ``ops/losses.py:96-227``): ``dice_coefficient``, ``dice_loss`` and
``ohem_cross_entropy`` (segmentation), ``supcon_loss`` (SupCon),
``triplet_loss``, ``arcface_logits`` and ``wnfc_logits`` (re-ID and
retrieval) and ``heatmap_mse_loss`` (pose). Images and maps are NHWC at
these functions, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "soft_target_cross_entropy",
           "binary_cross_entropy", "sigmoid_focal_loss", "smooth_l1",
           "safe_normalize", "dice_coefficient", "dice_loss",
           "ohem_cross_entropy", "supcon_loss", "triplet_loss",
           "arcface_logits", "wnfc_logits", "heatmap_mse_loss"]


def _weighted_mean(x: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return torch.mean(x)
    weights = weights.to(x.dtype)
    return torch.sum(x * weights) / torch.clamp(torch.sum(weights), min=1.0)


def _reduce(losses: torch.Tensor, weights: Optional[torch.Tensor],
            reduction: str) -> torch.Tensor:
    """none / sum / weighted-mean reduction shared by the loss family."""
    if weights is not None and reduction in ("none", "sum"):
        losses = losses * weights
    if reduction == "none":
        return losses
    if reduction == "sum":
        return torch.sum(losses)
    return _weighted_mean(losses, weights)


def _softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Per-row -sum(targets * log_softmax(logits)) (optax's formula)."""
    return -torch.sum(targets * F.log_softmax(logits, dim=-1), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer-label CE with optional smoothing (one-hot·(1-ε)+ε/K);
    labels < 0 are ignored (the ignore_index idiom)."""
    num_classes = logits.shape[-1]
    valid = labels >= 0
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    losses = _softmax_cross_entropy(logits, onehot)
    w = valid.to(logits.dtype)
    if weights is not None:
        w = w * weights.to(logits.dtype)
    return _weighted_mean(losses, w)


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """CE against soft targets (the mixup path)."""
    losses = _softmax_cross_entropy(logits, targets.to(logits.dtype))
    return _weighted_mean(losses, weights)


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         pos_weight: float = 1.0,
                         reduction: str = "mean") -> torch.Tensor:
    """-(pos_weight·t·log σ(x) + (1 - t)·log σ(-x)), elementwise."""
    losses = -(pos_weight * targets * F.logsigmoid(logits)
               + (1.0 - targets) * F.logsigmoid(-logits))
    return _reduce(losses, weights, reduction)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       weights: Optional[torch.Tensor] = None,
                       reduction: str = "mean") -> torch.Tensor:
    """RetinaNet's focal loss: the sigmoid cross-entropy scaled by
    (1 - p_t)^gamma and, where ``alpha`` >= 0, by alpha_t."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * torch.pow(1 - p_t, gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return _reduce(loss, weights, reduction)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9,
              weights: Optional[torch.Tensor] = None,
              reduction: str = "mean") -> torch.Tensor:
    """Huber / smooth-L1: 0.5·d²/beta below beta, d - 0.5·beta above."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, weights, reduction)


def safe_normalize(x: torch.Tensor, axis: int = -1,
                   eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize with a finite gradient at x == 0: x * rsqrt(max(|x|^2,
    eps^2)) keeps a zero row zero, with gradient x / eps, where the norm's
    derivative would be NaN."""
    sq = torch.sum(x * x, dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def dice_coefficient(probs: torch.Tensor, targets: torch.Tensor,
                     eps: float = 1e-6, spatial_axes=(-2, -1)) -> torch.Tensor:
    """Per-channel dice coefficient, averaged (U-Net dice_score.py)."""
    inter = torch.sum(probs * targets, dim=spatial_axes)
    denom = (torch.sum(probs, dim=spatial_axes)
             + torch.sum(targets, dim=spatial_axes))
    return torch.mean((2 * inter + eps) / (denom + eps))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              num_classes: Optional[int] = None) -> torch.Tensor:
    """Multiclass dice loss over softmax probabilities. logits (B, H, W,
    C); labels (B, H, W) int, < 0 ignored."""
    num_classes = num_classes or logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    valid = (labels >= 0)[..., None].to(logits.dtype)
    onehot = F.one_hot(torch.where(labels >= 0, labels,
                                   torch.zeros_like(labels)).long(),
                       num_classes).to(logits.dtype) * valid
    probs = probs * valid
    return 1.0 - dice_coefficient(torch.movedim(probs, -1, 1),
                                  torch.movedim(onehot, -1, 1))


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       thresh: float = 0.7,
                       min_kept: int = 100000) -> torch.Tensor:
    """Online hard-example mining CE (HR-Net-Seg OhemCrossEntropy): keep
    the pixels whose correct-class probability is at most
    max(thresh, the k-th smallest of them), k = min(min_kept · B, pixels)
    over the valid ones (ignored pixels sort last)."""
    b, num_classes = logits.shape[0], logits.shape[-1]
    flat_logits = logits.reshape(-1, num_classes)
    flat_labels = labels.reshape(-1)
    valid = flat_labels >= 0
    safe = torch.where(valid, flat_labels,
                       torch.zeros_like(flat_labels)).long()
    probs = torch.softmax(flat_logits, dim=-1)
    correct_p = probs.gather(1, safe[:, None])[:, 0]
    correct_p = torch.where(valid, correct_p,
                            torch.full_like(correct_p, float("inf")))
    k = min(min_kept * b, flat_labels.shape[0])
    kth = torch.sort(correct_p).values[k - 1]
    threshold = torch.clamp(kth, min=thresh)
    keep = valid & (correct_p <= threshold)
    losses = -F.log_softmax(flat_logits, dim=-1).gather(1, safe[:, None])[:, 0]
    return _weighted_mean(losses, keep)


def supcon_loss(features: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss (SupCon SupConLoss.py). features
    (B, V, D) L2-normalised views; labels (B,)."""
    b, v, d = features.shape
    feats = features.reshape(b * v, d)
    anchor = torch.repeat_interleave(labels, v)
    sim = feats @ feats.T / temperature
    sim = sim - torch.max(sim, dim=1, keepdim=True).values.detach()
    self_mask = 1.0 - torch.eye(b * v, dtype=sim.dtype, device=sim.device)
    pos_mask = (anchor[:, None] == anchor[None, :]).to(sim.dtype) * self_mask
    exp_sim = torch.exp(sim) * self_mask
    log_prob = sim - torch.log(torch.sum(exp_sim, dim=1, keepdim=True)
                               + 1e-12)
    mean_log_prob_pos = torch.sum(pos_mask * log_prob, dim=1) / torch.clamp(
        torch.sum(pos_mask, dim=1), min=1.0)
    return -torch.mean(mean_log_prob_pos)


def triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 margin: float = 0.3) -> torch.Tensor:
    """Batch-hard triplet loss: the hardest positive and the hardest
    negative of each anchor in the batch; anchors without both drop
    out of the mean."""
    diff = embeddings[:, None] - embeddings[None, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-12))
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool,
                    device=labels.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    inf = torch.full_like(dist, float("inf"))
    hardest_pos = torch.max(torch.where(pos_mask, dist, -inf), dim=1).values
    hardest_neg = torch.min(torch.where(neg_mask, dist, inf), dim=1).values
    has_both = pos_mask.any(1) & neg_mask.any(1)
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    return _weighted_mean(loss, has_both)


def arcface_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                   labels: torch.Tensor, s: float = 64.0,
                   m: float = 0.5) -> torch.Tensor:
    """ArcFace margin logits (Happy-Whale arcFaceloss.py: s 64, m 0.5).
    embeddings (B, D); weight (D, C) class centres. Feed the result to
    ``cross_entropy``."""
    emb = safe_normalize(embeddings, axis=-1)
    w = safe_normalize(weight, axis=0)
    cos = torch.clamp(emb @ w, -1 + 1e-7, 1 - 1e-7)
    target_cos = torch.cos(torch.arccos(cos) + m)
    onehot = F.one_hot(labels.long(), weight.shape[1]).to(cos.dtype)
    return s * (onehot * target_cos + (1 - onehot) * cos)


def wnfc_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                s: float = 64.0) -> torch.Tensor:
    """Weight-normalised FC logits (Happy-Whale wnfc): s · cos(theta),
    without the angular margin."""
    return s * (safe_normalize(embeddings, axis=-1)
                @ safe_normalize(weight, axis=0))


def heatmap_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                     visible: torch.Tensor) -> torch.Tensor:
    """Visibility-weighted keypoint-heatmap MSE (Insulator loss.py).
    pred / target (B, H, W, K); visible (B, K), > 0 counts."""
    per_kp = torch.mean(torch.square(pred - target), dim=(1, 2))
    return _weighted_mean(per_kp, (visible > 0).to(pred.dtype))
