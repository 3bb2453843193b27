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
attention. The dense-prediction and metric-learning losses come with
their slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "soft_target_cross_entropy",
           "binary_cross_entropy", "sigmoid_focal_loss", "smooth_l1",
           "safe_normalize"]


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
