"""Classification losses — the port of the part of
``deeplearning_tpu/ops/losses.py`` the ViT training step uses:
``cross_entropy`` (integer labels, label smoothing, labels < 0 ignored,
optional weights) and ``soft_target_cross_entropy`` (mixup targets). Both
reduce with an explicit weight mask, so padded or invalid rows drop out of
the mean. ``safe_normalize`` serves Swin v2's cosine attention. The
detection and dense-prediction losses come with the detection slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "soft_target_cross_entropy", "safe_normalize"]


def _weighted_mean(x: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return torch.mean(x)
    weights = weights.to(x.dtype)
    return torch.sum(x * weights) / torch.clamp(torch.sum(weights), min=1.0)


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


def safe_normalize(x: torch.Tensor, axis: int = -1,
                   eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize with a finite gradient at x == 0: x * rsqrt(max(|x|^2,
    eps^2)) keeps a zero row zero, with gradient x / eps, where the norm's
    derivative would be NaN."""
    sq = torch.sum(x * x, dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))
