"""Normalization from scratch — the port of
``deeplearning_tpu/utils/normalization.py`` (the teaching module).

Surface of others/normalization (batch_normalization.py,
layer_normalization.py, instance_normalization.py,
group_normalization.py): each norm written out as explicit mean / var
math over its reduction dims, on NHWC tensors as in the JAX module, for
study and as golden references against the library layers.

Dims cheat-sheet for NHWC:
  BatchNorm:    reduce (N, H, W)   per channel
  LayerNorm:    reduce (C,)        per sample position
  InstanceNorm: reduce (H, W)      per sample per channel
  GroupNorm:    reduce (H, W, C/G) per sample per group

The variance is the biased one (``unbiased=False``), as ``jnp.var``.
``sync_batch_norm_stats`` takes a process group where JAX takes an axis
name.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "sync_batch_norm_stats"]


def _normalize(x, dims, gamma, beta, eps):
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, unbiased=False, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


def batch_norm(x, gamma, beta, eps: float = 1e-5):
    return _normalize(x, (0, 1, 2), gamma, beta, eps)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    return _normalize(x, (-1,), gamma, beta, eps)


def instance_norm(x, gamma, beta, eps: float = 1e-5):
    return _normalize(x, (1, 2), gamma, beta, eps)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5):
    b, h, w, c = x.shape
    g = x.reshape(b, h, w, groups, c // groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    var = g.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    g = (g - mean) / torch.sqrt(var + eps)
    return gamma * g.reshape(b, h, w, c) + beta


def sync_batch_norm_stats(x: torch.Tensor, group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-rank BatchNorm statistics of an NHWC ``x`` — what
    SyncBatchNorm does (others/train_with_DDP/train.py:192): the mean of
    each rank's per-channel mean and mean square over ``group`` (default:
    the world), returned as (mean, E[x²] − mean²). Every rank gets the
    same pair; equal local batches are assumed, as JAX's ``pmean``
    assumes them."""
    import torch.distributed as dist
    stats = torch.stack([x.mean(dim=(0, 1, 2)),
                         x.square().mean(dim=(0, 1, 2))])
    world = dist.get_world_size(group)
    dist.all_reduce(stats, group=group)
    mean, mean2 = stats / world
    return mean, mean2 - mean.square()
