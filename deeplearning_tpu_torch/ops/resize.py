"""``jax.image.resize`` for the port: "bilinear" and "nearest".

The JAX package resizes feature maps and logits with ``jax.image.resize``
(segmentation heads, HRNet's fusion, MADNet's disparity, the few-shot
mask). Its semantics differ from ``F.interpolate``'s, so the port computes
them itself:

- "bilinear" is the separable triangle kernel of
  ``jax.image.scale_and_translate``: half-pixel centres, the kernel
  widened by the downscale factor (antialiasing, which ``F.interpolate``
  leaves off by default), the weights normalised over the input pixels
  they reach. Each resized axis is one product with its (in, out) weight
  matrix, cast to the input's dtype as JAX casts it;
- "nearest" takes input index ``floor((i + 0.5) · in / out)`` in float32
  (the half-pixel centre), where ``F.interpolate(mode="nearest")`` takes
  ``floor(i · in / out)``; the two differ wherever the ratio does not
  divide.

``resize`` takes the whole output shape, as ``jax.image.resize`` does, and
resizes every axis whose size changes, in any layout (the port's models
call it on NCHW maps).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["triangle_weights", "resize"]


def triangle_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image's triangle kernel."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)      # widened only to downscale
    # (i + 0.5)·inv − 0.5 rounded once, as XLA's fused multiply-add does
    # it: a sample near 640 moves by its float32 ulp (6e-5) otherwise
    sample_f = ((torch.arange(n_out, dtype=torch.float64, device=device)
                 + 0.5) * inv_scale - 0.5).float()
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    pos = (torch.arange(n_out, dtype=torch.float32, device=device)
           + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize(x: torch.Tensor, shape: Sequence[int],
           method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for "bilinear" (also
    "linear") and "nearest"."""
    if len(shape) != x.dim():
        raise ValueError(f"resize to {tuple(shape)}: x has {x.dim()} dims")
    if method not in ("bilinear", "linear", "nearest"):
        raise ValueError(f"resize method {method!r}: bilinear or nearest")
    if method != "nearest" and not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(d, _nearest_index(n_in, n_out, x.device))
        else:
            w = triangle_weights(n_in, n_out, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
