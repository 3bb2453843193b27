"""Window partition/merge, shifted-window masks and the relative-position
index: the port of ``deeplearning_tpu/ops/window_utils.py``.

The host-side tables (``shift_window_mask``, ``relative_position_index``)
are the port's own numpy copies of the JAX package's, bit for bit.
``windowed_attention_reference`` is Swin's unfused attention: the model's
path with ``use_pallas=False``, and the oracle the backward of
``ops/window_attention.window_attention_checkpointed`` recomputes. Its
numerics are the JAX reference's: ``q * scale`` in the compute dtype
before the first product, scores taken to float32 after it, softmax in
float32, P cast back to the compute dtype before P·V.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["window_partition", "window_merge", "shift_window_mask",
           "relative_position_index", "windowed_attention_reference"]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def window_merge(windows: torch.Tensor, window: int, h: int,
                 w: int) -> torch.Tensor:
    """(B*nW, window*window, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive attention mask (nW, N, N): 0 within a region of the shifted
    frame, -1e9 across regions."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    # region ids are laid out in the shifted frame already: partition
    # directly, no roll
    wins = img.reshape(1, h // window, window, w // window, window, 1)
    wins = wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def relative_position_index(window: int) -> np.ndarray:
    """(N, N) int32 index into the (2w-1)^2-row relative-position-bias
    table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))           # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]                # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return (rel[:, :, 0] + rel[:, :, 1]).astype(np.int32)    # (N, N)


def windowed_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                 mask: Optional[torch.Tensor]
                                 ) -> torch.Tensor:
    """Per-window attention, unfused. qkv (BW, N, 3, heads, d), bias
    (heads, N, N), mask (nW, N, N) or None; returns (BW, N, heads*d) in
    qkv's dtype. Differentiable in qkv and bias."""
    bw, n, _, heads, d = qkv.shape
    q, k, v = qkv.unbind(2)                               # (BW, N, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, k).float()
    s = s + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None].float()
        s = s.reshape(bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(bw, n, heads * d)
