"""Attention dispatch: the naive path vs the Hopper flash kernel.

``get_attn_fn`` fills models' ``attn_fn`` slot
(``models/classification/vit.py`` Attention) with the same names as
``deeplearning_tpu/ops/attention.py``. Every adapter takes and returns
(B, N, H, D). "flash" runs the kernel with one head per CTA, "flash_hb"
with four (the short-N path, and the serve and train default); both read
the fused-qkv slices in place and train through the backward kernels
(``flash_attention._FlashAttention``). "sdpa" is
``torch.nn.functional.scaled_dot_product_attention``, the counterpart of
``jax.nn.dot_product_attention``: a library call, never the port's main
path. Attention dropout exists on the naive path only, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .flash_attention import _head_block, attention_bnhd

__all__ = ["get_attn_fn", "flash_attn_adapter", "flash_hb_adapter",
           "sdpa_adapter"]


def _check_no_dropout(dropout_rate: float, deterministic: bool):
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "flash attention does not implement attention dropout; set "
            "attn_drop_rate=0 (use drop_path for regularization) or use "
            "the naive attention path.")


def flash_attn_adapter(q, k, v, dropout_rate: float = 0.0,
                       deterministic: bool = True,
                       rng: Optional[torch.Generator] = None):
    """Per-head kernel (the long-N path)."""
    _check_no_dropout(dropout_rate, deterministic)
    del rng
    return attention_bnhd(q, k, v, heads_per_cta=1)


def flash_hb_adapter(q, k, v, dropout_rate: float = 0.0,
                     deterministic: bool = True,
                     rng: Optional[torch.Generator] = None):
    """Head-batched kernel, four heads per CTA where H allows (the short-N
    path: ViT/MAE token counts)."""
    _check_no_dropout(dropout_rate, deterministic)
    del rng
    return attention_bnhd(q, k, v,
                          heads_per_cta=_head_block(q.shape[2], 4))


def sdpa_adapter(q, k, v, dropout_rate: float = 0.0,
                 deterministic: bool = True,
                 rng: Optional[torch.Generator] = None):
    """PyTorch's fused attention operator (a library call)."""
    _check_no_dropout(dropout_rate, deterministic)
    del rng
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(F.scaled_dot_product_attention(t(q), t(k), t(v)))


def get_attn_fn(name: str = "flash") -> Optional[Callable]:
    if name in ("flash", "pallas"):
        return flash_attn_adapter
    if name in ("flash_hb", "pallas_hb", "head_batched"):
        return flash_hb_adapter
    if name in ("sdpa", "xla"):
        return sdpa_adapter
    if name in ("naive", "lax", "reference"):
        return None  # models fall back to their built-in naive path
    raise ValueError(f"Unknown attention implementation {name!r}")
