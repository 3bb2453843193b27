"""Ulysses sequence parallelism: all-to-all head redistribution — the
port of ``deeplearning_tpu/parallel/ulysses.py``.

Where ring attention rotates K/V chunks P times around the ``seq`` axis,
Ulysses makes ONE tiled all-to-all (``collectives.all_to_all_tiled``,
JAX's ``lax.all_to_all``) that trades the sharded sequence dim for a
sharded head dim: each rank then holds the FULL sequence for H/P heads,
runs any attention on it (K1's ``flash_attention`` with
``use_flash=True``), and a second all-to-all restores the sequence
split. Both moves are differentiable (the backward is the same move with
the dims swapped), so the inner attention trains as it does alone. The
port runs on every rank of the axis's process group
(``Mesh.group("seq")``); q, k and v move in one all-to-all. Beside a
``model`` axis H is the rank's own heads, which must split over ``seq``
too (JAX's ``ValueError`` otherwise: ViT-B/16 at model 2 has 6 a rank).
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch

from . import collectives
from .mesh import SEQ_AXIS, Mesh

__all__ = ["ulysses_attention", "make_ulysses_attention",
           "make_ulysses_attn_fn"]


def _default_attention(q, k, v, sm_scale, valid_len=None):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if valid_len is not None and valid_len < k.shape[2]:
        col = torch.arange(k.shape[2], device=k.device)
        s = torch.where(col[None, None, None, :] < valid_len, s,
                        s.new_tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """q, k, v are this rank's sequence chunks (B, H, N/P, D) with H
    divisible by the group's size P. ``attn_fn`` sees (B, H/P, N, D)
    full-sequence blocks (default: softmax attention, masking keys at or
    past ``valid_len``); it gets ``sm_scale`` when it takes that keyword,
    and a plain ``attn_fn(q, k, v)`` is allowed only with the default
    scale."""
    import torch.distributed as dist
    p_size = dist.get_world_size(group)
    b, h, nl, d = q.shape
    if h % p_size:
        raise ValueError(f"heads={h} must divide over axis size {p_size}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if attn_fn is not None and valid_len is not None \
            and valid_len < nl * p_size:
        raise ValueError(
            "valid_len masking is only implemented for the default inner "
            "attention — a custom attn_fn would silently attend padded "
            "keys. Pad N to a multiple of the axis instead.")
    takes_scale = False
    if attn_fn is not None:
        try:
            takes_scale = "sm_scale" in inspect.signature(
                attn_fn).parameters
        except (TypeError, ValueError):
            takes_scale = False
        if not takes_scale and sm_scale != q.shape[-1] ** -0.5:
            raise ValueError(
                "explicit sm_scale given but attn_fn does not accept an "
                "sm_scale keyword — it would be silently ignored")
    # seq-sharded -> head-sharded: split heads, gather the sequence
    qh, kh, vh = collectives.all_to_all_tiled(
        torch.stack([q, k, v]), 2, 3, group).unbind(0)
    if attn_fn is None:
        # the gathered sequence carries any zero-padding at its global
        # tail, so a static valid_len bound masks it exactly
        out = _default_attention(qh, kh, vh, sm_scale, valid_len=valid_len)
    else:
        out = (attn_fn(qh, kh, vh, sm_scale=sm_scale) if takes_scale
               else attn_fn(qh, kh, vh))
    return collectives.all_to_all_tiled(out.to(q.dtype), 2, 1, group)


def make_ulysses_attention(mesh: Mesh, axis_name: str = SEQ_AXIS,
                           attn_fn: Optional[Callable] = None):
    """Ulysses over ``mesh``'s ``axis_name`` ranks: ``fn(q, k, v)`` takes
    this rank's (B, H, N / P, D) chunks and returns its chunk of the
    output."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group, attn_fn=attn_fn)

    return fn


def make_ulysses_attn_fn(mesh: Mesh, axis_name: str = SEQ_AXIS,
                         use_flash: bool = False):
    """Ulysses as a model ``attn_fn`` (the same drop-in contract as
    ``ring_attention.make_ring_attn_fn``). Token counts that do not
    divide the ``seq`` axis are zero-padded; the padding lands at the
    gathered sequence's tail, where the default inner attention masks
    it. ``use_flash=True`` runs each head block through K1's
    ``flash_attention`` and needs N to divide the axis."""
    from ._seq_adapter import seq_attn_adapter

    axis_size = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    inner = None
    if use_flash:
        from ..ops.flash_attention import flash_attention
        inner = flash_attention

    def call(qc, kc, vc, n):
        return ulysses_attention(qc, kc, vc, group, attn_fn=inner,
                                 valid_len=n)

    return seq_attn_adapter(mesh, axis_size, axis_name, "ulysses",
                            use_flash, call)
