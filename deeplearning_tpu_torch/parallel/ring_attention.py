"""Ring attention: sequence-parallel exact attention over the ``seq``
axis — the port of ``deeplearning_tpu/parallel/ring_attention.py``.

Each seq rank holds its Q/K/V chunk; the K/V chunks rotate around the
ring (``collectives.ppermute``, JAX's ``lax.ppermute``) while each rank
accumulates its queries' attention over every chunk with the online
softmax the flash kernel uses. JAX runs the loop inside ``shard_map``
over the named axis; the port runs it on every rank of the axis's
process group (``Mesh.group("seq")``), on the rank's own chunks.

``use_flash=True`` runs each chunk through K1's forward
(``ops.flash_attention.flash_attention_with_lse``: a chunk's (out, lse)
is an online-softmax accumulator with num = out, m = lse, l = 1) and
trains through a second ring in the backward: each rank computes the
per-chunk (dq, dk, dv) with K1's dQ and dK/dV kernels
(``flash_chunk_grads``) against the GLOBAL log-sum-exp and delta, and the
dK/dV accumulators rotate with their K/V chunks until they are home
(Liu & Abbeel's ring backward). On a CUDA tensor every chunk launches
the kernels; on a CPU tensor their plain versions run. The plain path
(``use_flash=False``) is PyTorch's autograd through the ring, with a
key-validity mask riding the ring with its chunk.

The forward skips the last rotation of K/V (JAX's loop makes it and
drops the result); the backward's last rotation brings dK/dV home.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives
from .mesh import SEQ_AXIS, Mesh

__all__ = ["ring_attention", "make_ring_attention", "make_ring_attn_fn",
           "NEG_INF"]

NEG_INF = -1e30


def _size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _chunk_attention_stats(q, k, v, sm_scale, kv_mask=None):
    """Un-normalized attention over one KV chunk: (numerator, max,
    sumexp) in float32 for online combining. q, k, v: (B, H, Nq, D) /
    (B, H, Nk, D); ``kv_mask`` (Nk,) bool marks the valid keys (the
    adapters zero-pad the tail)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[None, None, None, :], s,
                        s.new_tensor(NEG_INF))
    m = s.amax(dim=-1)                                      # (B, H, Nq)
    p = torch.exp(s - m[..., None])
    if kv_mask is not None:
        p = p * kv_mask[None, None, None, :].to(p.dtype)
    l = p.sum(dim=-1)
    num = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return num, m, l


def _combine(carry, update):
    """Online-softmax merge of (num, m, l) accumulators."""
    num1, m1, l1 = carry
    num2, m2, l2 = update
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return (num1 * a1[..., None] + num2 * a2[..., None], m, l1 * a1 + l2 * a2)


def _ring_perm(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_forward(q, k, v, group, sm_scale, use_flash, kv_mask=None):
    """The ring's forward; returns (out, global lse)."""
    n = _size(group)
    perm = _ring_perm(n)
    if use_flash:
        from ..ops.flash_attention import flash_attention_with_lse

    def chunk_stats(kk, vv, mm):
        if use_flash:
            o, lse = flash_attention_with_lse(q, kk, vv, sm_scale=sm_scale)
            return o.float(), lse, torch.ones_like(lse)
        return _chunk_attention_stats(q, kk, vv, sm_scale, kv_mask=mm)

    # the first chunk's stats are the accumulator: merging them into
    # (0, -inf, 0) would give them back bit for bit
    carry = None
    kk, vv, mm = k, v, kv_mask
    for i in range(n):
        update = chunk_stats(kk, vv, mm)
        carry = update if carry is None else _combine(carry, update)
        if i == n - 1:
            break
        # K and V move as one tensor: one collective a step
        kk, vv = (collectives.ppermute(torch.stack([kk, vv]), perm, group)
                  .unbind(0))
        if mm is not None:
            mm = collectives.ppermute(mm.to(torch.uint8), perm,
                                      group).bool()
    num, m, l = carry
    l_safe = torch.clamp_min(l, 1e-30)
    out = (num / l_safe[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


class _RingFlash(torch.autograd.Function):
    """The K1-backed ring with its own backward ring (JAX's custom_vjp
    ``_ring_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale):
        out, lse = _ring_forward(q, k, v, group, sm_scale, use_flash=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.sm_scale = group, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        """Per-chunk flash gradients against the global LSE sum to the
        full-sequence gradient, so dQ accumulates here while (K, V) and
        (dK, dV) rotate together: after a full circle the dK/dV
        accumulators are home with every rank's contribution."""
        from ..ops.flash_attention import flash_chunk_grads
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n = _size(group)
        perm = _ring_perm(n)
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        dq = dkv = None
        kk, vv = k, v
        for i in range(n):
            dq_c, dk_c, dv_c = flash_chunk_grads(q, kk, vv, dout, lse, delta,
                                                 sm_scale=ctx.sm_scale)
            if dq is None:      # chunk gradients are float32
                dq, dkv = dq_c, torch.stack([dk_c, dv_c])
            else:
                dq += dq_c
                dkv[0] += dk_c
                dkv[1] += dv_c
            if n > 1:
                if i < n - 1:
                    kk, vv = collectives.ppermute(
                        torch.stack([kk, vv]), perm, group).unbind(0)
                dkv = collectives.ppermute(dkv, perm, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, sm_scale: Optional[float] = None,
                   use_flash: bool = False,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over ``group`` (the seq
    axis's process group; None is the world). q, k, v are this rank's
    sequence chunks (B, H, Nlocal, D), equal on every rank; non-causal.

    ``use_flash`` runs each chunk through K1 and trains through the
    backward ring of K1's backward kernels (see the module docstring); it
    refuses ``kv_mask``, as JAX's does. ``kv_mask`` (Nlocal,) bool marks
    this rank's valid keys (the plain path)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if use_flash:
        if kv_mask is not None:
            raise NotImplementedError(
                "kv_mask needs the lax path (the flash kernel masks by "
                "static kv_len only) — pad to a seq-axis multiple "
                "instead, or set use_flash=False")
        return _RingFlash.apply(q, k, v, group, float(sm_scale))
    out, _ = _ring_forward(q, k, v, group, sm_scale, use_flash=False,
                           kv_mask=kv_mask)
    return out


def make_ring_attention(mesh: Mesh, axis_name: str = SEQ_AXIS,
                        use_flash: bool = False):
    """Ring attention over ``mesh``'s ``axis_name`` ranks: the returned
    ``fn(q, k, v)`` takes this rank's (B, H, N / P, D) chunks (rank i of
    the axis holds the i-th) and returns its chunk of the output — the
    local shard of JAX's ``shard_map`` over a sequence-sharded array."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, group, use_flash=use_flash)

    return fn


def make_ring_attn_fn(mesh: Mesh, axis_name: str = SEQ_AXIS,
                      use_flash: bool = False):
    """Ring attention as a model ``attn_fn`` (the (B, N, H, D) signature
    of the ViT's Attention): build a ViT with
    ``attn_fn=make_ring_attn_fn(mesh)`` and its attention splits its
    tokens over the ``seq`` ranks while the stream between the layers
    stays replicated over them.

    Token counts rarely divide the seq axis (ViT-B/16 has 197), so the
    plain path zero-pads to a multiple and a key-validity mask rides the
    ring with its chunk; ``use_flash=True`` needs N to divide the axis
    (a ``ValueError`` otherwise)."""
    from ._seq_adapter import seq_attn_adapter

    axis_size = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    idx = mesh.coords[axis_name]

    def call(qc, kc, vc, n):
        nl = qc.shape[2]
        mask = None
        if not use_flash:
            mask = torch.arange(idx * nl, (idx + 1) * nl,
                                device=qc.device) < n
        return ring_attention(qc, kc, vc, group, use_flash=use_flash,
                              kv_mask=mask)

    return seq_attn_adapter(mesh, axis_size, axis_name, "ring", use_flash,
                            call)
