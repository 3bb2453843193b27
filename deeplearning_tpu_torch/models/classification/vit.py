"""Vision Transformer — the port of ``deeplearning_tpu/models/classification/vit.py``.

Same structure and parameter names as the flax module, so a flax tree
converts one to one (``utils/convert.from_flax_params``): PatchEmbed
(a reshape plus a matmul over the HWIO ``proj`` kernel, kept here as a
(embed, p·p·c) linear weight), the fused-qkv Attention with its
``attn_fn`` slot, Mlp, Block, DropPath, ``cls_token``/``pos_embed`` and
the seven registered factories.

As in JAX:
- the public input layout is NHWC (B, H, W, 3);
- ``dtype`` is the compute type over float32 parameters (bfloat16 by
  default), and the logits come back in float32;
- LayerNorm uses flax's epsilon 1e-6 and takes its statistics in float32;
- GELU follows ``core.numerics`` (tanh unless exact mode is on).

Train/eval follows PyTorch's ``module.train()`` / ``module.eval()``
(JAX's ``train=`` argument); weights are initialised from a
``torch.Generator`` with flax's initialisers (lecun-normal Dense
kernels, trunc-normal 0.02 position embedding, trunc-normal 0.01 head).

Randomness is explicit, as JAX's ``rngs={"dropout": key}``: ``forward``
takes ``rng``, a ``torch.Generator`` (the train step's
``core.rng.step_key``), and every dropout, drop-path and attention-dropout
mask is drawn from it. A mask drawn in train mode without one raises.
``remat=True`` wraps each Block in non-reentrant activation checkpointing
(JAX's ``nn.remat``); its recompute replays the forward's draws.

Tensor parallelism (Megatron's layout, JAX's ``TRANSFORMER_TP_RULES``):
once ``parallel.sharding.bind_tensor_parallel`` sets an ``Attention``'s
or ``Mlp``'s ``model_group``, its parameters are this rank's slices: qkv
and fc1 column-parallel (whole heads of q, k and v; a run of fc1's
outputs), proj and fc2 row-parallel (the matching inputs). The input
passes ``collectives.copy_to_model``, the row-parallel product is summed
by ``collectives.reduce_from_model`` in the compute dtype, as GSPMD and
Megatron sum it, and its bias added once, after the sum; the dropout
after it acts on the sum. A mask on a slice (the attention weights of the
rank's heads, fc1's outputs) is cut from the whole tensor's mask, so
every rank draws what the unsplit module draws. The head count comes
from the qkv slice, so ``attn_fn`` sees (B, N, H / model, D). Without a
group (the default) nothing changes.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core import numerics
from ...core.registry import MODELS

__all__ = ["drop_path", "DropPath", "dropout", "Dropout", "PatchEmbed",
           "dot_product_attention", "Attention", "Mlp", "Block",
           "VisionTransformer", "LayerNorm"]


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _column_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                     group) -> torch.Tensor:
    """A column-parallel ``_dense`` on this rank's output slice; the
    backward all-reduces the input's gradient over the model group."""
    from ...parallel.collectives import copy_to_model
    return _dense(layer, copy_to_model(x, group), dtype)


def _row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                  group) -> torch.Tensor:
    """A row-parallel ``_dense``: this rank's partial product, summed over
    the model group, then the (replicated) bias once."""
    from ...parallel.collectives import reduce_from_model
    y = reduce_from_model(F.linear(x.to(dtype), layer.weight.to(dtype)),
                          group)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def _part(group) -> Optional[Tuple[int, int]]:
    """(this rank, ranks) of a model group; None without one."""
    if group is None:
        return None
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _require(rng: Optional[torch.Generator], what: str) -> torch.Generator:
    if rng is None:
        raise ValueError(f"{what} in train mode needs an explicit "
                         f"torch.Generator (pass rng=, e.g. core.rng.step_key)")
    return rng


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on the residual branch; the per-sample mask is
    drawn from ``rng``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
        keep, generator=_require(rng, "drop_path"))
    return x / keep * mask


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: Optional[torch.Generator] = None):
        return drop_path(x, self.rate, not self.training, rng)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            rng: Optional[torch.Generator] = None,
            part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate); the mask is drawn from ``rng``. With
    ``part=(i, n)`` ``x`` is slice i of n equal slices of its last dim:
    the whole width's mask is drawn and cut to the slice, so the stream
    moves on as the unsplit tensor's does."""
    if deterministic or rate == 0.0:
        return x
    shape = x.shape if part is None else \
        x.shape[:-1] + (x.shape[-1] * part[1],)
    keep = torch.empty(shape, device=x.device).bernoulli_(
        1.0 - rate, generator=_require(rng, "dropout")).bool()
    if part is not None:
        keep = keep.narrow(-1, part[0] * x.shape[-1], x.shape[-1])
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: Optional[torch.Generator] = None):
        return dropout(x, self.rate, not self.training, rng)


class LayerNorm(nn.Module):
    """flax LayerNorm: statistics in float32, epsilon 1e-6, output in
    the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


class PatchEmbed(nn.Module):
    """Image (B, H, W, C) → patch tokens (B, H/p · W/p, embed): the strided
    conv written as a block reshape plus one matmul, in the JAX order
    (patch rows, patch cols, channels)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 in_chans: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Linear(patch_size * patch_size * in_chans, embed_dim)

    def forward(self, x):
        p = self.patch_size
        b, hh, ww, c = x.shape
        h, w = hh // p, ww // p
        x = x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h * w, p * p * c)
        return _dense(self.proj, x, self.dtype)


def dot_product_attention(q, k, v, dropout_rate=0.0, deterministic=True,
                          rng=None, head_part=None):
    """Naive softmax attention — the reference path the kernel is tested
    against. q, k, v: (B, N, H, D). With ``head_part=(i, n)`` the heads
    are slice i of n equal slices: the dropout mask of all n·H heads is
    drawn and cut to the slice."""
    scale = q.shape[-1] ** -0.5
    attn = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0 and not deterministic:
        shape = attn.shape if head_part is None else (
            attn.shape[0], attn.shape[1] * head_part[1]) + attn.shape[2:]
        keep = torch.empty(shape, dtype=attn.dtype,
                           device=attn.device).bernoulli_(
            1.0 - dropout_rate, generator=_require(rng, "attention dropout"))
        if head_part is not None:
            keep = keep.narrow(1, head_part[0] * attn.shape[1], attn.shape[1])
        attn = attn * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class Attention(nn.Module):
    """Fused-qkv multi-head attention. ``attn_fn`` takes and returns
    (B, N, H, D); q, k and v are strided views of the fused projection.
    With a ``model_group`` the heads are this rank's (module docstring)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.model_group = None
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_dropout = Dropout(proj_drop)

    def tp_layout(self, n: int):
        """Megatron's split over n model ranks, (dim, parts) a parameter:
        qkv by whole heads within q, k and v, proj by its inputs; None
        when the heads do not divide."""
        if self.num_heads % n:
            return None
        return {"qkv.weight": (0, 3), "qkv.bias": (0, 3),
                "proj.weight": (1, 1), "proj.bias": None}

    def forward(self, x, rng: Optional[torch.Generator] = None):
        b, n, c = x.shape
        group = self.model_group
        d = c // self.num_heads
        qkv = (_dense(self.qkv, x, self.dtype) if group is None
               else _column_parallel(self.qkv, x, self.dtype, group))
        heads = qkv.shape[-1] // (3 * d)
        q, k, v = qkv.view(b, n, 3, heads, d).unbind(2)
        fn = self.attn_fn or functools.partial(dot_product_attention,
                                               head_part=_part(group))
        out = fn(q, k, v, dropout_rate=self.attn_drop,
                 deterministic=not self.training, rng=rng)
        out = out.reshape(b, n, heads * d)
        out = (_dense(self.proj, out, self.dtype) if group is None
               else _row_parallel(self.proj, out, self.dtype, group))
        return self.proj_dropout(out, rng)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_ratio: float = 4.0,
                 drop: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.model_group = None
        self.fc1 = nn.Linear(dim, int(dim * hidden_ratio))
        self.fc2 = nn.Linear(int(dim * hidden_ratio), dim)
        self.drop = Dropout(drop)

    def tp_layout(self, n: int):
        """Megatron's split over n model ranks: fc1 by its outputs, fc2 by
        its inputs; None when the hidden width does not divide."""
        if self.fc1.out_features % n:
            return None
        return {"fc1.weight": (0, 1), "fc1.bias": (0, 1),
                "fc2.weight": (1, 1), "fc2.bias": None}

    def forward(self, x, rng: Optional[torch.Generator] = None):
        group = self.model_group
        x = (_dense(self.fc1, x, self.dtype) if group is None
             else _column_parallel(self.fc1, x, self.dtype, group))
        x = numerics.gelu(x)
        x = dropout(x, self.drop.rate, not self.training, rng, _part(group))
        x = (_dense(self.fc2, x, self.dtype) if group is None
             else _row_parallel(self.fc2, x, self.dtype, group))
        return self.drop(x, rng)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              dtype, attn_fn)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, mlp_ratio, drop, dtype)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        x = x + self.drop_path(self.attn(self.norm1(x), rng), rng)
        return x + self.drop_path(self.mlp(self.norm2(x), rng), rng)


def _remat(block: Block, x: torch.Tensor,
           rng: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, rng)`` under non-reentrant activation checkpointing. The
    recompute in the backward restarts ``rng`` from the state the forward
    saw, so it draws the same masks, and then puts the stream back where
    it was, so later draws do not depend on ``remat``."""
    if rng is None:
        return checkpoint(block, x, None, use_reentrant=False)
    start = rng.get_state()
    ran = []

    def run(inp):
        if not ran:                 # the forward
            ran.append(True)
            return block(inp, rng)
        resume = rng.get_state()    # the recompute
        rng.set_state(start)
        try:
            return block(inp, rng)
        finally:
            rng.set_state(resume)
    return checkpoint(run, x, use_reentrant=False)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal (±2σ) with variance 1/fan_in,
    σ corrected for the truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 representation_size: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False,
                 attn_fn: Optional[Callable] = None,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.num_classes = num_classes
        self.img_size = img_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype)
        n = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        dpr = torch.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                  attn_drop_rate, dpr[i], dtype, attn_fn)
            for i in range(depth)])
        self.norm = LayerNorm(embed_dim, dtype)
        self.pre_logits = (nn.Linear(embed_dim, representation_size)
                           if representation_size is not None else None)
        self.head = nn.Linear(representation_size or embed_dim, num_classes)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, nn.Linear):
                if module is self.head:
                    nn.init.trunc_normal_(module.weight, std=0.01, a=-0.02,
                                          b=0.02, generator=generator)
                else:
                    _lecun_normal_(module.weight, generator)
                nn.init.zeros_(module.bias)
        nn.init.zeros_(self.cls_token)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        x = self.patch_embed(x)
        b, _, c = x.shape
        cls = self.cls_token.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.pos_drop(x, rng)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = _remat(block, x, rng) if remat else block(x, rng)
        x = self.norm(x)[:, 0]
        if self.pre_logits is not None:
            x = torch.tanh(_dense(self.pre_logits, x, self.dtype))
        return _dense(self.head, x, self.dtype).float()


def _factory(name, **defaults):
    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        merged = {**defaults, "num_classes": num_classes, **kw}
        return VisionTransformer(**merged)
    build.__name__ = name
    return build


# the JAX package's factories (vit.py:256-278), same names and configs
vit_small_patch16_224 = _factory("vit_small_patch16_224",
                                 patch_size=16, embed_dim=384, depth=12,
                                 num_heads=6)
vit_micro_patch4_56 = _factory("vit_micro_patch4_56", img_size=56,
                               patch_size=4, embed_dim=128, depth=6,
                               num_heads=4, drop_path_rate=0.0)
vit_base_patch16_224 = _factory("vit_base_patch16_224",
                                patch_size=16, embed_dim=768, depth=12,
                                num_heads=12)
vit_base_patch32_224 = _factory("vit_base_patch32_224",
                                patch_size=32, embed_dim=768, depth=12,
                                num_heads=12)
vit_large_patch16_224 = _factory("vit_large_patch16_224",
                                 patch_size=16, embed_dim=1024, depth=24,
                                 num_heads=16)
vit_large_patch32_224 = _factory("vit_large_patch32_224",
                                 patch_size=32, embed_dim=1024, depth=24,
                                 num_heads=16)
vit_huge_patch14_224 = _factory("vit_huge_patch14_224",
                                patch_size=14, embed_dim=1280, depth=32,
                                num_heads=16)
