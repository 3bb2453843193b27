"""Swin Transformer v1/v2 and Swin-MLP: the port of
``deeplearning_tpu/models/classification/swin.py``.

Same classes, structure and parameter names as the flax modules, so a
flax tree converts one to one (``utils/convert.from_flax_params``):
``patch_embed`` (the strided conv as a reshape plus a matmul over the HWIO
kernel, kept as a (embed, p·p·c) linear weight), ``patch_norm``,
``absolute_pos_embed``, ``stage{s}_block{i}``, ``stage{s}_merge``,
``norm`` and ``head``; inside a block ``attn.qkv``, ``attn.proj``,
``attn.relative_position_bias_table`` (v1) or ``attn.q_bias``,
``attn.v_bias``, ``attn.logit_scale``, ``attn.cpb_fc1``, ``attn.cpb_fc2``
(v2), and ``spatial_mlp_kernel`` / ``spatial_mlp_bias`` (Swin-MLP).

As in JAX the input is NHWC, ``dtype`` is the compute type over float32
parameters, and the logits come back in float32. The v1 window attention
goes through ``ops/window_attention.window_attention_checkpointed`` (the
hand-written kernel on the card, its plain version on the CPU) when
``use_pallas`` is set, else through the unfused
``ops/window_utils.windowed_attention_reference``. v2's cosine attention
runs unfused; ``v2`` with ``use_pallas`` raises, as in JAX.

The JAX module reads the token grid off its input. The port builds its
parameters up front, so it takes ``img_size``: the input size the
parameter shapes are made for (each stage's window is
min(window, h, w), and ``ape``'s table covers the patch grid). The
factories default it to the resolution in their name. An input whose
stages would need other windows or another position table raises.

The host-side tables (the relative-position index, v2's log-spaced
coordinates, each shifted block's mask) are non-persistent buffers:
``state_dict()`` holds the converted flax tree and nothing else, and they
move to the card with the model, so an eager forward builds and uploads
no table.

``moe=True`` puts ``parallel.moe.MoEMlp`` (``moe_mlp``: ``num_experts``
experts, hidden ratio ``mlp_ratio``) in place of the Mlp of every second
block of a stage (``i % 2 == 1``), as in JAX. Its weighted load-balance
loss is what JAX sows as ``losses/moe_aux``: the block records it in the
innermost ``parallel.moe.collect_moe()`` (the classification loss adds
it), and the routing metrics too.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import window_utils as wu
from ...ops.losses import safe_normalize
from ...ops.window_attention import window_attention_checkpointed
from .vit import (DropPath, Dropout, LayerNorm, Mlp, _dense, _lecun_normal_,
                  _remat)

__all__ = ["WindowAttention", "SwinBlock", "SwinMLPBlock", "PatchMerging",
           "SwinTransformer"]

def _log_coords_table(window: int) -> np.ndarray:
    """v2's log-spaced relative coordinates, ((2w-1)^2, 2) float32."""
    rel = np.arange(-(window - 1), window, dtype=np.float32)
    table = np.stack(np.meshgrid(rel, rel, indexing="ij"),
                     axis=-1).reshape(-1, 2)
    table = table / (window - 1) * 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


def _window_and_shift(window: int, shift: int,
                      res: Tuple[int, int]) -> Tuple[int, int]:
    """The JAX block's rule: the window shrinks to the grid, and a window
    that covers the grid is not shifted."""
    h, w = res
    win = min(window, h, w)
    return win, (0 if win >= min(h, w) else shift)


class WindowAttention(nn.Module):
    """Window MHSA with relative position bias (v1) or cosine attention
    with log-CPB (v2). x: (B*nW, N, C) -> (B*nW, N, C)."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 qkv_bias: bool = True, v2: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas: bool = False):
        super().__init__()
        if v2 and use_pallas:
            raise NotImplementedError(
                "the fused window-attention kernel supports the v1 "
                "(bias-table) path only; cosine attention runs unfused.")
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.v2, self.dtype, self.use_pallas = v2, dtype, use_pallas
        # v2 keeps q and v biases only: a k bias is not softmax-invariant
        # under cosine attention
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias and not v2)
        if v2 and qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        index = torch.from_numpy(
            wu.relative_position_index(window).astype(np.int64)).reshape(-1)
        self.register_buffer("relative_position_index", index,
                             persistent=False)
        if v2:
            self.logit_scale = nn.Parameter(
                torch.full((num_heads, 1, 1), math.log(10.0)))
            self.register_buffer(
                "coords_table", torch.from_numpy(_log_coords_table(window)),
                persistent=False)
            self.cpb_fc1 = nn.Linear(2, 512)
            self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        else:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def _bias(self, table: torch.Tensor) -> torch.Tensor:
        """(heads, N, N) float32 from a ((2w-1)^2, heads) table."""
        n = self.window * self.window
        bias = table[self.relative_position_index]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, c = x.shape
        heads = self.num_heads
        d = c // heads
        qkv = _dense(self.qkv, x, self.dtype)
        if self.q_bias is not None:
            bias_vec = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                  self.v_bias])
            qkv = qkv + bias_vec.to(qkv.dtype)
        qkv = qkv.view(bw, n, 3, heads, d)

        if self.v2:
            cpb = self.cpb_fc2(F.relu(self.cpb_fc1(self.coords_table)))
            bias = 16.0 * torch.sigmoid(self._bias(cpb))
            q, k, v = qkv.unbind(2)
            qn = safe_normalize(q.float(), axis=-1)
            kn = safe_normalize(k.float(), axis=-1)
            scale = torch.exp(torch.clamp(self.logit_scale,
                                          max=math.log(100.0)))
            s = torch.einsum("bqhd,bkhd->bhqk", qn, kn).float()
            s = s * scale[None] + bias[None]
            if mask is not None:
                nw = mask.shape[0]
                s = s.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]
                s = s.reshape(bw, heads, n, n)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(bw, n, c)
        else:
            bias = self._bias(self.relative_position_bias_table)
            if self.use_pallas:
                out = window_attention_checkpointed(qkv, bias, mask)
            else:
                out = wu.windowed_attention_reference(qkv, bias, mask)
        return _dense(self.proj, out, self.dtype)


class SwinBlock(nn.Module):
    """Shifted-window block: v1 pre-norm, v2 res-post-norm. x: (B, h·w, C)
    at resolution ``input_resolution``."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, drop_path_rate: float = 0.0,
                 v2: bool = False, dtype: torch.dtype = torch.bfloat16,
                 use_pallas: bool = False, moe: bool = False,
                 num_experts: int = 8):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window, self.shift = _window_and_shift(window, shift,
                                                    self.input_resolution)
        self.v2 = v2
        h, w = self.input_resolution
        mask = (torch.from_numpy(wu.shift_window_mask(h, w, self.window,
                                                      self.shift))
                if self.shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, self.window, num_heads, qkv_bias,
                                    v2, dtype, use_pallas)
        self.norm2 = LayerNorm(dim, dtype)
        if moe:
            from ...parallel.moe import MoEMlp
            self.moe_mlp = MoEMlp(dim, num_experts, hidden_ratio=mlp_ratio,
                                  drop=drop)
        else:
            self.mlp = Mlp(dim, mlp_ratio, drop, dtype)
        self.moe = moe
        self.drop_path1 = DropPath(drop_path_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = self.input_resolution
        b, n, c = x.shape
        window, shift = self.window, self.shift
        shortcut = x
        if not self.v2:                      # v1: pre-norm
            x = self.norm1(x)
        x = x.reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        wins = self.attn(wu.window_partition(x, window), self.attn_mask)
        x = wu.window_merge(wins, window, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x.reshape(b, n, c)
        if self.v2:                          # v2: res-post-norm
            x = self.norm1(x)
        x = shortcut + self.drop_path1(x, rng)

        y = x if self.v2 else self.norm2(x)
        if self.moe:
            from ...parallel.moe import sow
            y, aux = self.moe_mlp(y, rng)
            if aux is not None:
                sow("losses", aux)
        else:
            y = self.mlp(y, rng)
        if self.v2:
            y = self.norm2(y)
        return x + self.drop_path2(y, rng)


class SwinMLPBlock(nn.Module):
    """Swin-MLP block: the window attention replaced by a per-head learned
    (win², win²) token mix over window positions. Shifted blocks zero-pad
    by (window - shift, shift) on each spatial side and crop back, instead
    of a cyclic roll and a mask."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window, self.shift = _window_and_shift(window, shift,
                                                    self.input_resolution)
        self.num_heads, self.dtype = num_heads, dtype
        n_win = self.window * self.window
        self.norm1 = LayerNorm(dim, dtype)
        self.spatial_mlp_kernel = nn.Parameter(
            torch.zeros(num_heads, n_win, n_win))
        self.spatial_mlp_bias = nn.Parameter(torch.zeros(num_heads, n_win))
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, mlp_ratio, drop, dtype)
        self.drop_path1 = DropPath(drop_path_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = self.input_resolution
        b, n, c = x.shape
        window, shift = self.window, self.shift
        heads = self.num_heads
        n_win = window * window

        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        pt = window - shift
        if shift > 0:
            x = F.pad(x, (0, 0, pt, shift, pt, shift))
        hh, ww = x.shape[1], x.shape[2]
        wins = wu.window_partition(x, window)          # (B·nW, win², C)
        nwb = wins.shape[0]
        wins = wins.reshape(nwb, n_win, heads, c // heads)
        wins = torch.einsum("nihd,hoi->nohd", wins,
                            self.spatial_mlp_kernel.to(wins.dtype)) \
            + self.spatial_mlp_bias.t()[None, :, :, None].to(wins.dtype)
        x = wu.window_merge(wins.reshape(nwb, n_win, c), window, hh, ww)
        if shift > 0:
            x = x[:, pt:pt + h, pt:pt + w, :]
        x = x.reshape(b, n, c)
        x = shortcut + self.drop_path1(x, rng)
        y = self.mlp(self.norm2(x), rng)
        return x + self.drop_path2(y, rng)


class PatchMerging(nn.Module):
    """2×2 patch merge and channel doubling. Channel order [(0,0), (1,0),
    (0,1), (1,1)] over (h-sub, w-sub), as in JAX; v2 moves the norm after
    the reduction (over 2C, not 4C)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16, v2: bool = False):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.dtype, self.v2 = dtype, v2
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim if v2 else 4 * dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        if self.v2:
            return self.norm(_dense(self.reduction, x, self.dtype))
        return _dense(self.reduction, self.norm(x), self.dtype)


class SwinTransformer(nn.Module):
    def __init__(self, patch_size: int = 4, num_classes: int = 1000,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 v2: bool = False, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, use_pallas: bool = False,
                 moe: bool = False, num_experts: int = 8,
                 spatial_mlp: bool = False, ape: bool = False,
                 img_size: int = 224, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size, self.dtype, self.remat = patch_size, dtype, remat
        self.num_classes, self.img_size = num_classes, img_size
        self.use_pallas = use_pallas
        self.patch_embed = nn.Linear(patch_size * patch_size * in_chans,
                                     embed_dim)
        self.patch_norm = LayerNorm(embed_dim, dtype)
        res = (img_size // patch_size, img_size // patch_size)
        self.absolute_pos_embed = (
            nn.Parameter(torch.zeros(1, res[0] * res[1], embed_dim))
            if ape else None)
        self.pos_drop = Dropout(drop_rate)

        dpr = np.linspace(0, drop_path_rate, sum(depths))
        block_idx, dim = 0, embed_dim
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                shift = 0 if i % 2 == 0 else window // 2
                if spatial_mlp:
                    blk = SwinMLPBlock(dim, res, heads, window, shift,
                                       mlp_ratio, drop_rate,
                                       float(dpr[block_idx]), dtype)
                else:
                    blk = SwinBlock(dim, res, heads, window, shift,
                                    mlp_ratio, qkv_bias, drop_rate,
                                    float(dpr[block_idx]), v2, dtype,
                                    use_pallas, moe and i % 2 == 1,
                                    num_experts)
                self.add_module(f"stage{stage}_block{i}", blk)
                block_idx += 1
            if stage < len(depths) - 1:
                self.add_module(f"stage{stage}_merge",
                                PatchMerging(dim, res, dtype, v2))
                res = (res[0] // 2, res[1] // 2)
                dim *= 2
        self.norm = LayerNorm(dim, dtype)
        self.head = nn.Linear(dim, num_classes)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal Dense and expert kernels with
        zero biases, trunc-normal 0.02 bias tables, position embedding and
        head."""
        from ...parallel.moe import ExpertMlp
        def trunc02(t):
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                if module is self.head:
                    trunc02(module.weight)
                else:
                    _lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, ExpertMlp):
                module.init_weights(generator)
            elif isinstance(module, WindowAttention) and not module.v2:
                trunc02(module.relative_position_bias_table)
            elif isinstance(module, SwinMLPBlock):
                k = module.spatial_mlp_kernel
                std = math.sqrt(1.0 / (k.shape[0] * k.shape[1])) \
                    / 0.87962566103423978
                nn.init.trunc_normal_(k, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
        if self.absolute_pos_embed is not None:
            trunc02(self.absolute_pos_embed)

    def stages(self) -> list:
        """The blocks and patch merges, in the order the input meets them."""
        return [m for name, m in self.named_children()
                if name.startswith("stage")]

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.patch_size
        b, hh, ww, c = x.shape
        h, w = hh // p, ww // p
        layers = self.stages()
        if (h, w) != layers[0].input_resolution:
            raise ValueError(
                f"this model's parameters are built for {self.img_size}px "
                f"inputs (a {layers[0].input_resolution} patch grid), got "
                f"{hh}x{ww}: build it with img_size={hh}")
        x = x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
        x = _dense(self.patch_embed, x.reshape(b, h * w, p * p * c),
                   self.dtype)
        x = self.patch_norm(x)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(self.dtype)
        x = self.pos_drop(x, rng)
        remat = self.remat and torch.is_grad_enabled()
        for layer in layers:
            if isinstance(layer, PatchMerging):
                x = layer(x)
            else:
                x = _remat(layer, x, rng) if remat else layer(x, rng)
        x = self.norm(x).mean(dim=1)
        return _dense(self.head, x, self.dtype).float()


def _factory(name, **defaults):
    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        return SwinTransformer(**{**defaults, "num_classes": num_classes,
                                  **kw})
    build.__name__ = name
    return build


# the JAX package's factories (swin.py:373-437), same names and configs;
# img_size is the resolution the name gives (56 for the digit-task configs)
swin_tiny_patch4_window7_224 = _factory(
    "swin_tiny_patch4_window7_224", embed_dim=96, depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24))
swin_small_patch4_window7_224 = _factory(
    "swin_small_patch4_window7_224", embed_dim=96, depths=(2, 2, 18, 2),
    num_heads=(3, 6, 12, 24))
swin_base_patch4_window7_224 = _factory(
    "swin_base_patch4_window7_224", embed_dim=128, depths=(2, 2, 18, 2),
    num_heads=(4, 8, 16, 32))
swin_large_patch4_window7_224 = _factory(
    "swin_large_patch4_window7_224", embed_dim=192, depths=(2, 2, 18, 2),
    num_heads=(6, 12, 24, 48))
swinv2_tiny_patch4_window7_224 = _factory(
    "swinv2_tiny_patch4_window7_224", embed_dim=96, depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24), v2=True)
swinv2_base_patch4_window7_224 = _factory(
    "swinv2_base_patch4_window7_224", embed_dim=128, depths=(2, 2, 18, 2),
    num_heads=(4, 8, 16, 32), v2=True)
swin_moe_tiny_patch4_window7_224 = _factory(
    "swin_moe_tiny_patch4_window7_224", embed_dim=96, depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24), moe=True)
swin_moe_micro_patch2_window7 = _factory(
    "swin_moe_micro_patch2_window7", patch_size=2, embed_dim=32,
    depths=(2, 2), num_heads=(2, 4), moe=True, num_experts=4,
    drop_path_rate=0.0, img_size=56)
swin_micro_patch2_window7 = _factory(
    "swin_micro_patch2_window7", patch_size=2, embed_dim=32,
    depths=(2, 2), num_heads=(2, 4), drop_path_rate=0.0, img_size=56)
swin_mini_patch2_window7 = _factory(
    "swin_mini_patch2_window7", patch_size=2, embed_dim=64,
    depths=(2, 2, 4), num_heads=(2, 4, 8), drop_path_rate=0.0, img_size=56)
swin_moe_mini_patch2_window7 = _factory(
    "swin_moe_mini_patch2_window7", patch_size=2, embed_dim=64,
    depths=(2, 2, 4), num_heads=(2, 4, 8), moe=True, num_experts=4,
    drop_path_rate=0.0, img_size=56)
swin_mini_patch2_window7_ape = _factory(
    "swin_mini_patch2_window7_ape", patch_size=2, embed_dim=64,
    depths=(2, 2, 4), num_heads=(2, 4, 8), drop_path_rate=0.0, ape=True,
    img_size=56)
swin_moe_mini_patch2_window7_ape = _factory(
    "swin_moe_mini_patch2_window7_ape", patch_size=2, embed_dim=64,
    depths=(2, 2, 4), num_heads=(2, 4, 8), moe=True, num_experts=4,
    drop_path_rate=0.0, ape=True, img_size=56)
swin_mlp_tiny_c24_patch4_window8_256 = _factory(
    "swin_mlp_tiny_c24_patch4_window8_256", embed_dim=96,
    depths=(2, 2, 6, 2), num_heads=(4, 8, 16, 32), window=8,
    spatial_mlp=True, img_size=256)
swin_mlp_base_patch4_window7_224 = _factory(
    "swin_mlp_base_patch4_window7_224", embed_dim=128,
    depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7,
    spatial_mlp=True)
