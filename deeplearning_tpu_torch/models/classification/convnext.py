"""ConvNeXt-T/S/B and CoAtNet-0 — the port of
``deeplearning_tpu/models/classification/convnext.py``.

Same layers, flax names and factories, so a flax tree converts one to one
(``utils/convert.from_flax_params``: the depthwise 7x7 kernels HWIO →
OIHW, the layer-scale ``gamma`` as it is). The input is NHWC and
``dtype`` the compute type over float32 parameters; the logits come back
in float32.

ConvNeXt keeps JAX's NHWC stream: each block's depthwise conv runs on an
NCHW view of it, then LayerNorm (epsilon 1e-6), the pointwise MLP (GELU
per ``core.numerics``), the layer scale and drop path (the per-sample mask
drawn from the step's generator). The stem and the downsampling convs
pad as flax's "SAME" does; the head's LayerNorm and Dense run in float32,
as JAX's (no ``dtype``).

CoAtNet is C-C-T-T: a BatchNorm conv stem, two MBConv stages
(``mobile.InvertedResidual``), then two transformer stages after a 2x2
max pool, whose attention is the port's ViT ``Attention`` with no
``attn_fn``: the plain ``dot_product_attention`` JAX runs (no kernel
route, as in JAX). Every factory takes ``in_chans`` (default 3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import numerics
from ...core.registry import MODELS
from ..layers import conv, dense, init_flax_, max_pool, pad_same
from .mobile import InvertedResidual
from .resnet import norm_layer
from .vit import Attention, DropPath, LayerNorm

__all__ = ["ConvNeXtBlock", "ConvNeXt", "CoAtNet"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path_rate: float = 0.0,
                 layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, dtype)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = _nhwc(conv(_nchw(x), self.dwconv, self.dtype))
        y = dense(self.norm(y), self.pw1, self.dtype)
        y = dense(numerics.gelu(y), self.pw2, self.dtype)
        y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y, rng)


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        bi, cin = 0, in_chans
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si == 0:
                self.stem = nn.Conv2d(cin, dim, 4, 4)
                self.stem_norm = LayerNorm(dim, dtype)
            else:
                setattr(self, f"down{si}_norm", LayerNorm(cin, dtype))
                setattr(self, f"down{si}", nn.Conv2d(cin, dim, 2, 2))
            for i in range(depth):
                setattr(self, f"stage{si}_block{i}",
                        ConvNeXtBlock(dim, float(dpr[bi]), dtype=dtype))
                bi += 1
            cin = dim
        self.head_norm = LayerNorm(cin, torch.float32)
        self.head = nn.Linear(cin, num_classes)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.dtype
        x = x.to(c)
        for si, depth in enumerate(self.depths):
            if si == 0:
                x = _nhwc(conv(pad_same(_nchw(x), 4, 4), self.stem, c))
                x = self.stem_norm(x)
            else:
                x = getattr(self, f"down{si}_norm")(x)
                x = _nhwc(conv(pad_same(_nchw(x), 2, 2),
                               getattr(self, f"down{si}"), c))
            for i in range(depth):
                x = getattr(self, f"stage{si}_block{i}")(x, rng)
        x = self.head_norm(x.float().mean(dim=(1, 2)))
        return dense(x, self.head, torch.float32)


class CoAtNet(nn.Module):
    """C-C-T-T: conv stem, two MBConv stages, two transformer stages."""

    def __init__(self, num_classes: int = 1000,
                 dims: Sequence[int] = (64, 96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 3, 5, 2),
                 num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        norm = norm_layer(dtype)
        cin = in_chans
        for i in range(depths[0]):
            setattr(self, f"stem{i}", nn.Conv2d(cin, dims[0], 3,
                                                2 if i == 0 else 1, 1))
            setattr(self, f"stem{i}_bn", norm(dims[0]))
            cin = dims[0]
        for si in (1, 2):
            for i in range(depths[si]):
                setattr(self, f"s{si}_mb{i}", InvertedResidual(
                    cin, dims[si], 2 if i == 0 else 1, expand=4,
                    use_se=True, dtype=dtype))
                cin = dims[si]
        for si in (3, 4):
            d = dims[si]
            setattr(self, f"s{si}_proj", nn.Linear(cin, d))
            for i in range(depths[si]):
                setattr(self, f"s{si}_b{i}_norm1", LayerNorm(d, dtype))
                setattr(self, f"s{si}_b{i}_attn",
                        Attention(d, num_heads, dtype=dtype))
                setattr(self, f"s{si}_b{i}_norm2", LayerNorm(d, dtype))
                setattr(self, f"s{si}_b{i}_mlp1", nn.Linear(d, 4 * d))
                setattr(self, f"s{si}_b{i}_mlp2", nn.Linear(4 * d, d))
            cin = d
        self.head = nn.Linear(cin, num_classes)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.dtype
        x = _nchw(x).to(c)
        for i in range(self.depths[0]):
            x = conv(x, getattr(self, f"stem{i}"), c)
            x = numerics.gelu(getattr(self, f"stem{i}_bn")(x))
        for si in (1, 2):
            for i in range(self.depths[si]):
                x = getattr(self, f"s{si}_mb{i}")(x)
        for si in (3, 4):
            x = _nhwc(max_pool(x, 2, 2))
            b, h, w, ch = x.shape
            x = dense(x.reshape(b, h * w, ch), getattr(self, f"s{si}_proj"),
                      c)
            for i in range(self.depths[si]):
                p = f"s{si}_b{i}_"
                y = getattr(self, p + "norm1")(x)
                x = x + getattr(self, p + "attn")(y, rng)
                y = dense(getattr(self, p + "norm2")(x),
                          getattr(self, p + "mlp1"), c)
                x = x + dense(numerics.gelu(y), getattr(self, p + "mlp2"), c)
            x = _nchw(x.reshape(b, h, w, -1))
        x = x.float().mean(dim=(2, 3))
        return dense(x, self.head, c).float()


@MODELS.register("convnext_tiny")
def convnext_tiny(num_classes: int = 1000, **kw):
    return ConvNeXt(num_classes=num_classes, **kw)


@MODELS.register("convnext_small")
def convnext_small(num_classes: int = 1000, **kw):
    return ConvNeXt(depths=(3, 3, 27, 3), num_classes=num_classes, **kw)


@MODELS.register("convnext_base")
def convnext_base(num_classes: int = 1000, **kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                    num_classes=num_classes, **kw)


@MODELS.register("coatnet_0")
def coatnet_0(num_classes: int = 1000, **kw):
    return CoAtNet(num_classes=num_classes, **kw)
