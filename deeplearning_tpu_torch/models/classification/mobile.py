"""ShuffleNet-V2, MobileNet-V2 and EfficientNet-B0 … B7 — the port of
``deeplearning_tpu/models/classification/mobile.py``.

Same layers, flax names and factories, so a flax tree converts one to one
(``utils/convert.from_flax_params``: depthwise and grouped kernels HWIO
(kh, kw, 1, C) → OIHW (C, 1, kh, kw); ``block{b}_{i}`` → ``block{b}.{i}``).
The input is NHWC and ``dtype`` the compute type over float32
parameters; the logits come back in float32. The convolutions run in
NCHW on a channels-last view; ShuffleNet's channel shuffle is JAX's
(channel j·g + i of the output is channel i·C/g + j of the input).
BatchNorm is flax's ``momentum=0.9`` (torch's 0.1), epsilon 1e-5; the
squeeze-and-excitation is the port's ``resnet.SEModule``. The dropout
before the classifier is drawn from the step's generator (``rng=``); JAX's
EfficientNet has no drop-connect, and neither has the port's.

Every factory takes ``in_chans`` (default 3), which flax infers.
``MobileNetV2(return_features=True)`` returns the last block of each
stride level, {c2, c3, c4, c5, top}, as NCHW maps in ``dtype`` (JAX's
NHWC ones), as the port's ResNet returns its features.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..layers import conv, dense, init_flax_, max_pool
from .resnet import SEModule, norm_layer
from .vit import dropout

__all__ = ["channel_shuffle", "ShuffleV2Block", "ShuffleNetV2",
           "InvertedResidual", "MobileNetV2", "EfficientNet"]


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """JAX's NHWC shuffle on an NCHW map."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, pad, groups=groups, bias=False)


def _init(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    init_flax_(module, generator if generator is not None
               else torch.Generator().manual_seed(0))


class ShuffleV2Block(nn.Module):
    def __init__(self, cin: int, out_ch: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm_layer(dtype)
        self.stride, self.dtype = stride, dtype
        branch = out_ch // 2
        if stride != 1:      # the spatial-down branch takes the whole input
            self.proj_dw = _conv(cin, cin, 3, 2, 1, groups=cin)
            self.proj_dw_bn = norm(cin)
            self.proj_pw = _conv(cin, branch, 1)
            self.proj_pw_bn = norm(branch)
        self.pw1 = _conv(cin if stride != 1 else cin // 2, branch, 1)
        self.pw1_bn = norm(branch)
        self.dw = _conv(branch, branch, 3, stride, 1, groups=branch)
        self.dw_bn = norm(branch)
        self.pw2 = _conv(branch, branch, 1)
        self.pw2_bn = norm(branch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.dtype
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
        else:
            x1 = self.proj_dw_bn(conv(x, self.proj_dw, c))
            x1 = F.relu(self.proj_pw_bn(conv(x1, self.proj_pw, c)))
            x2 = x
        y = F.relu(self.pw1_bn(conv(x2, self.pw1, c)))
        y = self.dw_bn(conv(y, self.dw, c))
        y = F.relu(self.pw2_bn(conv(y, self.pw2, c)))
        return channel_shuffle(torch.cat([x1, y], dim=1))


class ShuffleNetV2(nn.Module):
    def __init__(self, stage_repeats: Sequence[int] = (4, 8, 4),
                 stage_channels: Sequence[int] = (116, 232, 464),
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stage_repeats = tuple(stage_repeats)
        self.stem = _conv(in_chans, 24, 3, 2, 1)
        self.stem_bn = norm_layer(dtype)(24)
        cin = 24
        for si, (reps, ch) in enumerate(zip(stage_repeats, stage_channels)):
            for i in range(reps):
                setattr(self, f"stage{si}_block{i}", ShuffleV2Block(
                    cin, ch, 2 if i == 0 else 1, dtype))
                cin = ch
        self.head_conv = _conv(cin, 1024, 1)
        self.fc = nn.Linear(1024, num_classes)
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        del rng
        c = self.dtype
        x = x.permute(0, 3, 1, 2).to(c)
        x = F.relu(self.stem_bn(conv(x, self.stem, c)))
        x = max_pool(x, 3, 2, 1)
        for si, reps in enumerate(self.stage_repeats):
            for i in range(reps):
                x = getattr(self, f"stage{si}_block{i}")(x)
        x = F.relu(conv(x, self.head_conv, c))
        x = x.float().mean(dim=(2, 3))
        return dense(x, self.fc, c).float()


class InvertedResidual(nn.Module):
    """MBConv: expand -> depthwise -> (SE) -> project; ReLU6, or SiLU
    with the SE."""

    def __init__(self, cin: int, out_ch: int, stride: int, expand: int = 6,
                 kernel: int = 3, use_se: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm_layer(dtype)
        hidden = cin * expand
        self.expand_ratio, self.use_se, self.dtype = expand, use_se, dtype
        self.residual = stride == 1 and cin == out_ch
        if expand != 1:
            self.expand = _conv(cin, hidden, 1)
            self.expand_bn = norm(hidden)
        self.dw = _conv(hidden, hidden, kernel, stride, kernel // 2,
                        groups=hidden)
        self.dw_bn = norm(hidden)
        if use_se:
            self.se = SEModule(hidden, reduction=4 * expand, dtype=dtype)
        self.project = _conv(hidden, out_ch, 1)
        self.project_bn = norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.dtype
        act = F.silu if self.use_se else F.relu6
        y = x
        if self.expand_ratio != 1:
            y = act(self.expand_bn(conv(y, self.expand, c)))
        y = act(self.dw_bn(conv(y, self.dw, c)))
        if self.use_se:
            y = self.se(y)
        y = self.project_bn(conv(y, self.project, c))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    # (expand, out_ch, repeats, stride)
    CFG: Tuple[Tuple[int, int, int, int], ...] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 return_features: bool = False, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.return_features = dtype, return_features

        def ch(v):
            return max(8, int(v * width_mult + 4) // 8 * 8)
        self.stem = _conv(in_chans, ch(32), 3, 2, 1)
        self.stem_bn = norm_layer(dtype)(ch(32))
        cin = ch(32)
        for bi, (t, out, reps, s) in enumerate(self.CFG):
            blocks = []
            for i in range(reps):
                blocks.append(InvertedResidual(cin, ch(out),
                                               s if i == 0 else 1, t,
                                               dtype=dtype))
                cin = ch(out)
            setattr(self, f"block{bi}", nn.ModuleList(blocks))
        self.head_conv = _conv(cin, ch(1280), 1)
        self.fc = None if return_features else nn.Linear(ch(1280),
                                                         num_classes)
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        c = self.dtype
        x = x.permute(0, 3, 1, 2).to(c)
        x = F.relu6(self.stem_bn(conv(x, self.stem, c)))
        feats = {}
        stride = 2                           # after the stem
        for bi, (_, _, _, s) in enumerate(self.CFG):
            stride *= s
            for blk in getattr(self, f"block{bi}"):
                x = blk(x)
            # the last block of each stride level: cN at stride 2^N
            nxt = self.CFG[bi + 1][3] if bi + 1 < len(self.CFG) else 2
            if nxt == 2 and stride >= 4:
                feats[f"c{stride.bit_length() - 1}"] = x
        x = F.relu6(conv(x, self.head_conv, c))
        if self.return_features:
            feats["top"] = x
            return feats
        x = x.float().mean(dim=(2, 3))
        x = dropout(x, 0.2, not self.training, rng)
        return dense(x, self.fc, c).float()


class EfficientNet(nn.Module):
    """The B0 layout scaled by (width, depth) coefficients."""
    # (expand, channels, repeats, stride, kernel)
    CFG: Tuple[Tuple[int, int, int, int, int], ...] = (
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3))

    def __init__(self, num_classes: int = 1000, width_coef: float = 1.0,
                 depth_coef: float = 1.0, dropout: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout

        def ch(v):
            return max(8, int(v * width_coef + 4) // 8 * 8)
        self.stem = _conv(in_chans, ch(32), 3, 2, 1)
        self.stem_bn = norm_layer(dtype)(ch(32))
        cin = ch(32)
        for bi, (t, out, reps, s, k) in enumerate(self.CFG):
            blocks = []
            for i in range(int(math.ceil(reps * depth_coef))):
                blocks.append(InvertedResidual(cin, ch(out),
                                               s if i == 0 else 1, t, k,
                                               use_se=True, dtype=dtype))
                cin = ch(out)
            setattr(self, f"block{bi}", nn.ModuleList(blocks))
        self.head_conv = _conv(cin, ch(1280), 1)
        self.fc = nn.Linear(ch(1280), num_classes)
        _init(self, generator)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.dtype
        x = x.permute(0, 3, 1, 2).to(c)
        x = F.silu(self.stem_bn(conv(x, self.stem, c)))
        for bi in range(len(self.CFG)):
            for blk in getattr(self, f"block{bi}"):
                x = blk(x)
        x = F.silu(conv(x, self.head_conv, c))
        x = x.float().mean(dim=(2, 3))
        x = dropout(x, self.dropout, not self.training, rng)
        return dense(x, self.fc, c).float()


@MODELS.register("shufflenet_v2_x1_0")
def shufflenet_v2_x1_0(num_classes: int = 1000, **kw):
    return ShuffleNetV2(num_classes=num_classes, **kw)


@MODELS.register("mobilenet_v2")
def mobilenet_v2(num_classes: int = 1000, **kw):
    return MobileNetV2(num_classes=num_classes, **kw)


_EFFNET_SCALING = {          # width, depth, dropout (B0..B7 table)
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5),
}


def _effnet(suffix: str, w: float, d: float, p: float):
    name = f"efficientnet_{suffix}"

    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        return EfficientNet(num_classes=num_classes, width_coef=w,
                            depth_coef=d, dropout=p, **kw)
    build.__name__ = name
    return build


(efficientnet_b0, efficientnet_b1, efficientnet_b2, efficientnet_b3,
 efficientnet_b4, efficientnet_b5, efficientnet_b6, efficientnet_b7) = (
    _effnet(s, *v) for s, v in _EFFNET_SCALING.items())
