"""ResNet family: the port of
``deeplearning_tpu/models/classification/resnet.py`` (ResNet, ResNeXt,
SE-ResNet, SK-Net, ResNeSt: one bottleneck skeleton with a pluggable
channel attention).

Same classes, parameter names and factories as the flax modules, so a
flax tree converts one to one (``utils/convert.from_flax_params``: conv
kernels HWIO → OIHW, dense kernels transposed, ``batch_stats`` into the
BatchNorm buffers). As in JAX the input is NHWC float32 and ``dtype`` is
the compute type over float32 parameters (bf16 by default); the
convolutions run in NCHW on a channels-last view of the input. The
classifier returns float32 logits; with ``return_features`` the model
returns {c2, c3, c4, c5} (NCHW, ``dtype``), the FPN detectors' backbone.

Layer semantics carried over: every conv pads symmetrically
(``ops/padding.conv_padding``: equal to "SAME" at stride 1, torch's
padding at stride 2), the stem max-pool pads with −inf, BatchNorm is
flax's ``momentum=0.9, epsilon=1e-5`` (torch momentum 0.1) with its
statistics and affine map in float32 (``models/layers.BatchNorm``), and
the last BatchNorm of each residual branch (``bn3`` of a Bottleneck,
``bn2`` of a BasicBlock) starts with scale 0. ``frozen_bn`` keeps the
statistics fixed in train mode (FrozenBatchNorm2d).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.padding import conv_padding
from ..layers import BatchNorm, conv, dense, init_flax_

__all__ = ["SEModule", "SKConv", "SplitAttention", "BasicBlock",
           "Bottleneck", "ResNet", "norm_layer"]


def _conv2d(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, conv_padding(k, dilation),
                     dilation, groups, bias=False)


def norm_layer(dtype: torch.dtype, frozen: bool = False) -> Callable:
    """The ``norm`` partial the flax blocks take: ``norm(features)`` is a
    BatchNorm at ResNet's epsilon and momentum, in ``dtype``, frozen or
    not."""
    return functools.partial(BatchNorm, dtype=dtype, eps=1e-5, momentum=0.1,
                             frozen=frozen)


class SEModule(nn.Module):
    """Squeeze-and-excitation."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 8))
        self.fc2 = nn.Linear(max(channels // reduction, 8), channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3))
        s = F.relu(dense(s, self.fc1, self.dtype))
        s = torch.sigmoid(dense(s, self.fc2, self.dtype))
        return x * s[:, :, None, None].to(x.dtype)


class SKConv(nn.Module):
    """Selective kernel: two branches (3×3, dilated 3×3), softmax-fused."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 reduction: int = 16, norm: Optional[Callable] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm or norm_layer(dtype)
        for i, dil in enumerate((1, 2)):
            setattr(self, f"branch{i}", _conv2d(cin, features, 3, stride,
                                                dilation=dil))
            setattr(self, f"bn{i}", norm(features))
        hidden = max(features // reduction, 32)
        self.fc = nn.Linear(features, hidden)
        self.select = nn.Linear(hidden, 2 * features)
        self.features, self.dtype = features, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(getattr(self, f"bn{i}")(
            conv(x, getattr(self, f"branch{i}"), self.dtype)))
            for i in range(2)]
        u = branches[0] + branches[1]
        s = u.float().mean(dim=(2, 3))
        z = F.relu(dense(s, self.fc, self.dtype))
        logits = dense(z, self.select, self.dtype).reshape(-1, 2,
                                                           self.features)
        weights = torch.softmax(logits.float(), dim=1).to(x.dtype)
        return (branches[0] * weights[:, 0, :, None, None]
                + branches[1] * weights[:, 1, :, None, None])


class SplitAttention(nn.Module):
    """ResNeSt split-attention conv (radix 2)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 radix: int = 2, reduction: int = 4,
                 norm: Optional[Callable] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm or norm_layer(dtype)
        self.conv = _conv2d(cin, features * radix, 3, stride, groups=radix)
        self.bn = norm(features * radix)
        hidden = max(features // reduction, 32)
        self.fc1 = nn.Linear(features, hidden)
        self.fc2 = nn.Linear(hidden, features * radix)
        self.features, self.radix, self.dtype = features, radix, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, f = self.radix, self.features
        u = F.relu(self.bn(conv(x, self.conv, self.dtype)))
        b, _, h, w = u.shape
        # NHWC channel c = split * features + f, as the flax reshape
        splits = u.reshape(b, r, f, h, w)
        gap = splits.sum(dim=1).float().mean(dim=(2, 3))
        z = F.relu(dense(gap, self.fc1, self.dtype))
        att = dense(z, self.fc2, self.dtype).reshape(b, r, f)
        att = torch.softmax(att.float(), dim=1).to(x.dtype)
        return (splits * att[:, :, :, None, None]).sum(dim=1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 norm: Optional[Callable] = None,
                 attention: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm or norm_layer(dtype)
        self.conv1 = _conv2d(cin, features, 3, stride)
        self.bn1 = norm(features)
        self.conv2 = _conv2d(features, features, 3)
        self.bn2 = norm(features)
        self.se = SEModule(features, dtype=dtype) if attention == "se" \
            else None
        self.down = stride != 1 or cin != features
        if self.down:
            self.downsample_conv = _conv2d(cin, features, 1, stride)
            self.downsample_bn = norm(features)
        self.dtype = dtype

    def zero_init_(self) -> None:
        nn.init.zeros_(self.bn2.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        y = self.bn2(conv(y, self.conv2, self.dtype))
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.down:
            residual = self.downsample_bn(
                conv(x, self.downsample_conv, self.dtype))
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 groups: int = 1, width_per_group: int = 64,
                 norm: Optional[Callable] = None,
                 attention: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm or norm_layer(dtype)
        width = int(features * (width_per_group / 64.0)) * groups
        out = features * 4
        self.conv1 = _conv2d(cin, width, 1)
        self.bn1 = norm(width)
        self.attention = attention
        if attention == "sk":
            self.sk = SKConv(width, width, stride, norm=norm, dtype=dtype)
        elif attention == "splat":
            self.splat = SplitAttention(width, width, stride, norm=norm,
                                        dtype=dtype)
        else:
            self.conv2 = _conv2d(width, width, 3, stride, groups=groups)
            self.bn2 = norm(width)
        self.conv3 = _conv2d(width, out, 1)
        self.bn3 = norm(out)
        self.se = SEModule(out, dtype=dtype) if attention == "se" else None
        self.down = stride != 1 or cin != out
        if self.down:
            self.downsample_conv = _conv2d(cin, out, 1, stride)
            self.downsample_bn = norm(out)
        self.dtype = dtype

    def zero_init_(self) -> None:
        nn.init.zeros_(self.bn3.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        if self.attention == "sk":
            y = self.sk(y)
        elif self.attention == "splat":
            y = self.splat(y)
        else:
            y = F.relu(self.bn2(conv(y, self.conv2, self.dtype)))
        y = self.bn3(conv(y, self.conv3, self.dtype))
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.down:
            residual = self.downsample_bn(
                conv(x, self.downsample_conv, self.dtype))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Input (B, H, W, 3) NHWC float32. Returns float32 logits, or with
    ``return_features`` {c2, c3, c4, c5} NCHW feature maps in ``dtype``."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "bottleneck",
                 num_classes: int = 1000, groups: int = 1,
                 width_per_group: int = 64, attention: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 return_features: bool = False, frozen_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be basic or bottleneck, got "
                             f"{block!r}")
        norm = norm_layer(dtype, frozen_bn)
        self.dtype, self.return_features = dtype, return_features
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = _conv2d(3, 64, 7, 2)
        self.bn1 = norm(64)
        cin = 64
        for stage, size in enumerate(self.stage_sizes):
            for i in range(size):
                stride = 2 if stage > 0 and i == 0 else 1
                features = 64 * 2 ** stage
                if block == "basic":
                    blk = BasicBlock(cin, features, stride, norm, attention,
                                     dtype)
                else:
                    blk = Bottleneck(cin, features, stride, groups,
                                     width_per_group, norm, attention, dtype)
                setattr(self, f"layer{stage + 1}_block{i}", blk)
                cin = features * blk.expansion
        self.out_channels = cin
        self.fc = None if return_features else nn.Linear(cin, num_classes)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults, and the residual branches' last BatchNorm
        scale at 0."""
        init_flax_(self, generator)
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                m.zero_init_()

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        """``rng`` is the train step's generator (``TrainState.apply_fn``
        passes one); a ResNet draws no mask from it."""
        del rng
        x = images.permute(0, 3, 1, 2).to(self.dtype)   # NCHW view
        x = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)                     # pads with −inf
        feats = {}
        for stage, size in enumerate(self.stage_sizes):
            for i in range(size):
                x = getattr(self, f"layer{stage + 1}_block{i}")(x)
            feats[f"c{stage + 2}"] = x
        if self.return_features:
            return feats
        x = x.float().mean(dim=(2, 3))
        return dense(x, self.fc, self.dtype).float()


def _factory(name: str, **defaults):
    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        return ResNet(**{**defaults, "num_classes": num_classes, **kw})
    build.__name__ = name
    return build


resnet18 = _factory("resnet18", stage_sizes=(2, 2, 2, 2), block="basic")
resnet34 = _factory("resnet34", stage_sizes=(3, 4, 6, 3), block="basic")
resnet50 = _factory("resnet50", stage_sizes=(3, 4, 6, 3))
resnet101 = _factory("resnet101", stage_sizes=(3, 4, 23, 3))
resnext50_32x4d = _factory("resnext50_32x4d", stage_sizes=(3, 4, 6, 3),
                           groups=32, width_per_group=4)
resnext101_32x8d = _factory("resnext101_32x8d", stage_sizes=(3, 4, 23, 3),
                            groups=32, width_per_group=8)
se_resnet50 = _factory("se_resnet50", stage_sizes=(3, 4, 6, 3),
                       attention="se")
se_resnet18 = _factory("se_resnet18", stage_sizes=(2, 2, 2, 2),
                       block="basic", attention="se")
sknet50 = _factory("sknet50", stage_sizes=(3, 4, 6, 3), attention="sk")
resnest50 = _factory("resnest50", stage_sizes=(3, 4, 6, 3),
                     attention="splat")
