"""VGG and GoogLeNet (Inception v1) — the port of
``deeplearning_tpu/models/classification/cnns.py``.

Same layers, flax names and factories (``vgg11`` … ``vgg19`` with
BatchNorm, ``googlenet``), so a flax tree converts one to one
(``utils/convert.from_flax_params``). The input is NHWC and ``dtype`` the
compute type over float32 parameters; the logits come back in float32.
The convolutions run in NCHW on a channels-last view; "SAME" pools pad as
XLA does (the odd pixel after, at −inf), and VGG's feature map is
flattened in flax's H, W, C order before ``fc1``. BatchNorm is flax's
``momentum=0.9`` (torch's 0.1) with epsilon 1e-5.

GoogLeNet returns ``(logits, (aux1, aux2))`` in train mode, the aux heads
after ``inc4a`` and ``inc4d`` (the classification loss weighs them 0.3),
and the logits alone in eval mode, where the aux heads do not run. Every
dropout mask is drawn from the step's generator (``rng=``).

flax infers each first Dense's input width at init; the port builds its
parameters up front, so VGG (``fc1``: 7·7·512 inputs at 224²) and
GoogLeNet (the aux heads' ``fc1``) take ``img_size`` (default 224), and
both take ``in_chans`` (default 3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..layers import conv, dense, init_flax_, max_pool, nhwc_flatten
from .resnet import norm_layer
from .vit import dropout

__all__ = ["VGG_CFGS", "VGG", "InceptionBlock", "AuxHead", "GoogLeNet"]

VGG_CFGS: Dict[str, Sequence[Union[int, str]]] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = True) -> nn.Conv2d:
    """A conv with symmetric padding k // 2 (flax "SAME" at stride 1)."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias)


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 1000,
                 use_bn: bool = True, dtype: torch.dtype = torch.bfloat16,
                 img_size: int = 224, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.use_bn, self.dtype = tuple(cfg), use_bn, dtype
        norm = norm_layer(dtype)
        cin, side, i = in_chans, img_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
                continue
            setattr(self, f"conv{i}", _conv(cin, int(v), 3, bias=not use_bn))
            if use_bn:
                setattr(self, f"bn{i}", norm(int(v)))
            cin, i = int(v), i + 1
        self.n_convs = i
        self.fc1 = nn.Linear(side * side * cin, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x, 2, 2)
                continue
            x = conv(x, getattr(self, f"conv{i}"), self.dtype)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x)
            x, i = F.relu(x), i + 1
        x = nhwc_flatten(x)
        for fc in (self.fc1, self.fc2):
            x = F.relu(dense(x, fc, self.dtype))
            x = dropout(x, 0.5, not self.training, rng)
        return dense(x, self.fc3, self.dtype).float()


class InceptionBlock(nn.Module):
    def __init__(self, cin: int, c1: int, c2: Tuple[int, int],
                 c3: Tuple[int, int], c4: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.b1 = _conv(cin, c1, 1)
        self.b2a, self.b2b = _conv(cin, c2[0], 1), _conv(c2[0], c2[1], 3)
        self.b3a, self.b3b = _conv(cin, c3[0], 1), _conv(c3[0], c3[1], 5)
        self.b4 = _conv(cin, c4, 1)
        self.out_channels = c1 + c2[1] + c3[1] + c4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(layer, y):
            return F.relu(conv(y, layer, self.dtype))
        b1 = c(self.b1, x)
        b2 = c(self.b2b, c(self.b2a, x))
        b3 = c(self.b3b, c(self.b3a, x))
        b4 = c(self.b4, max_pool(x, 3, 1, "SAME"))
        return torch.cat([b1, b2, b3, b4], dim=1)


class AuxHead(nn.Module):
    """5x5 / 3 average pool (VALID), a 1x1 conv to 128, two Dense."""

    def __init__(self, cin: int, side: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        pooled = max((side - 5) // 3 + 1, 0)
        self.conv = _conv(cin, 128, 1)
        self.fc1 = nn.Linear(pooled * pooled * 128, 1024)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if min(x.shape[2:]) < 5:     # flax's VALID pool: nothing left
            x = x.new_zeros((x.shape[0], 0))
        else:
            x = F.relu(conv(F.avg_pool2d(x, 5, 3), self.conv, self.dtype))
            x = nhwc_flatten(x)
        x = F.relu(dense(x, self.fc1, self.dtype))
        x = dropout(x, 0.7, not self.training, rng)
        return dense(x, self.fc2, self.dtype).float()


# name, c1, c2, c3, c4 of each inception block, "M" a SAME 3x3 / 2 pool
_INCEPTION = (("inc3a", 64, (96, 128), (16, 32), 32),
              ("inc3b", 128, (128, 192), (32, 96), 64), "M",
              ("inc4a", 192, (96, 208), (16, 48), 64),
              ("inc4b", 160, (112, 224), (24, 64), 64),
              ("inc4c", 128, (128, 256), (24, 64), 64),
              ("inc4d", 112, (144, 288), (32, 64), 64),
              ("inc4e", 256, (160, 320), (32, 128), 128), "M",
              ("inc5a", 256, (160, 320), (32, 128), 128),
              ("inc5b", 384, (192, 384), (48, 128), 128))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 1000, aux_logits: bool = True,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 224,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aux_logits, self.dtype = aux_logits, dtype
        self.conv1 = _conv(in_chans, 64, 7, 2)
        self.conv2 = _conv(64, 64, 1)
        self.conv3 = _conv(64, 192, 3)
        cin = 192
        side = math.ceil(math.ceil(math.ceil(img_size / 2) / 2) / 2)
        for spec in _INCEPTION:
            if spec == "M":
                side = math.ceil(side / 2)
                continue
            name, c1, c2, c3, c4 = spec
            blk = InceptionBlock(cin, c1, c2, c3, c4, dtype)
            setattr(self, name, blk)
            cin = blk.out_channels
            if aux_logits and name in ("inc4a", "inc4d"):
                setattr(self, "aux1" if name == "inc4a" else "aux2",
                        AuxHead(cin, side, num_classes, dtype))
        self.fc = nn.Linear(cin, num_classes)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        c = self.dtype
        x = x.permute(0, 3, 1, 2).to(c)
        x = max_pool(F.relu(conv(x, self.conv1, c)), 3, 2, "SAME")
        x = F.relu(conv(x, self.conv2, c))
        x = max_pool(F.relu(conv(x, self.conv3, c)), 3, 2, "SAME")
        heads = self.aux_logits and self.training
        aux = []
        for spec in _INCEPTION:
            if spec == "M":
                x = max_pool(x, 3, 2, "SAME")
                continue
            x = getattr(self, spec[0])(x)
            if heads and spec[0] in ("inc4a", "inc4d"):
                head = self.aux1 if spec[0] == "inc4a" else self.aux2
                aux.append(head(x, rng))
        x = x.float().mean(dim=(2, 3))
        x = dropout(x, 0.4, not self.training, rng)
        logits = dense(x, self.fc, c).float()
        return (logits, tuple(aux)) if heads else logits


def _vgg(name: str, cfg):
    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        return VGG(cfg=cfg, num_classes=num_classes, **kw)
    build.__name__ = name
    return build


vgg11, vgg13, vgg16, vgg19 = (_vgg(n, c) for n, c in VGG_CFGS.items())


@MODELS.register("googlenet")
def googlenet(num_classes: int = 1000, **kw):
    return GoogLeNet(num_classes=num_classes, **kw)
