"""U-Net — the port of ``deeplearning_tpu/models/segmentation/unet.py``.

Same modules and flax names (``down{i}``, ``bottleneck``, ``up{i}``,
each a DoubleConv of ``conv0``/``bn0``/``conv1``/``bn1``; ``up{i}_tconv``
without bilinear upsampling; ``head``), so a flax tree converts one to
one. The input is NHWC and the logits come back NHWC in float32;
``dtype`` is the compute type over float32 parameters and the
convolutions run in NCHW on a channels-last view. BatchNorm is flax's
(``momentum=0.9``, epsilon 1e-5); the bilinear upsampling is
``jax.image.resize``'s (``ops/resize.resize``).

The transposed convolution (``bilinear=False``) keeps flax's kernel as a
``Conv2d`` weight (HWIO → OIHW, as the converter maps any conv) and runs
it flipped: flax's ``ConvTranspose`` with a 2×2 kernel at stride 2 and
"SAME" padding writes ``x[i] · K[1 - t]`` to output ``2i + t``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.resize import resize
from ..classification.resnet import norm_layer
from ..layers import conv, init_flax_

__all__ = ["DoubleConv", "UNet"]


class DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm_layer(dtype)
        self.conv0 = nn.Conv2d(cin, features, 3, 1, 1, bias=False)
        self.bn0 = norm(features)
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn1 = norm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(conv(x, self.conv0, self.dtype)))
        return F.relu(self.bn1(conv(x, self.conv1, self.dtype)))


class UNet(nn.Module):
    def __init__(self, num_classes: int = 2, base_features: int = 64,
                 bilinear: bool = True, dtype: torch.dtype = torch.bfloat16,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = base_features
        self.bilinear, self.dtype = bilinear, dtype
        widths = [f, f * 2, f * 4, f * 8]
        cin = in_chans
        for i, w in enumerate(widths):
            setattr(self, f"down{i}", DoubleConv(cin, w, dtype))
            cin = w
        bottleneck_w = f * 16 // (2 if bilinear else 1)
        self.bottleneck = DoubleConv(cin, bottleneck_w, dtype)
        c = bottleneck_w
        for i, w in enumerate(reversed(widths)):
            if not bilinear:
                setattr(self, f"up{i}_tconv", nn.Conv2d(c, c // 2, 2))
                c = c // 2
            out_w = max(w // (2 if bilinear and i < 3 else 1), f)
            setattr(self, f"up{i}", DoubleConv(w + c, out_w, dtype))
            c = out_w
        self.head = nn.Conv2d(c, num_classes, 1)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) → logits (B, H, W, num_classes) float32."""
        del rng
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        skips = []
        for i in range(4):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for i, skip in enumerate(reversed(skips)):
            b, c, h, w = x.shape
            if self.bilinear:
                x = resize(x, (b, c, h * 2, w * 2), "bilinear")
            else:
                t = getattr(self, f"up{i}_tconv")
                weight = t.weight.to(self.dtype).flip(2, 3).transpose(0, 1)
                x = F.conv_transpose2d(x.to(self.dtype), weight,
                                       t.bias.to(self.dtype), stride=2)
            x = getattr(self, f"up{i}")(torch.cat([skip, x], dim=1))
        x = conv(x, self.head, self.dtype)
        return x.permute(0, 2, 3, 1).float()


@MODELS.register("unet")
def unet(num_classes: int = 2, **kw):
    return UNet(num_classes=num_classes, **kw)
