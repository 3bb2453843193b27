"""HRNet — the port of ``deeplearning_tpu/models/segmentation/hrnet.py``:
parallel multi-resolution streams with cross-resolution fusion, under a
segmentation head (logits at the input size) or a keypoint head
(heatmaps at stride 4, ``models/pose/hrnet_pose.py``).

Same modules and flax names (``stem1``, ``stem2``, ``trans{s}``,
``s{stage}_r{stream}_b{block}``, ``fuse{s}`` with ``up{j}to{i}`` and
``down{j}to{i}_{k}``, ``head_conv``, ``cls``), so a flax tree converts one
to one; ``down{j}to{i}_{k}`` is entry k of the list ``down{j}to{i}``, as
the converter names ``name_k``. Every ConvBN pads as torch does
(``ops/padding.torch_pad``: symmetric (k − 1) / 2, also at stride 2).
The input is NHWC and the output NHWC in float32; the convolutions run
in NCHW on a channels-last view, and every upsampling is
``jax.image.resize``'s bilinear kernel (``ops/resize.resize``) in the
compute dtype, as JAX's is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.padding import conv_padding
from ...ops.resize import resize
from ..classification.resnet import norm_layer
from ..layers import conv, init_flax_

__all__ = ["ConvBN", "BasicResBlock", "FuseLayer", "HRNet"]


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride,
                              conv_padding(kernel), bias=False)
        self.bn = norm_layer(dtype)(features)
        self.relu, self.dtype = relu, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv(x, self.conv, self.dtype))
        return F.relu(x) if self.relu else x


class BasicResBlock(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c1 = ConvBN(cin, features, dtype=dtype)
        self.c2 = ConvBN(features, features, relu=False, dtype=dtype)
        self.proj = (ConvBN(cin, features, kernel=1, relu=False, dtype=dtype)
                     if cin != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class FuseLayer(nn.Module):
    """Every stream takes the sum of all streams at its resolution: a
    higher-resolution one through repeated stride-2 ConvBNs, a lower one
    through a 1×1 ConvBN and a bilinear resize."""

    def __init__(self, widths: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n = n = len(widths)
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"up{j}to{i}",
                            ConvBN(widths[j], widths[i], kernel=1,
                                   relu=False, dtype=dtype))
                elif j < i:
                    setattr(self, f"down{j}to{i}", nn.ModuleList(
                        ConvBN(widths[j], widths[i] if k == i - j - 1
                               else widths[j], stride=2,
                               relu=k != i - j - 1, dtype=dtype)
                        for k in range(i - j)))

    def forward(self, streams):
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = streams[j]
                if j > i:
                    y = getattr(self, f"up{j}to{i}")(y)
                    y = resize(y, streams[i].shape, "bilinear")
                elif j < i:
                    for layer in getattr(self, f"down{j}to{i}"):
                        y = layer(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    def __init__(self, num_classes: int = 19, base_width: int = 18,
                 head: str = "seg", blocks_per_stage: int = 2,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in ("seg", "keypoints", "features"):
            raise ValueError(head)
        w = base_width
        widths = [w, w * 2, w * 4, w * 8]
        self.head, self.blocks_per_stage = head, blocks_per_stage
        self.num_classes, self.dtype = num_classes, dtype
        self.stem1 = ConvBN(in_chans, 64, stride=2, dtype=dtype)
        self.stem2 = ConvBN(64, 64, stride=2, dtype=dtype)
        chans = [64]
        for stage in range(4):
            if stage > 0:
                setattr(self, f"trans{stage}",
                        ConvBN(chans[-1], widths[stage], stride=2,
                               dtype=dtype))
                chans.append(widths[stage])
            for si in range(len(chans)):
                for bi in range(blocks_per_stage):
                    setattr(self, f"s{stage}_r{si}_b{bi}",
                            BasicResBlock(chans[si], widths[si], dtype))
                    chans[si] = widths[si]
            if stage > 0:
                setattr(self, f"fuse{stage}",
                        FuseLayer(widths[:len(chans)], dtype))
        if head != "features":
            self.head_conv = ConvBN(sum(widths), sum(widths), kernel=1,
                                    dtype=dtype)
            self.cls = nn.Conv2d(sum(widths), num_classes, 1)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        """(B, H, W, C) → segmentation logits (B, H, W, classes), or
        heatmaps (B, H/4, W/4, keypoints), float32; "features": the four
        NCHW streams."""
        del rng
        in_h, in_w = images.shape[1:3]
        x = self.stem2(self.stem1(images.permute(0, 3, 1, 2).to(self.dtype)))
        streams = [x]
        for stage in range(4):
            if stage > 0:
                streams.append(getattr(self, f"trans{stage}")(streams[-1]))
            new = []
            for si, s in enumerate(streams):
                for bi in range(self.blocks_per_stage):
                    s = getattr(self, f"s{stage}_r{si}_b{bi}")(s)
                new.append(s)
            streams = new
            if stage > 0:
                streams = getattr(self, f"fuse{stage}")(streams)
        if self.head == "features":
            return streams
        b, _, h, w = streams[0].shape
        ups = [streams[0]] + [resize(s, (b, s.shape[1], h, w), "bilinear")
                              for s in streams[1:]]
        y = self.head_conv(torch.cat(ups, dim=1))
        y = conv(y, self.cls, self.dtype).float()
        if self.head == "seg":
            y = resize(y, (b, self.num_classes, in_h, in_w), "bilinear")
        return y.permute(0, 2, 3, 1)


@MODELS.register("hrnet_w18_seg")
def hrnet_w18_seg(num_classes: int = 19, **kw):
    return HRNet(num_classes=num_classes, base_width=18, head="seg", **kw)


@MODELS.register("hrnet_w48_seg")
def hrnet_w48_seg(num_classes: int = 19, **kw):
    return HRNet(num_classes=num_classes, base_width=48, head="seg", **kw)
