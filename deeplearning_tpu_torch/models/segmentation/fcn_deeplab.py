"""FCN-ResNet50 and DeepLabV3/V3+ — the port of
``deeplearning_tpu/models/segmentation/fcn_deeplab.py``.

The port's ResNet-50 with ``return_features`` under an FCN head, an ASPP
head (dilated 3×3 convolutions at rates 12, 24, 36 and an image-pooling
branch) or ASPP plus DeepLabV3+'s low-level fusion with c2. Same flax
names (``backbone``, ``head``, ``aspp``, ``cls``, ``low_proj``,
``low_bn``, ``fuse``, ``fuse_bn``, ``aux_head``), so a flax tree converts
one to one (a dilated HWIO kernel like any other conv kernel).

The input is NHWC and the logits come back NHWC in float32, resized to
the input with ``jax.image.resize``'s bilinear kernel
(``ops/resize.resize``). In train mode ``SegModel`` returns ``(logits,
aux_logits)``, the FCN auxiliary head on c4; ``aux_head`` exists in every
mode (JAX creates its parameters under an eval-mode init too) but runs
only in train mode, where its output is used. The dropouts draw from the
step's generator (``rng=``) and raise without one in train mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.resize import resize
from ..classification.resnet import ResNet, norm_layer
from ..classification.vit import dropout
from ..layers import conv, init_flax_

__all__ = ["FCNHead", "ASPP", "SegModel"]


class FCNHead(nn.Module):
    def __init__(self, cin: int, channels: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, channels, 3, 1, 1, bias=False)
        self.bn = norm_layer(dtype)(channels)
        self.cls = nn.Conv2d(channels, num_classes, 1)
        self.dtype = dtype

    def forward(self, x, rng: Optional[torch.Generator] = None):
        x = F.relu(self.bn(conv(x, self.conv, self.dtype)))
        x = dropout(x, 0.1, not self.training, rng)
        return conv(x, self.cls, self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling."""

    def __init__(self, cin: int, channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = norm_layer(dtype)
        self.rates = tuple(rates)
        self.b0 = nn.Conv2d(cin, channels, 1, bias=False)
        self.b0_bn = norm(channels)
        for i, r in enumerate(self.rates):
            setattr(self, f"b{i + 1}", nn.Conv2d(cin, channels, 3, 1, r, r,
                                                 bias=False))
            setattr(self, f"b{i + 1}_bn", norm(channels))
        self.pool = nn.Conv2d(cin, channels, 1, bias=False)
        self.pool_bn = norm(channels)
        self.project = nn.Conv2d(channels * (len(self.rates) + 2), channels,
                                 1, bias=False)
        self.project_bn = norm(channels)
        self.channels, self.dtype = channels, dtype

    def forward(self, x, rng: Optional[torch.Generator] = None):
        branches = [F.relu(self.b0_bn(conv(x, self.b0, self.dtype)))]
        for i in range(len(self.rates)):
            y = conv(x, getattr(self, f"b{i + 1}"), self.dtype)
            branches.append(F.relu(getattr(self, f"b{i + 1}_bn")(y)))
        b, _, h, w = x.shape
        g = x.mean(dim=(2, 3), keepdim=True)
        g = F.relu(self.pool_bn(conv(g, self.pool, self.dtype)))
        branches.append(g.expand(b, self.channels, h, w))
        y = conv(torch.cat(branches, dim=1), self.project, self.dtype)
        y = F.relu(self.project_bn(y))
        return dropout(y, 0.5, not self.training, rng)


class SegModel(nn.Module):
    """Backbone + head, logits upsampled to the input size; the FCN
    auxiliary head on c4 in train mode."""

    def __init__(self, num_classes: int, head: str = "fcn",
                 backbone_sizes: Sequence[int] = (3, 4, 6, 3),
                 aux: bool = True, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in ("fcn", "deeplabv3", "deeplabv3plus"):
            raise ValueError(head)
        self.head_kind, self.aux = head, aux
        self.num_classes, self.dtype = num_classes, dtype
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = ResNet(stage_sizes=backbone_sizes,
                               return_features=True, dtype=dtype,
                               generator=gen)
        c5 = self.backbone.out_channels
        if head == "fcn":
            self.head = FCNHead(c5, 512, num_classes, dtype)
        else:
            self.aspp = ASPP(c5, dtype=dtype)
            if head == "deeplabv3plus":
                norm = norm_layer(dtype)
                self.low_proj = nn.Conv2d(c5 // 8, 48, 1, bias=False)
                self.low_bn = norm(48)
                self.fuse = nn.Conv2d(256 + 48, 256, 3, 1, 1, bias=False)
                self.fuse_bn = norm(256)
            self.cls = nn.Conv2d(256, num_classes, 1)
        if aux:
            self.aux_head = FCNHead(c5 // 2, 256, num_classes, dtype)
        # the heads (the trunk initialised itself)
        for child in self.children():
            if child is not self.backbone:
                init_flax_(child, gen)

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        b, h, w, _ = images.shape
        feats = self.backbone(images)
        c4, c5 = feats["c4"], feats["c5"]
        if self.head_kind == "fcn":
            logits = self.head(c5, rng)
        else:
            y = self.aspp(c5, rng)
            if self.head_kind == "deeplabv3plus":
                low = feats["c2"]
                y = resize(y, y.shape[:2] + low.shape[2:], "bilinear")
                low = F.relu(self.low_bn(conv(low, self.low_proj,
                                              self.dtype)))
                y = conv(torch.cat([y, low], dim=1), self.fuse, self.dtype)
                y = F.relu(self.fuse_bn(y))
            logits = conv(y, self.cls, self.dtype)
        shape = (b, self.num_classes, h, w)
        logits = resize(logits.float(), shape, "bilinear").permute(0, 2, 3, 1)
        if self.aux and self.training:
            aux = resize(self.aux_head(c4, rng).float(), shape, "bilinear")
            return logits, aux.permute(0, 2, 3, 1)
        return logits


@MODELS.register("fcn_resnet50")
def fcn_resnet50(num_classes: int = 21, **kw):
    return SegModel(num_classes=num_classes, head="fcn", **kw)


@MODELS.register("deeplabv3_resnet50")
def deeplabv3_resnet50(num_classes: int = 21, **kw):
    return SegModel(num_classes=num_classes, head="deeplabv3", **kw)


@MODELS.register("deeplabv3plus_resnet50")
def deeplabv3plus_resnet50(num_classes: int = 21, **kw):
    return SegModel(num_classes=num_classes, head="deeplabv3plus", **kw)
