"""MNIST CNN / FCN — the port of
``deeplearning_tpu/models/classification/lenet.py`` (the train CLI's
default model, ``mnist_cnn``).

Same layers and flax names as the JAX modules (``Conv_0``, ``Conv_1``,
``Dense_0`` … here ``Conv.0``, ``Dense.0``, so a flax tree converts one to
one through ``utils/convert.from_flax_params``). The input is NHWC and
``dtype`` the compute type over float32 parameters; the logits come back
in float32. The convolutions run in NCHW on a channels-last view, and the
feature map is flattened in flax's H, W, C order before the first Dense.

flax infers the first Dense's input width from the input at init; the
port builds its parameters up front, so the factories take ``img_size``
(default 28) and ``in_chans`` (default 3, what the serve CLI feeds; the
train CLI passes ``data.channels``). The dropout masks are drawn from the
step's generator (``rng=``); a mask drawn in train mode without one
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..layers import conv, dense, init_flax_, max_pool, nhwc_flatten
from .vit import dropout

__all__ = ["MnistCNN", "MnistFCN"]


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 28,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.Conv = nn.ModuleList([nn.Conv2d(in_chans, 32, 3, padding=1),
                                   nn.Conv2d(32, 64, 3, padding=1)])
        side = img_size // 2 // 2
        self.Dense = nn.ModuleList([nn.Linear(side * side * 64, 128),
                                    nn.Linear(128, num_classes)])
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for layer in self.Conv:
            x = max_pool(F.relu(conv(x, layer, self.dtype)), 2, 2)
        x = F.relu(dense(nhwc_flatten(x), self.Dense[0], self.dtype))
        x = dropout(x, 0.25, not self.training, rng)
        return dense(x, self.Dense[1], self.dtype).float()


class MnistFCN(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 28,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        widths = (img_size * img_size * in_chans, 512, 256, num_classes)
        self.Dense = nn.ModuleList([nn.Linear(a, b) for a, b in
                                    zip(widths[:-1], widths[1:])])
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for layer in self.Dense[:-1]:
            x = F.relu(dense(x, layer, self.dtype))
            x = dropout(x, 0.2, not self.training, rng)
        return dense(x, self.Dense[-1], self.dtype).float()


@MODELS.register("mnist_cnn")
def mnist_cnn(num_classes: int = 10, **kw) -> MnistCNN:
    return MnistCNN(num_classes=num_classes, **kw)


@MODELS.register("mnist_fcn")
def mnist_fcn(num_classes: int = 10, **kw) -> MnistFCN:
    return MnistFCN(num_classes=num_classes, **kw)
