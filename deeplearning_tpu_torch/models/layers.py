"""Layers the port's convolutional models share: flax's ``nn.Conv`` /
``nn.Dense`` compute-dtype semantics, flax's ``nn.BatchNorm`` over NCHW,
flax's default initialisers, and the BatchNorm helpers that give a
seed-initialised detector realistic statistics. Inside
``sync_batch_stats(group)`` a training BatchNorm takes its batch moments
over every rank of ``group`` (GSPMD's global-batch statistics, which the
mesh train step needs).

The models run their convolutions in NCHW on a channels-last view of the
NHWC input (no copy), so a permute back to NHWC before a reshape that
enumerates positions is free.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm", "conv", "dense", "lecun_normal_", "init_flax_",
           "calibrate_batchnorm", "sync_batch_stats", "pad_same",
           "max_pool", "nhwc_flatten"]

# the process group whose ranks' batches a training BatchNorm normalises
# over together; None: this rank's batch alone
_SYNC_GROUP = None


@contextlib.contextmanager
def sync_batch_stats(group):
    """Inside the block, every training BatchNorm reduces its batch mean
    and variance over ``group``'s ranks (autograd flows through the
    reduction), so each rank normalises with the global batch's moments
    and moves its running statistics by them."""
    global _SYNC_GROUP
    was, _SYNC_GROUP = _SYNC_GROUP, group
    try:
        yield
    finally:
        _SYNC_GROUP = was


def _global_moments(xf: torch.Tensor, group):
    """The biased mean and variance over dims (0, 2, 3) of the batches of
    every rank of ``group`` (the same two passes as the local path)."""
    import torch.distributed as dist
    from ..parallel import collectives
    n = xf.shape[0] * xf.shape[2] * xf.shape[3] * dist.get_world_size(group)
    mean = collectives.all_reduce_autograd(xf.sum(dim=(0, 2, 3)), group) / n
    d = xf - mean[:, None, None]
    var = collectives.all_reduce_autograd((d * d).sum(dim=(0, 2, 3)),
                                          group) / n
    return mean, var


def lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None) -> None:
    """flax's default kernel init (lecun_normal): truncated normal (±2σ)
    with variance 1 / fan_in (a conv's kh·kw·cin/groups, a dense layer's
    inputs), σ corrected for the truncation."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults over a module tree: lecun-normal conv and dense
    kernels, zero biases, BatchNorm scale 1, bias 0, mean 0, var 1. A
    model then sets its own exceptions (zero-initialised residual scales,
    prior biases, normal(0.01) heads)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator, m.in_features)
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def pad_same(x: torch.Tensor, k: Union[int, Tuple[int, int]],
             s: Union[int, Tuple[int, int]],
             value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded as flax's ``padding="SAME"`` pads a ``k`` x
    ``k`` (or (kh, kw)) window at stride ``s`` (or (sh, sw)): ceil(size /
    s) outputs, the odd pixel after (no copy when that is nothing)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (s, s) if isinstance(s, int) else s
    pads = []
    for size, kk, ss in ((x.shape[3], kw, sw), (x.shape[2], kh, sh)):
        total = max((-(-size // ss) - 1) * ss + kk - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def max_pool(x: torch.Tensor, k: int, s: int,
             padding: Union[str, int] = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` over NCHW: "VALID", "SAME" or a symmetric
    pad, the padding at −inf."""
    if padding == "SAME":
        return F.max_pool2d(pad_same(x, k, s, float("-inf")), k, s)
    return F.max_pool2d(x, k, s, 0 if padding == "VALID" else padding)


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H·W·C): the order flax's ``reshape(b, -1)``
    flattens an NHWC map in, which the Dense after it is laid out for."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=m, epsilon=eps)`` over NCHW:
    y = (x − mean) · (rsqrt(var + eps) · scale) + bias in float32, cast to
    ``dtype``. ``momentum`` is torch's (1 − flax's): YOLOX's flax 0.97 is
    0.03 here, ResNet's 0.9 is 0.1. Training normalises with the biased
    batch variance and moves the running statistics ``momentum`` toward
    it, as flax does, unless ``frozen`` (FrozenBatchNorm2d: the statistics
    stay fixed in train mode too)."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-3,
                 momentum: float = 0.03, frozen: bool = False):
        super().__init__(features, eps=eps, momentum=momentum)
        self.dtype, self.frozen = dtype, frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training and not self.frozen:
            if _SYNC_GROUP is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = xf.var(dim=(0, 2, 3), unbiased=False)
            else:
                mean, var = _global_moments(xf, _SYNC_GROUP)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    its input over ``images`` (one forward in train mode with momentum 1),
    then put the model back in eval mode. A seed-initialised network has
    mean 0 / var 1 statistics, under which its activations shrink layer by
    layer (YOLOX-S's head outputs ~1e-4 at 640²: every box its grid cell,
    every score 1.0e-4); calibrated, they keep unit scale, as a trained
    network's do. The weights are left as they are, and a frozen
    BatchNorm's statistics too."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    try:
        model(images)
    finally:
        for m, momentum in zip(bns, saved):
            m.momentum = momentum
        model.eval()
