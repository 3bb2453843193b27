"""RepVGG — the port of ``deeplearning_tpu/models/classification/repvgg.py``:
train-time 3x3 + 1x1 + identity branches, a deploy-time single 3x3.

Same layers, flax names and factories (``repvgg_a0`` … ``repvgg_b1``), so
a flax tree converts one to one (``utils/convert.from_flax_params``). The
input is NHWC and ``dtype`` the compute type over float32 parameters; the
logits come back in float32. The convolutions run in NCHW on a
channels-last view; BatchNorm is flax's ``momentum=0.9`` (torch's 0.1),
epsilon 1e-5.

``reparameterize(state_dict)`` is JAX's numpy fold applied to the port's
state dict (OIHW kernels, the BatchNorm buffers): each branch's
BatchNorm folded into its conv, the 1x1 padded to 3x3, the identity added
as a centred impulse, giving the state dict of the ``deploy=True`` model
(``stage{s}_block{i}.reparam``). Every factory takes ``in_chans``
(default 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..layers import BatchNorm, conv, dense, init_flax_
from .resnet import norm_layer

__all__ = ["RepVGGBlock", "RepVGG", "reparameterize"]


class RepVGGBlock(nn.Module):
    def __init__(self, cin: int, out_ch: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.deploy, self.dtype = deploy, dtype
        if deploy:
            self.reparam = nn.Conv2d(cin, out_ch, 3, stride, 1, groups=groups)
            return
        norm = norm_layer(dtype)
        self.dense3 = nn.Conv2d(cin, out_ch, 3, stride, 1, groups=groups,
                                bias=False)
        self.bn3 = norm(out_ch)
        self.dense1 = nn.Conv2d(cin, out_ch, 1, stride, 0, groups=groups,
                                bias=False)
        self.bn1 = norm(out_ch)
        self.bnid = norm(cin) if stride == 1 and cin == out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return F.relu(conv(x, self.reparam, self.dtype))
        y = self.bn3(conv(x, self.dense3, self.dtype)) \
            + self.bn1(conv(x, self.dense1, self.dtype))
        if self.bnid is not None:
            y = y + self.bnid(x)
        return F.relu(y)


class RepVGG(nn.Module):
    def __init__(self, num_blocks: Sequence[int] = (2, 4, 14, 1),
                 width_mult: Sequence[float] = (0.75, 0.75, 0.75, 2.5),
                 num_classes: int = 1000, deploy: bool = False,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.num_blocks = dtype, tuple(num_blocks)
        base = (64, 128, 256, 512)
        cin = min(64, int(64 * width_mult[0]))
        self.stage0 = RepVGGBlock(in_chans, cin, 2, deploy=deploy,
                                  dtype=dtype)
        for si, (n, w) in enumerate(zip(num_blocks, width_mult)):
            ch = int(base[si] * w)
            for i in range(n):
                setattr(self, f"stage{si + 1}_block{i}", RepVGGBlock(
                    cin, ch, 2 if i == 0 else 1, deploy=deploy, dtype=dtype))
                cin = ch
        self.fc = nn.Linear(cin, num_classes)
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        del rng
        x = self.stage0(x.permute(0, 3, 1, 2).to(self.dtype))
        for si, n in enumerate(self.num_blocks):
            for i in range(n):
                x = getattr(self, f"stage{si + 1}_block{i}")(x)
        x = x.float().mean(dim=(2, 3))
        return dense(x, self.fc, self.dtype).float()


def _fuse_bn(kernel: np.ndarray, sd: Dict[str, np.ndarray], bn: str,
             eps: float = 1e-5):
    """Fold BatchNorm ``bn`` (scale, bias, mean, var) into an OIHW kernel
    and a bias."""
    gamma, beta = sd[f"{bn}.weight"], sd[f"{bn}.bias"]
    mean, var = sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]
    std = np.sqrt(var + eps)
    return kernel * (gamma / std)[:, None, None, None], beta - mean * gamma / std


def reparameterize(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A train-form RepVGG state dict -> the deploy form's (one fused 3x3
    conv with bias a block), float32 as JAX's fold computes it."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    blocks = sorted({k.rsplit(".", 2)[0] for k in sd if ".dense3." in k})
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.rsplit(".", 2)[0] not in blocks:
            out[k] = torch.from_numpy(v.copy())
    for blk in blocks:
        k3, b3 = _fuse_bn(sd[f"{blk}.dense3.weight"], sd, f"{blk}.bn3")
        k1, b1 = _fuse_bn(sd[f"{blk}.dense1.weight"], sd, f"{blk}.bn1")
        kernel = k3 + np.pad(k1, ((0, 0), (0, 0), (1, 1), (1, 1)))
        bias = b3 + b1
        if f"{blk}.bnid.weight" in sd:
            out_ch, in_ch = kernel.shape[:2]
            kid = np.zeros((out_ch, in_ch, 3, 3), kernel.dtype)
            for o in range(out_ch):
                kid[o, o % in_ch, 1, 1] = 1.0
            kid, bid = _fuse_bn(kid, sd, f"{blk}.bnid")
            kernel, bias = kernel + kid, bias + bid
        out[f"{blk}.reparam.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel, np.float32))
        out[f"{blk}.reparam.bias"] = torch.from_numpy(bias.astype(np.float32))
    return out


_WIDTHS = {
    "repvgg_a0": ((2, 4, 14, 1), (0.75, 0.75, 0.75, 2.5)),
    "repvgg_a1": ((2, 4, 14, 1), (1.0, 1.0, 1.0, 2.5)),
    "repvgg_a2": ((2, 4, 14, 1), (1.5, 1.5, 1.5, 2.75)),
    "repvgg_b0": ((4, 6, 16, 1), (1.0, 1.0, 1.0, 2.5)),
    "repvgg_b1": ((4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0)),
}


def _repvgg(name: str, blocks, widths):
    @MODELS.register(name)
    def build(num_classes: int = 1000, **kw):
        return RepVGG(num_blocks=blocks, width_mult=widths,
                      num_classes=num_classes, **kw)
    build.__name__ = name
    return build


repvgg_a0, repvgg_a1, repvgg_a2, repvgg_b0, repvgg_b1 = (
    _repvgg(n, b, w) for n, (b, w) in _WIDTHS.items())
