"""MADNet, real-time self-adaptive stereo, and MAD online adaptation —
the port of ``deeplearning_tpu/models/stereo/madnet.py``.

A shared six-level pyramid (``tower``: stride-2 and stride-1 3×3 convs,
leaky ReLU 0.2, TF "SAME" padding as the reference's TF port has it),
then coarse to fine from level 6 to level 2: the right features warped
by the upsampled disparity, a 1-D correlation volume, and a decoder
(``D6`` … ``D2``) predicting a residual disparity. The finest level sits
at stride 4, so the full-size disparity is its bilinear upsample times 4.
Same flax names, so a flax tree converts one to one.

The public functions keep JAX's NHWC layout: ``warp_right_to_left``
(bilinear along x, clamped, zero outside [0, W − 1]),
``correlation_1d`` and ``photometric_loss`` (SSIM + L1, its 3×3 average
pool with SAME padding counting the zero padding in its divisor, as
flax's ``avg_pool`` does). The model returns ``{"disparity": (B, H, W,
1) float32, "pyramid": [...]}``; its convolutions run in NCHW on
channels-last views.

``MADSampler`` is the host-side reward-softmax block sampler, the JAX
package's numpy verbatim; ``MADNet.block_names()`` lists the top-level
blocks in flax's order (``tower``, ``D6`` … ``D2``), so a seed and a
loss history pick the same blocks in both, and ``grad_mask`` gives a
{parameter name: 1.0 / 0.0} mask over ``named_parameters()``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.resize import resize
from ..layers import conv, init_flax_, pad_same

__all__ = ["warp_right_to_left", "correlation_1d", "PyramidTower",
           "DispEstimator", "MADNet", "photometric_loss", "MADSampler"]


def warp_right_to_left(right: torch.Tensor,
                       disparity: torch.Tensor) -> torch.Tensor:
    """Sample right (B, H, W, C) at x − d, d = disparity (B, H, W, 1),
    bilinearly along x."""
    b, h, w, c = right.shape
    xs = torch.arange(w, dtype=torch.float32, device=right.device)
    src = xs[None, None, :] - disparity[..., 0]
    x0 = torch.clamp(torch.floor(src), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wx = (src - x0)[..., None]
    v0 = torch.gather(right, 2, x0.long()[..., None].expand(b, h, w, c))
    v1 = torch.gather(right, 2, x1.long()[..., None].expand(b, h, w, c))
    out = v0 * (1 - wx) + v1 * wx
    valid = (src >= 0) & (src <= w - 1)
    return out * valid[..., None]


def correlation_1d(left: torch.Tensor, right: torch.Tensor,
                   max_disp: int = 8) -> torch.Tensor:
    """Horizontal correlation volume (B, H, W, max_disp + 1): the channel
    mean of left · right shifted right by d."""
    w = left.shape[2]
    costs = []
    for d in range(max_disp + 1):
        shifted = F.pad(right, (0, 0, d, 0))[:, :, :w]
        costs.append(torch.mean(left * shifted, dim=-1))
    return torch.stack(costs, dim=-1)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class PyramidTower(nn.Module):
    """Shared feature pyramid: six levels, stride 2 each."""

    def __init__(self, widths: Sequence[int] = (16, 32, 64, 96, 128, 192),
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3):
        super().__init__()
        self.widths, self.dtype = tuple(widths), dtype
        cin = in_chans
        for i, wdt in enumerate(self.widths):
            setattr(self, f"conv{i}a", nn.Conv2d(cin, wdt, 3, 2))
            setattr(self, f"conv{i}b", nn.Conv2d(wdt, wdt, 3, 1, 1))
            cin = wdt

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW in, the six NCHW levels out."""
        feats = []
        for i in range(len(self.widths)):
            x = _leaky(conv(pad_same(x, 3, 2), getattr(self, f"conv{i}a"),
                            self.dtype))
            x = _leaky(conv(x, getattr(self, f"conv{i}b"), self.dtype))
            feats.append(x)
        return feats


class DispEstimator(nn.Module):
    """Per-level disparity decoder over [corr, left features, upsampled
    disparity]."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, wdt in enumerate((128, 128, 96, 64, 32)):
            setattr(self, f"c{i}", nn.Conv2d(cin, wdt, 3, 1, 1))
            cin = wdt
        self.pred = nn.Conv2d(cin, 1, 3, 1, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = _leaky(conv(x, getattr(self, f"c{i}"), self.dtype))
        return conv(x, self.pred, self.dtype).float()


class MADNet(nn.Module):
    def __init__(self, max_disp: int = 8,
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_disp, self.dtype = max_disp, dtype
        self.tower = PyramidTower(dtype=dtype, in_chans=in_chans)
        self.levels = len(self.tower.widths)
        # coarse to fine, created (and so listed) in flax's order
        for li in reversed(range(1, self.levels)):
            setattr(self, f"D{li + 1}", DispEstimator(
                max_disp + 1 + self.tower.widths[li] + 1, dtype))
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def block_names(self) -> List[str]:
        """The top-level blocks MAD samples, in flax's order."""
        return [name for name, _ in self.named_children()]

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> Dict[str, Any]:
        del rng
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        lf = self.tower(nchw(left).to(self.dtype))
        rf = self.tower(nchw(right).to(self.dtype))
        disparities: List[torch.Tensor] = []
        disp = None
        for li in reversed(range(1, self.levels)):
            l_feat, r_feat = nhwc(lf[li]), nhwc(rf[li])
            b, h, w, _ = l_feat.shape
            if disp is not None:
                disp_up = resize(disp, (b, h, w, 1), "bilinear") * 2.0
                r_feat = warp_right_to_left(r_feat, disp_up)
            else:
                disp_up = torch.zeros((b, h, w, 1), dtype=torch.float32,
                                      device=l_feat.device)
            corr = correlation_1d(l_feat.float(), r_feat.float(),
                                  self.max_disp)
            inp = torch.cat([corr.to(self.dtype), l_feat,
                             disp_up.to(self.dtype)], dim=-1)
            residual = nhwc(getattr(self, f"D{li + 1}")(nchw(inp)))
            disp = F.relu(disp_up + residual)
            disparities.append(disp)
        b, h, w, _ = left.shape
        full = resize(disp, (b, h, w, 1), "bilinear") * 4.0
        return {"disparity": full, "pyramid": disparities}


def photometric_loss(left: torch.Tensor, right: torch.Tensor,
                     disparity: torch.Tensor,
                     alpha: float = 0.85) -> torch.Tensor:
    """alpha · DSSIM + (1 − alpha) · L1 of left against the warped right
    (a 3×3 SSIM)."""
    warped = warp_right_to_left(right, disparity)
    l1 = torch.abs(left - warped)

    def pool(x):        # NHWC, SAME, the zero padding counted
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1,
                         count_include_pad=True)
        return y.permute(0, 2, 3, 1)
    mu_x, mu_y = pool(left), pool(warped)
    sx = pool(left ** 2) - mu_x ** 2
    sy = pool(warped ** 2) - mu_y ** 2
    sxy = pool(left * warped) - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sx + sy + c2))
    dssim = torch.clamp((1 - ssim) / 2, 0, 1)
    return torch.mean(alpha * dssim + (1 - alpha) * l1)


class MADSampler:
    """Reward-softmax block selection (Stereo_Online_Adaptation.py +
    sampler_factory.py): a score a block, a sample of blocks to adapt a
    frame, scores moved by the loss improvement. Host-side numpy."""

    def __init__(self, block_names: Sequence[str], sample_n: int = 2,
                 temperature: float = 1.0, ema: float = 0.99,
                 mode: str = "probabilistic", seed: int = 0):
        self.blocks = list(block_names)
        self.scores = np.zeros(len(self.blocks))
        self.sample_n = sample_n
        self.temperature = temperature
        self.ema = ema
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.last_loss: Optional[float] = None
        self._round_robin = 0

    def sample(self) -> List[str]:
        if self.mode == "full":
            return list(self.blocks)
        if self.mode == "none":
            return []
        if self.mode == "sequential":
            sel = [self.blocks[self._round_robin % len(self.blocks)]]
            self._round_robin += 1
            return sel
        if self.mode == "argmax":
            order = np.argsort(-self.scores)
            return [self.blocks[i] for i in order[:self.sample_n]]
        if self.mode == "random":
            idx = self.rng.choice(len(self.blocks), self.sample_n,
                                  replace=False)
            return [self.blocks[i] for i in idx]
        # probabilistic (reward softmax)
        p = np.exp(self.scores / self.temperature)
        p = p / p.sum()
        idx = self.rng.choice(len(self.blocks), self.sample_n,
                              replace=False, p=p)
        return [self.blocks[i] for i in idx]

    def update(self, selected: Sequence[str], loss: float) -> None:
        if self.last_loss is not None:
            reward = self.last_loss - loss         # improvement
            for name in selected:
                i = self.blocks.index(name)
                self.scores[i] = self.ema * self.scores[i] \
                    + (1 - self.ema) * reward
        self.last_loss = loss

    def grad_mask(self, params: Dict[str, torch.Tensor],
                  selected: Sequence[str]) -> Dict[str, float]:
        """{parameter name: 1.0 / 0.0}: gradients flow only into the
        selected top-level blocks (the MAD partial backprop as a
        multiply)."""
        sel = set(selected)
        return {k: 1.0 if k.split(".", 1)[0] in sel else 0.0
                for k in params}


@MODELS.register("madnet")
def madnet(**kw):
    return MADNet(**kw)
