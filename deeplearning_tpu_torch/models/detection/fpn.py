"""Feature Pyramid Network neck: the port of
``deeplearning_tpu/models/detection/fpn.py``.

Lateral 1×1 convs, a top-down path that resizes each coarser level to its
finer neighbour's size and adds it, 3×3 smoothing convs, and extra levels:
"pool" (Faster R-CNN's P6: a 1×1 max-pool at stride 2, ``x[::2, ::2]``)
or "p6p7" (RetinaNet / FCOS: two stride-2 3×3 convs from the last
backbone level, the second after a ReLU). Parameter names are flax's
(``lateral_c3``, ``smooth_c3``, ``p6``, ``p7``).

The top-down resize is ``jax.image.resize(..., "nearest")``, which samples
at half-pixel centres: torch's ``mode="nearest-exact"``, not "nearest". It
resizes to the lateral's shape, which is not 2× wherever a size halves
with a ceiling (600² gives c2..c5 of 150/75/38/19).

Levels are NCHW tensors in ``dtype`` keyed "c2".."c5" in and "p2".. out.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.padding import conv_padding
from ..layers import conv

__all__ = ["FPN", "upsample_nearest"]


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, hw, "nearest")`` of an NCHW tensor."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class FPN(nn.Module):
    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256,
                 extra_levels: str = "pool",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if extra_levels not in ("pool", "p6p7"):
            raise ValueError(f"extra_levels must be pool or p6p7, got "
                             f"{extra_levels!r}")
        self.names = sorted(in_channels, key=lambda k: int(k[1:]))
        for n in self.names:
            setattr(self, f"lateral_{n}",
                    nn.Conv2d(in_channels[n], out_channels, 1))
            setattr(self, f"smooth_{n}",
                    nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if extra_levels == "p6p7":
            self.p6 = nn.Conv2d(in_channels[self.names[-1]], out_channels, 3,
                                2, conv_padding(3))
            self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2,
                                conv_padding(3))
        self.extra_levels, self.dtype = extra_levels, dtype

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        prev: Optional[torch.Tensor] = None
        for n in reversed(self.names):
            x = conv(feats[n], getattr(self, f"lateral_{n}"), self.dtype)
            if prev is not None:
                x = x + upsample_nearest(prev, x.shape[2:])
            prev = x
            out[f"p{n[1:]}"] = conv(x, getattr(self, f"smooth_{n}"),
                                    self.dtype)
        top = int(self.names[-1][1:])
        if self.extra_levels == "pool":
            out[f"p{top + 1}"] = out[f"p{top}"][:, :, ::2, ::2]
        else:
            p6 = conv(feats[self.names[-1]], self.p6, self.dtype)
            out[f"p{top + 1}"] = p6
            out[f"p{top + 2}"] = conv(F.relu(p6), self.p7, self.dtype)
        return dict(sorted(out.items(), key=lambda kv: int(kv[0][1:])))
