"""Supervised-contrastive pretraining model and SWA — the port of
``deeplearning_tpu/models/ssl/supcon.py``.

A ResNet encoder (``encoder``: ResNet-18 or -50, its pooled c5), a
two-layer projection head (``proj1``, ``proj2``) whose output is
L2-normalised (``ops/losses.safe_normalize``: finite at zero), and with
``num_classes`` > 0 a linear ``classifier`` on the pooled features for
the fine-tune phase. Both heads always exist, as in JAX. ``mode``:
"projection" (the default), "features" or "classify". Same flax names,
so a flax tree converts one to one. Train with
``ops/losses.supcon_loss`` over (B, V, D) views.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops.losses import safe_normalize
from ..classification.resnet import ResNet
from ..layers import dense, init_flax_

__all__ = ["SupConModel", "swa_update"]

_SIZES = {"resnet18": ((2, 2, 2, 2), "basic"),
          "resnet50": ((3, 4, 6, 3), "bottleneck")}


class SupConModel(nn.Module):
    def __init__(self, backbone: str = "resnet18", proj_dim: int = 128,
                 num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes, block = _SIZES[backbone]
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.encoder = ResNet(stage_sizes=sizes, block=block,
                              return_features=True, dtype=dtype,
                              generator=gen)
        width = self.encoder.out_channels
        self.proj1 = nn.Linear(width, width)
        self.proj2 = nn.Linear(width, proj_dim)
        self.classifier = (nn.Linear(width, num_classes)
                           if num_classes > 0 else None)
        self.dtype = dtype
        # the heads (the trunk initialised itself)
        for child in self.children():
            if child is not self.encoder:
                init_flax_(child, gen)

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None,
                mode: str = "projection") -> torch.Tensor:
        del rng
        h = self.encoder(x)["c5"].float().mean(dim=(2, 3))
        if mode == "features":
            return h
        if mode == "classify":
            if self.classifier is None:
                raise ValueError("num_classes must be set for classify mode")
            return dense(h, self.classifier, self.dtype).float()
        z = F.relu(dense(h, self.proj1, self.dtype))
        return safe_normalize(dense(z, self.proj2, self.dtype).float(),
                              axis=-1)


@torch.no_grad()
def swa_update(swa_params: Optional[Dict[str, torch.Tensor]],
               params: Dict[str, torch.Tensor], n_averaged: int):
    """Running equal-weight average of parameters (SupCon swa.py): call at
    each SWA checkpoint; returns (new average, n + 1). The average is a
    new dict of new tensors."""
    if swa_params is None:
        return {k: v.detach().clone() for k, v in params.items()}, 1
    new = {k: s + (params[k].to(s.dtype) - s) / (n_averaged + 1)
           for k, s in swa_params.items()}
    return new, n_averaged + 1


@MODELS.register("supcon_resnet18")
def supcon_resnet18(num_classes: int = 0, **kw):
    return SupConModel(backbone="resnet18", num_classes=num_classes, **kw)


@MODELS.register("supcon_resnet50")
def supcon_resnet50(num_classes: int = 0, **kw):
    return SupConModel(backbone="resnet50", num_classes=num_classes, **kw)
