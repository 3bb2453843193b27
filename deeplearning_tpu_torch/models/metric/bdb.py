"""Batch-DropBlock (BDB) re-ID network and the ArcFace retrieval model —
the port of ``deeplearning_tpu/models/metric/bdb.py``.

BDB: a ResNet-50 trunk (its c5) with a global branch (pool, a 512-wide
BNNeck embedding, a classifier) and a part branch whose feature map loses
one block, the same for the whole batch, in train mode
(``batch_drop_block``), before max pooling. ArcFace: a ResNet-18 trunk, a
BNNeck embedding and the class centres ``arcface_centers`` (D, C) for
``ops/losses.arcface_logits``. Same flax names, so a flax tree converts
one to one. The BatchNorms over embeddings are flax's 1-D BatchNorm
(``momentum=0.9``, epsilon 1e-5) over the batch axis.

``batch_drop_block`` takes JAX's NHWC layout; its block position is
drawn from ``rng`` (the step's ``torch.Generator``), or given as
``position=(y0, x0)``. In train mode BDB raises without ``rng``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..classification.resnet import ResNet, norm_layer
from ..classification.vit import _require
from ..layers import conv, dense, init_flax_

__all__ = ["batch_drop_block", "BDBNetwork", "ArcFaceModel"]


def batch_drop_block(x: torch.Tensor, rng: Optional[torch.Generator],
                     h_ratio: float, w_ratio: float,
                     position: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Zero one (rh, rw) block, the same across the batch, of x (B, H, W,
    C): rh = max(round(H · h_ratio), 1), rw likewise; the top-left corner
    uniform over the positions that fit."""
    b, h, w, c = x.shape
    rh = max(int(round(h * h_ratio)), 1)
    rw = max(int(round(w * w_ratio)), 1)
    if position is None:
        gen = _require(rng, "batch_drop_block")
        dev = gen.device
        y0 = torch.randint(0, h - rh + 1, (), generator=gen, device=dev)
        x0 = torch.randint(0, w - rw + 1, (), generator=gen, device=dev)
        y0, x0 = y0.to(x.device), x0.to(x.device)
    else:
        y0, x0 = position
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    block = ((rows >= y0) & (rows < y0 + rh)
             & (cols >= x0) & (cols < x0 + rw))
    return x * (1.0 - block[None, :, :, None].to(x.dtype))


def _bn1d(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """flax BatchNorm over (B, F) features: the 2-D BatchNorm on a
    (B, F, 1, 1) view."""
    return bn(x[:, :, None, None])[:, :, 0, 0]


class BDBNetwork(nn.Module):
    def __init__(self, num_classes: int, feat_dim: int = 512,
                 drop_height_ratio: float = 0.33,
                 drop_width_ratio: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm = norm_layer(dtype)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = ResNet(stage_sizes=(3, 4, 6, 3),
                               return_features=True, dtype=dtype,
                               generator=gen)
        c5 = self.backbone.out_channels
        self.global_reduce = nn.Linear(c5, feat_dim, bias=False)
        self.global_bn = norm(feat_dim)
        self.global_cls = nn.Linear(feat_dim, num_classes)
        self.part_conv = nn.Conv2d(c5, 1024, 1, bias=False)
        self.part_conv_bn = norm(1024)
        self.part_reduce = nn.Linear(1024, 1024, bias=False)
        self.part_bn = norm(1024)
        self.part_cls = nn.Linear(1024, num_classes)
        self.drop_height_ratio = drop_height_ratio
        self.drop_width_ratio = drop_width_ratio
        self.dtype = dtype
        # the heads (the trunk initialised itself)
        for child in self.children():
            if child is not self.backbone:
                init_flax_(child, gen)

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None,
                position: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        fmap = self.backbone(x)["c5"]
        g = fmap.float().mean(dim=(2, 3))
        g_emb = _bn1d(self.global_bn, dense(g, self.global_reduce,
                                            self.dtype))
        g_logits = dense(g_emb, self.global_cls, self.dtype).float()

        p = F.relu(self.part_conv_bn(conv(fmap, self.part_conv, self.dtype)))
        if self.training:
            p = batch_drop_block(p.permute(0, 2, 3, 1), rng,
                                 self.drop_height_ratio,
                                 self.drop_width_ratio,
                                 position).permute(0, 3, 1, 2)
        p_feat = p.float().amax(dim=(2, 3))
        p_emb = _bn1d(self.part_bn, dense(p_feat, self.part_reduce,
                                          self.dtype))
        p_logits = dense(p_emb, self.part_cls, self.dtype).float()
        return {"embedding": torch.cat([g_emb.float(), p_emb.float()], -1),
                "global_embedding": g_emb.float(),
                "part_embedding": p_emb.float(),
                "global_logits": g_logits, "part_logits": p_logits}


class ArcFaceModel(nn.Module):
    """Backbone + BNNeck embedding + ArcFace class centres."""

    def __init__(self, num_classes: int, feat_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = ResNet(stage_sizes=(2, 2, 2, 2), block="basic",
                               return_features=True, dtype=dtype,
                               generator=gen)
        self.neck = nn.Linear(self.backbone.out_channels, feat_dim,
                              bias=False)
        self.neck_bn = norm_layer(dtype)(feat_dim)
        self.arcface_centers = nn.Parameter(torch.zeros(feat_dim,
                                                        num_classes))
        self.dtype = dtype
        # the heads (the trunk initialised itself)
        for child in self.children():
            if child is not self.backbone:
                init_flax_(child, gen)
        with torch.no_grad():
            nn.init.normal_(self.arcface_centers, std=0.01, generator=gen)

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        del rng
        h = self.backbone(x)["c5"].float().mean(dim=(2, 3))
        emb = _bn1d(self.neck_bn, dense(h, self.neck, self.dtype)).float()
        return {"embedding": emb, "centers": self.arcface_centers}


@MODELS.register("bdb_resnet50")
def bdb_resnet50(num_classes: int = 751, **kw):
    return BDBNetwork(num_classes=num_classes, **kw)


@MODELS.register("arcface_resnet18")
def arcface_resnet18(num_classes: int = 100, **kw):
    return ArcFaceModel(num_classes=num_classes, **kw)
