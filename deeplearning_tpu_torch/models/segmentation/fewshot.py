"""Few-shot segmentation, SSP (self-support prototypes) — the port of
``deeplearning_tpu/models/segmentation/fewshot.py``.

Support and query images go through one ResNet-18 encoder (``encoder``,
its stride-16 c4); the support masks, resized to the feature grid with
``jax.image.resize``'s "nearest" (half-pixel centres,
``ops/resize.resize``), pool the support features into foreground and
background prototypes; confidently matched query pixels refine them.
The public functions take JAX's layouts: features (B, H, W, C), masks
(B, H, W); the logits (B, H, W, 2) come back in the compute dtype, as
JAX's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...core.registry import MODELS
from ...ops.losses import safe_normalize
from ...ops.resize import resize
from ..classification.resnet import ResNet

__all__ = ["masked_average_pool", "cosine_similarity_map", "SSPNet"]


def masked_average_pool(feats: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) features + (B, H, W) {0, 1} mask → (B, C) prototype."""
    m = mask[..., None].to(feats.dtype)
    return torch.sum(feats * m, dim=(1, 2)) / torch.clamp(
        torch.sum(m, dim=(1, 2)), min=1e-6)


def cosine_similarity_map(feats: torch.Tensor,
                          proto: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) × (B, C) → (B, H, W) cosine similarity (NaN-safe at
    zero features)."""
    f = safe_normalize(feats, axis=-1)
    p = safe_normalize(proto, axis=-1)
    return torch.einsum("bhwc,bc->bhw", f, p)


class SSPNet(nn.Module):
    """1-way k-shot episode segmenter."""

    def __init__(self, backbone_sizes: Tuple[int, ...] = (2, 2, 2, 2),
                 refine_thresh_fg: float = 0.7,
                 refine_thresh_bg: float = 0.6,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = ResNet(stage_sizes=backbone_sizes, block="basic",
                              return_features=True, dtype=dtype,
                              generator=generator)
        self.refine_thresh_fg = refine_thresh_fg
        self.refine_thresh_bg = refine_thresh_bg

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → stride-16 features (B, H/16, W/16, C)."""
        return self.encoder(x)["c4"].permute(0, 2, 3, 1)

    def forward(self, support_img: torch.Tensor, support_mask: torch.Tensor,
                query_img: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """support_img (B, S, H, W, 3); support_mask (B, S, H, W); query
        (B, H, W, 3) → logits (B, H, W, 2)."""
        del rng
        b, s = support_img.shape[:2]
        sup = self.encode(support_img.reshape((-1,) + support_img.shape[2:]))
        _, fh, fw, c = sup.shape
        m = resize(support_mask.float(), (b, s, fh, fw), "nearest")
        sup = sup.reshape(b * s, fh, fw, c)
        m = m.reshape(b * s, fh, fw)
        fg_proto = masked_average_pool(sup, m).reshape(b, s, c).mean(1)
        bg_proto = masked_average_pool(sup, 1 - m).reshape(b, s, c).mean(1)

        q = self.encode(query_img)
        fg_sim = cosine_similarity_map(q, fg_proto)
        bg_sim = cosine_similarity_map(q, bg_proto)
        # self-support refinement: confident query pixels join the protos
        conf_fg = (fg_sim > self.refine_thresh_fg).float()
        conf_bg = (bg_sim > self.refine_thresh_bg).float()
        ssp_fg = masked_average_pool(q, conf_fg)
        ssp_bg = masked_average_pool(q, conf_bg)
        has_fg = (conf_fg.sum(dim=(1, 2)) > 0)[:, None]
        has_bg = (conf_bg.sum(dim=(1, 2)) > 0)[:, None]
        fg_proto = torch.where(has_fg, 0.5 * fg_proto + 0.5 * ssp_fg,
                               fg_proto)
        bg_proto = torch.where(has_bg, 0.5 * bg_proto + 0.5 * ssp_bg,
                               bg_proto)
        fg_sim = cosine_similarity_map(q, fg_proto)
        bg_sim = cosine_similarity_map(q, bg_proto)
        logits = torch.stack([bg_sim, fg_sim], dim=-1) * 10.0
        bq, hq, wq, _ = query_img.shape
        return resize(logits, (bq, hq, wq, 2), "bilinear")


@MODELS.register("sspnet_resnet18")
def sspnet_resnet18(**kw):
    return SSPNet(**kw)
