"""TransFG — the port of ``deeplearning_tpu/models/classification/transfg.py``:
a ViT trunk whose last block takes only the CLS token and the patch
tokens of highest accumulated attention to it (part selection by CLS
attention rollout), and the contrastive loss on the CLS embedding.

Same layers, flax names and factory (``transfg_small``), so a flax tree
converts one to one (``utils/convert.from_flax_params``). The input is
NHWC and ``dtype`` the compute type over float32 parameters. Each block's
attention keeps its float32 map (``AttnWithMap``), the plain attention JAX
runs (no kernel route); the rollout is the product over the first
``depth - 1`` blocks of the head-mean CLS -> patch attention, and the top
``num_parts`` patches (``torch.topk``, as ``lax.top_k``: descending) go
into the last block. The model returns ``{"logits", "embedding"}`` in
float32; the classification loss of either package trains no dict
output, so the train CLI does not train it.

flax infers the position table's length at init; the port builds it up
front, so the factory takes ``img_size`` (default 224) and ``in_chans``
(default 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...core.registry import MODELS
from ...ops.losses import safe_normalize
from .vit import LayerNorm, Mlp, PatchEmbed, _dense, _lecun_normal_

__all__ = ["AttnWithMap", "TransFGBlock", "TransFG", "contrastive_loss"]


class AttnWithMap(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, c = x.shape
        d = c // self.num_heads
        q, k, v = _dense(self.qkv, x, self.dtype).view(
            b, n, 3, self.num_heads, d).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, k)
        attn = torch.softmax(s.float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v)
        return _dense(self.proj, out.reshape(b, n, c), self.dtype), attn


class TransFGBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = AttnWithMap(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, 4.0, 0.0, dtype)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y, attn = self.attn(self.norm1(x))
        x = x + y
        return x + self.mlp(self.norm2(x)), attn


class TransFG(nn.Module):
    def __init__(self, num_classes: int = 200, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 8, num_heads: int = 6,
                 num_parts: int = 12, dtype: torch.dtype = torch.bfloat16,
                 img_size: int = 224, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.num_parts, self.dtype = depth, num_parts, dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype)
        n = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        for i in range(depth):
            setattr(self, f"block{i}", TransFGBlock(embed_dim, num_heads,
                                                    dtype))
        self.norm = LayerNorm(embed_dim, dtype)
        self.head = nn.Linear(embed_dim, num_classes)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal Dense kernels, zero biases and
        CLS token, trunc-normal 0.02 position table."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        del rng
        x = self.patch_embed(x.to(self.dtype))
        b, n, c = x.shape
        cls = self.cls_token.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        rollout = None                # accumulated CLS -> patch attention
        for i in range(self.depth - 1):
            x, attn = getattr(self, f"block{i}")(x)
            cls_attn = attn[:, :, 0, 1:].mean(dim=1)            # (B, N)
            rollout = cls_attn if rollout is None else rollout * cls_attn
        top = torch.topk(rollout, min(self.num_parts, n), dim=-1).indices
        parts = torch.gather(x[:, 1:], 1, top[:, :, None].expand(-1, -1, c))
        x, _ = getattr(self, f"block{self.depth - 1}")(
            torch.cat([x[:, :1], parts], dim=1))
        x = self.norm(x)
        return {"logits": _dense(self.head, x[:, 0], self.dtype).float(),
                "embedding": x[:, 0].float()}


def contrastive_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                     margin: float = 0.4) -> torch.Tensor:
    """TransFG's contrastive loss: same-class CLS embeddings pulled
    together, different-class pairs pushed past a cosine margin."""
    z = safe_normalize(embeddings, axis=-1)        # NaN-safe at zero rows
    sim = z @ z.t()
    same = (labels[:, None] == labels[None, :]).float()
    eye = torch.eye(len(labels), device=z.device)
    pos_loss = torch.sum((1 - sim) * same * (1 - eye))
    neg_loss = torch.sum(torch.clamp(sim - margin, min=0.0) * (1 - same))
    denom = len(labels) * (len(labels) - 1)
    return (pos_loss + neg_loss) / max(denom, 1)


@MODELS.register("transfg_small")
def transfg_small(num_classes: int = 200, **kw):
    return TransFG(num_classes=num_classes, **kw)
