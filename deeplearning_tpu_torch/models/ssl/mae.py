"""Masked autoencoder (MAE) pretraining on ViT — the port of
``deeplearning_tpu/models/ssl/mae.py``.

The encoder sees only the kept tokens (a quarter at the default mask
ratio 0.75); the decoder sees them with learned mask tokens unshuffled
back into place, and the loss is the MSE on the masked patches against
per-patch normalised pixels (``norm_pix_loss``: the population
variance, as ``jnp.var``). Every encoder and decoder block is the ViT's
``Block`` (``models/classification/vit.py``) with its ``attn_fn`` slot,
so ``attn_fn=ops.attention.flash_hb_adapter`` (or ``flash``) runs every
attention, forward and backward, through K1 (``csrc/flash_attn_*.cu``).

Same parameter names as the flax module (``patch_embed``, ``enc_pos``,
``enc_block{i}``, ``enc_norm``, ``dec_embed``, ``mask_token``,
``dec_pos``, ``dec_block{i}``, ``dec_norm``, ``dec_pred``), so a flax
tree converts one to one; the patch embedding, a strided conv in flax,
is a block reshape plus one matmul here, its HWIO kernel flattened in
the (patch rows, patch columns, channels) order the converter gives a
2-D target. flax infers the token count at init; the port takes
``img_size`` (default 224; an int or (H, W)).

The mask is a per-image permutation, the argsort of uniform noise drawn
from ``rng`` (a ``torch.Generator``, the step's); ``mask_noise`` (B, N)
replaces the draw (tests, visualisation). Inputs are NHWC images;
``dtype`` is the compute type over float32 parameters and the loss and
predictions come back in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from ...core.registry import MODELS
from ..classification.vit import Block, LayerNorm, _dense, _lecun_normal_

__all__ = ["random_masking", "patchify", "unpatchify", "MAE"]


def random_masking(x: torch.Tensor, mask_ratio: float,
                   rng: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image token shuffle-mask. x (B, N, C) → (kept (B, K, C), mask
    (B, N) 1 = masked in x's dtype, restore indices (B, N)); ``noise``
    overrides the uniform draw from ``rng``."""
    b, n, c = x.shape
    keep = int(n * (1 - mask_ratio))
    if noise is None:
        if rng is None:
            raise ValueError("random_masking needs rng= (a torch.Generator)"
                             " or noise=")
        noise = torch.rand((b, n), generator=rng, device=x.device)
    shuffle = torch.argsort(noise, dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    kept = torch.gather(x, 1, shuffle[:, :keep, None].expand(b, keep, c))
    mask = torch.cat([torch.zeros((b, keep), dtype=x.dtype, device=x.device),
                      torch.ones((b, n - keep), dtype=x.dtype,
                                 device=x.device)], dim=1)
    return kept, torch.gather(mask, 1, restore), restore


def patchify(imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) → (B, N, patch²·C) pixel targets."""
    b, h, w, c = imgs.shape
    x = imgs.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


def unpatchify(x: torch.Tensor, patch: int, h: int, w: int,
               c: int = 3) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // patch, w // patch, patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class MAE(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 decoder_dim: int = 512, decoder_depth: int = 8,
                 decoder_heads: int = 16, mask_ratio: float = 0.75,
                 norm_pix_loss: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[Callable] = None,
                 img_size: Union[int, Tuple[int, int]] = 224,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = patch_size
        h, w = (img_size, img_size) if isinstance(img_size, int) \
            else img_size
        n = (h // p) * (w // p)
        self.patch_size, self.mask_ratio = p, mask_ratio
        self.norm_pix_loss, self.dtype = norm_pix_loss, dtype
        self.patch_embed = nn.Linear(p * p * in_chans, embed_dim)
        self.enc_pos = nn.Parameter(torch.zeros(1, n, embed_dim))
        for i in range(depth):
            setattr(self, f"enc_block{i}",
                    Block(embed_dim, num_heads, dtype=dtype, attn_fn=attn_fn))
        self.enc_norm = LayerNorm(embed_dim, dtype)
        self.dec_embed = nn.Linear(embed_dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        self.dec_pos = nn.Parameter(torch.zeros(1, n, decoder_dim))
        for i in range(decoder_depth):
            setattr(self, f"dec_block{i}",
                    Block(decoder_dim, decoder_heads, dtype=dtype,
                          attn_fn=attn_fn))
        self.dec_norm = LayerNorm(decoder_dim, dtype)
        self.dec_pred = nn.Linear(decoder_dim, p * p * in_chans)
        self.depth, self.decoder_depth = depth, decoder_depth
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal Dense kernels (the patch
        embedding's fan-in is p·p·c, as the conv's), zero biases,
        truncated-normal 0.02 position tables, normal 0.02 mask token."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        for pos in (self.enc_pos, self.dec_pos):
            nn.init.trunc_normal_(pos, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        nn.init.normal_(self.mask_token, std=0.02, generator=generator)

    def forward(self, imgs: torch.Tensor,
                rng: Optional[torch.Generator] = None,
                mask_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, C) images → (loss, predicted patches (B, N, p²·C),
        mask (B, N))."""
        b, h, w, c = imgs.shape
        p = self.patch_size
        x = _dense(self.patch_embed, patchify(imgs.to(self.dtype), p),
                   self.dtype)
        x = x + self.enc_pos.to(x.dtype)
        kept, mask, restore = random_masking(x, self.mask_ratio, rng,
                                             noise=mask_noise)
        for i in range(self.depth):
            kept = getattr(self, f"enc_block{i}")(kept, rng)
        kept = self.enc_norm(kept)

        y = _dense(self.dec_embed, kept, self.dtype)
        n, k, dd = mask.shape[1], y.shape[1], y.shape[2]
        fill = self.mask_token.to(y.dtype).expand(b, n - k, dd)
        full = torch.cat([y, fill], dim=1)
        full = torch.gather(full, 1, restore[:, :, None].expand(b, n, dd))
        full = full + self.dec_pos.to(full.dtype)
        for i in range(self.decoder_depth):
            full = getattr(self, f"dec_block{i}")(full, rng)
        full = self.dec_norm(full)
        pred = _dense(self.dec_pred, full, self.dtype).float()

        target = patchify(imgs, p).float()
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        per_patch = torch.mean(torch.square(pred - target), dim=-1)
        maskf = mask.float()
        loss = torch.sum(per_patch * maskf) / torch.clamp(torch.sum(maskf),
                                                          min=1)
        return loss, pred, mask

    @torch.no_grad()
    def reconstruct(self, imgs: torch.Tensor,
                    rng: Optional[torch.Generator] = None,
                    mask_noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The masked patches' reconstruction over the visible original
        (MAE.py predict), in eval mode."""
        was = self.training
        self.eval()
        try:
            _, pred, mask = self(imgs, rng=rng, mask_noise=mask_noise)
        finally:
            self.train(was)
        b, h, w, c = imgs.shape
        p = self.patch_size
        recon = unpatchify(pred, p, h, w, c)
        m = mask.reshape(b, h // p, w // p)
        m = m.repeat_interleave(p, 1).repeat_interleave(p, 2)[..., None]
        return imgs * (1 - m) + recon * m


@MODELS.register("mae_vit_base_patch16")
def mae_vit_base_patch16(**kw):
    return MAE(**kw)


@MODELS.register("mae_vit_small_patch16")
def mae_vit_small_patch16(**kw):
    defaults = dict(embed_dim=384, depth=6, num_heads=6, decoder_dim=256,
                    decoder_depth=4, decoder_heads=8)
    return MAE(**{**defaults, **kw})
