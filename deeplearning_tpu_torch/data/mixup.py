"""Mixup / CutMix batch augmentation — the first half of the port of
``deeplearning_tpu/data/mixup.py``.

``one_hot_smooth`` and ``mixup_cutmix`` on tensors, drawn from a
``torch.Generator`` on the batch's device: every draw, the box and the
blend stay on the device, so an augmented step never waits for the host.
The JAX version draws from ``jax.random``, so the two give other numbers
for one seed; what holds in both is the recipe: each sample pairs with
the reversed batch, mixup or cutmix is chosen per batch, targets sum to
1, the first label's weight is λ for mixup and the share of the image
left unpasted for cutmix, and one generator seed gives one batch.

``mosaic4``, ``random_perspective`` and ``mosaic_array_source`` are
detection training: they come with ROADMAP Queue 1 item 5b.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["one_hot_smooth", "mixup_cutmix"]


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return torch.nn.functional.one_hot(labels.long(), num_classes).float() \
        * (on - off) + off


def _beta(alpha: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Beta(alpha, alpha) as Ga / (Ga + Gb) of two standard gammas."""
    g = torch._standard_gamma(alpha.expand(2).contiguous(), generator=gen)
    return g[0] / (g[0] + g[1])


def mixup_cutmix(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                 num_classes: int, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, smoothing: float = 0.1,
                 switch_prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """Pair each sample with the reversed batch; cutmix with probability
    ``switch_prob``, else mixup. Returns the batch with soft-target
    'label' (float32, rows summing to 1). ``gen`` lies on the batch's
    device."""
    imgs = batch["image"]
    labels = batch["label"]
    dev = imgs.device
    b, h, w, c = imgs.shape
    use_cutmix = torch.rand((), generator=gen, device=dev) < switch_prob
    # arithmetic on the flag, not torch.tensor(alpha, device=...): a host
    # scalar copied to the card is a synchronising copy
    alpha = mixup_alpha + (cutmix_alpha - mixup_alpha) * use_cutmix.float()
    lam = _beta(alpha, gen)

    flipped = imgs.flip(0)
    # cutmix box with area ratio (1 - lam), clipped to the image
    cut = torch.sqrt(1.0 - lam)
    ch, cw = (h * cut).int(), (w * cut).int()
    cy = torch.randint(0, h, (), generator=gen, device=dev)
    cx = torch.randint(0, w, (), generator=gen, device=dev)
    y0 = torch.clamp(cy - ch // 2, 0, h)
    x0 = torch.clamp(cx - cw // 2, 0, w)
    y1 = torch.clamp(cy + ch // 2, 0, h)
    x1 = torch.clamp(cx + cw // 2, 0, w)
    rows = torch.arange(h, device=dev)[None, :, None, None]
    cols = torch.arange(w, device=dev)[None, None, :, None]
    in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    lam_cutmix = 1.0 - ((y1 - y0) * (x1 - x0)).float() / (h * w)

    mixed_mixup = lam * imgs + (1 - lam) * flipped
    mixed_cutmix = torch.where(in_box, flipped, imgs)
    out_imgs = torch.where(use_cutmix, mixed_cutmix, mixed_mixup)
    lam_eff = torch.where(use_cutmix, lam_cutmix, lam)

    t1 = one_hot_smooth(labels, num_classes, smoothing)
    t2 = one_hot_smooth(labels.flip(0), num_classes, smoothing)
    soft = lam_eff * t1 + (1 - lam_eff) * t2
    return {**batch, "image": out_imgs.to(imgs.dtype), "label": soft}
