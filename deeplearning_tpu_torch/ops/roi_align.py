"""RoIAlign as a bilinear gather: the port of
``deeplearning_tpu/ops/roi_align.py``.

The JAX package computes RoIAlign as an XLA gather, outside any Pallas
kernel, and so does the port: plain PyTorch indexing, the same
arithmetic in the same order. Each output cell averages a fixed
``sampling_ratio²`` grid of bilinear samples; a sample outside
[−1, H] × [−1, W] reads 0 (torchvision's rule), others are clamped into
the map. FPN level assignment is the canonical heuristic
(level = floor(4 + log2(sqrt(area) / 224)), clamped to the pyramid).

Feature maps are (H, W, C) channels-last, as in JAX: a level of an NCHW
pyramid is ``level[i].permute(1, 2, 0)``, a free view when the pyramid is
channels-last in memory (as the detectors' convolutions leave it).

``multiscale_roi_align`` is one pass: the levels are packed into one
(ΣH·W, C) buffer with per-level row offsets, each RoI's sample grid is
laid out in its assigned level's frame, and one gather samples every RoI
once. ``multiscale_roi_align_masked`` (every RoI on every level, the
assigned one selected by mask) is the equivalence oracle.

Values promote as in JAX: bf16 features times float32 bilinear weights
give float32, and the mean is float32. The four corner reads are summed
one at a time, so at most two (R, S, sr, S, sr, C) float32 tensors are
alive at once (JAX's fused gather materialises none; an unfused torch
expression would hold all four).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["roi_align", "multiscale_roi_align",
           "multiscale_roi_align_masked", "assign_levels"]


def _cap(x: torch.Tensor, top) -> torch.Tensor:
    """min(x, top) for a number or a tensor ``top``."""
    if isinstance(top, torch.Tensor):
        return torch.minimum(x, top)
    return torch.clamp(x, max=top)


def _bilinear_sum(read, y: torch.Tensor, x: torch.Tensor, hf, wf, hi, wi
                  ) -> torch.Tensor:
    """Σ corner · weight over the four corners at float coords y, x
    (..., ) → (..., C), zero out of bounds. ``read(yi, xi)`` gathers the
    corner values; hf/wf (float) and hi/wi (int) are the map's size,
    scalars or broadcastable to y."""
    in_bounds = (y >= -1.0) & (y <= hf) & (x >= -1.0) & (x <= wf)
    y = _cap(torch.clamp(y, min=0.0), hf - 1.0)
    x = _cap(torch.clamp(x, min=0.0), wf - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = _cap(y0 + 1, hi - 1)
    x1 = _cap(x0 + 1, wi - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]
    val = read(y0, x0) * (1 - ly) * (1 - lx)
    val = val + read(y0, x1) * (1 - ly) * lx
    val = val + read(y1, x0) * ly * (1 - lx)
    val = val + read(y1, x1) * ly * lx
    return val * in_bounds[..., None]


def _sample_grid(boxes: torch.Tensor, s: int, sr: int, min_size: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, S, sr, S, sr) y and x sample coordinates of boxes (R, 4) in
    their own frame."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    roi_w = torch.clamp(x2 - x1, min=min_size)
    roi_h = torch.clamp(y2 - y1, min=min_size)
    bin_h = roi_h / s
    bin_w = roi_w / s
    iy = torch.arange(s, device=boxes.device)
    ir = torch.arange(sr, device=boxes.device)
    frac = iy[None, :, None] + (ir[None, None, :] + 0.5) / sr
    ys = y1[:, None, None] + frac * bin_h[:, None, None]
    xs = x1[:, None, None] + frac * bin_w[:, None, None]
    r = boxes.shape[0]
    yy = ys[:, :, :, None, None].expand(r, s, sr, s, sr)
    xx = xs[:, None, None, :, :].expand(r, s, sr, s, sr)
    return yy, xx


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = False) -> torch.Tensor:
    """features (H, W, C); rois (R, 4) in image coords → (R, S, S, C)."""
    s, sr = output_size, max(sampling_ratio, 1)
    offset = 0.5 if aligned else 0.0
    boxes = rois * spatial_scale - offset
    yy, xx = _sample_grid(boxes, s, sr, 1e-6 if aligned else 1.0)
    h, w, _ = features.shape
    vals = _bilinear_sum(lambda yi, xi: features[yi, xi], yy, xx,
                         float(h), float(w), h, w)
    return vals.mean(dim=(2, 4))


def assign_levels(levels, rois: torch.Tensor, canonical_level: int = 4,
                  canonical_scale: float = 224.0) -> torch.Tensor:
    """The canonical FPN level of each RoI, as an index into the sorted
    level names ``levels`` ("p2" < "p3" < ...)."""
    lmin, lmax = int(levels[0][1:]), int(levels[-1][1:])
    areas = torch.clamp(rois[:, 2] - rois[:, 0], min=0) * \
        torch.clamp(rois[:, 3] - rois[:, 1], min=0)
    target = torch.floor(canonical_level
                         + torch.log2(torch.sqrt(areas) / canonical_scale
                                      + 1e-8))
    return torch.clamp(target, lmin, lmax).to(torch.int64) - lmin


def _sorted_levels(feature_pyramid: Dict[str, torch.Tensor]):
    return sorted(feature_pyramid, key=lambda k: int(k[1:]))


def multiscale_roi_align(
    feature_pyramid: Dict[str, torch.Tensor],
    rois: torch.Tensor,
    output_size: int = 7,
    canonical_level: int = 4,
    canonical_scale: float = 224.0,
    sampling_ratio: int = 2,
    strides: Optional[Dict[str, int]] = None,
    impl: str = "onepass",
) -> torch.Tensor:
    """FPN-aware RoIAlign. feature_pyramid maps 'p2'..'p5' → (H_l, W_l,
    C); rois (R, 4) → (R, S, S, C). ``impl="masked"`` selects the
    evaluate-every-level reference."""
    if impl == "masked":
        return multiscale_roi_align_masked(
            feature_pyramid, rois, output_size, canonical_level,
            canonical_scale, sampling_ratio, strides)
    if impl != "onepass":
        raise ValueError(f"multiscale_roi_align impl must be 'onepass' or "
                         f"'masked', got {impl!r}")
    levels = _sorted_levels(feature_pyramid)
    if strides is None:
        strides = {k: 2 ** int(k[1:]) for k in levels}
    lvl_idx = assign_levels(levels, rois, canonical_level, canonical_scale)
    hs, ws, offs, flats = [], [], [], []
    row = 0
    for name in levels:
        f = feature_pyramid[name]
        h, w, c = f.shape
        hs.append(h)
        ws.append(w)
        offs.append(row)
        row += h * w
        flats.append(f.reshape(h * w, c))
    packed = torch.cat(flats, dim=0)
    dev = rois.device
    scale = torch.tensor([1.0 / strides[n] for n in levels],
                         dtype=rois.dtype, device=dev)[lvl_idx]
    h_l = torch.tensor(hs, dtype=torch.int64, device=dev)[lvl_idx]
    w_l = torch.tensor(ws, dtype=torch.int64, device=dev)[lvl_idx]
    base = torch.tensor(offs, dtype=torch.int64, device=dev)[lvl_idx]
    yy, xx = _sample_grid(rois * scale[:, None], output_size,
                          max(sampling_ratio, 1), 1.0)
    expand = (slice(None),) + (None,) * (yy.dim() - 1)
    hi, wi, base = h_l[expand], w_l[expand], base[expand]
    vals = _bilinear_sum(lambda yi, xi: packed[base + yi * wi + xi], yy, xx,
                         hi.to(yy.dtype), wi.to(yy.dtype), hi, wi)
    return vals.mean(dim=(2, 4))


def multiscale_roi_align_masked(
    feature_pyramid: Dict[str, torch.Tensor],
    rois: torch.Tensor,
    output_size: int = 7,
    canonical_level: int = 4,
    canonical_scale: float = 224.0,
    sampling_ratio: int = 2,
    strides: Optional[Dict[str, int]] = None,
) -> torch.Tensor:
    """Every RoI aligned on every level, the assigned level selected by
    mask: L× the work, the equivalence oracle of the one-pass path."""
    levels = _sorted_levels(feature_pyramid)
    if strides is None:
        strides = {k: 2 ** int(k[1:]) for k in levels}
    lvl_idx = assign_levels(levels, rois, canonical_level, canonical_scale)
    out = None
    for li, name in enumerate(levels):
        aligned = roi_align(feature_pyramid[name], rois, output_size,
                            1.0 / strides[name], sampling_ratio)
        sel = (lvl_idx == li).to(aligned.dtype)[:, None, None, None]
        out = aligned * sel if out is None else out + aligned * sel
    return out
