"""Mixup / CutMix batch augmentation and detection mosaic — the port of
``deeplearning_tpu/data/mixup.py``.

``one_hot_smooth`` and ``mixup_cutmix`` on tensors, drawn from a
``torch.Generator`` on the batch's device: every draw, the box and the
blend stay on the device, so an augmented step never waits for the host.
The JAX version draws from ``jax.random``, so the two give other numbers
for one seed; what holds in both is the recipe: each sample pairs with
the reversed batch, mixup or cutmix is chosen per batch, targets sum to
1, the first label's weight is λ for mixup and the share of the image
left unpasted for cutmix, and one generator seed gives one batch.

``mosaic4``, ``random_perspective``, ``box_candidates`` and
``mosaic_array_source`` are detection's host-side numpy on a
``np.random.Generator``: copies of JAX's, so one seed gives the same
canvases and boxes in both packages. ``random_perspective`` warps with
cv2 where it imports, else with ``_warp_np`` (inverse-mapped bilinear),
as JAX chooses.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .loader import MapSource
from .transforms import resize_bilinear, thread_rng

__all__ = ["one_hot_smooth", "mixup_cutmix", "mosaic4",
           "random_perspective", "box_candidates", "mosaic_array_source"]


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


def mosaic4(images: Sequence[np.ndarray], boxes: Sequence[np.ndarray],
            labels: Sequence[np.ndarray], out_size: int,
            rng: np.random.Generator,
            max_boxes: int = 64,
            perspective: Optional[Dict] = None,
            fill: float = 114.0) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """4-image mosaic (MosaicDetection surface): random center, each
    quadrant filled by one scaled image; boxes shifted+clipped, padded to
    ``max_boxes`` with a validity mask. Host-side numpy.

    ``perspective``: kwargs for :func:`random_perspective` — when given,
    the 2s canvas goes through the geometric augmentation with
    border=(-s//2, -s//2) exactly like yolov5's mosaic
    (utils/datasets.py:836), instead of the plain 2s→s downscale."""
    assert len(images) == 4
    s = out_size
    yc = int(rng.uniform(0.5 * s, 1.5 * s))
    xc = int(rng.uniform(0.5 * s, 1.5 * s))
    canvas = np.full((2 * s, 2 * s, images[0].shape[-1]), fill, np.float32)
    all_boxes, all_labels = [], []
    for i, (img, bxs, lbs) in enumerate(zip(images, boxes, labels)):
        h0, w0 = img.shape[:2]
        scale = min(s / h0, s / w0) * rng.uniform(0.5, 1.5)
        nh, nw = max(int(h0 * scale), 1), max(int(w0 * scale), 1)
        img = resize_bilinear(img, (nh, nw))
        if i == 0:      # top-left quadrant, anchored at (yc, xc)
            y1a, x1a = max(yc - nh, 0), max(xc - nw, 0)
            y2a, x2a = yc, xc
        elif i == 1:    # top-right
            y1a, x1a = max(yc - nh, 0), xc
            y2a, x2a = yc, min(xc + nw, 2 * s)
        elif i == 2:    # bottom-left
            y1a, x1a = yc, max(xc - nw, 0)
            y2a, x2a = min(yc + nh, 2 * s), xc
        else:           # bottom-right
            y1a, x1a = yc, xc
            y2a, x2a = min(yc + nh, 2 * s), min(xc + nw, 2 * s)
        # matching source crop
        y1b = nh - (y2a - y1a) if i < 2 else 0
        x1b = nw - (x2a - x1a) if i in (0, 2) else 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                       x1b:x1b + (x2a - x1a)]
        if len(bxs):
            shifted = np.asarray(bxs, np.float32) * scale
            shifted[:, [0, 2]] += x1a - x1b
            shifted[:, [1, 3]] += y1a - y1b
            all_boxes.append(shifted)
            all_labels.append(np.asarray(lbs))
    if all_boxes:
        out_boxes = np.concatenate(all_boxes)
        out_labels = np.concatenate(all_labels)
        out_boxes[:, [0, 2]] = out_boxes[:, [0, 2]].clip(0, 2 * s)
        out_boxes[:, [1, 3]] = out_boxes[:, [1, 3]].clip(0, 2 * s)
        wh = out_boxes[:, 2:] - out_boxes[:, :2]
        keep = (wh > 2).all(axis=1)
        out_boxes, out_labels = out_boxes[keep], out_labels[keep]
    else:
        out_boxes = np.zeros((0, 4), np.float32)
        out_labels = np.zeros((0,), np.int64)
    if perspective is not None:
        if s % 2:
            raise ValueError(
                f"mosaic with random_perspective needs an even out_size "
                f"(got {s}): the 2s canvas shrinks by s//2 borders")
        canvas, out_boxes, out_labels = random_perspective(
            canvas, out_boxes, out_labels, rng,
            border=(-s // 2, -s // 2), fill=fill, **perspective)
    else:
        # downscale canvas 2s -> s
        canvas = resize_bilinear(canvas, (s, s))
        out_boxes = out_boxes / 2.0
    # pad to fixed count
    n = len(out_boxes)
    boxes_pad = np.zeros((max_boxes, 4), np.float32)
    labels_pad = np.zeros((max_boxes,), np.int64)
    valid = np.zeros((max_boxes,), bool)
    take = min(n, max_boxes)
    boxes_pad[:take] = out_boxes[:take]
    labels_pad[:take] = out_labels[:take]
    valid[:take] = True
    return canvas, boxes_pad, labels_pad, valid


def random_perspective(img: np.ndarray, boxes: np.ndarray,
                       labels: np.ndarray, rng: np.random.Generator,
                       degrees: float = 0.0, translate: float = 0.1,
                       scale: float = 0.5, shear: float = 0.0,
                       perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0),
                       fill: float = 114.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """yolov5's geometric detection augmentation
    (utils/augmentations.py:144 random_perspective): center → perspective
    → rotation+scale → shear → translate, one combined 3x3 matrix applied
    to the image (cv2.warpAffine) and to all 4 box corners, then
    box_candidates filtering (:343 — min size 2px, aspect < 20, area
    ratio > 0.1). Defaults are the hyp.scratch.yaml values
    (degrees 0, translate .1, scale .5, shear 0, perspective 0).

    boxes: (N, 4) xyxy pixels; returns the warped (img, boxes, labels).
    """
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = math.radians(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1 + scale)
    # cv2.getRotationMatrix2D(center=(0,0), angle, scale) equivalent
    R[0, :2] = [s * math.cos(a), s * math.sin(a)]
    R[1, :2] = [-s * math.sin(a), s * math.cos(a)]
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C            # right-to-left order matters

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            fv = (fill,) * img.shape[-1]
            if perspective:
                img = cv2.warpPerspective(img, M, dsize=(width, height),
                                          borderValue=fv)
            else:
                img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                                     borderValue=fv)
            if img.ndim == 2:        # cv2 drops a size-1 channel axis
                img = img[..., None]
        else:
            img = _warp_np(img, M, (height, width), fill,
                           bool(perspective))

    n = len(boxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective
              else xy[:, :2]).reshape(n, 8)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(boxes.T * s, new.T)
        boxes, labels = new[keep].astype(np.float32), labels[keep]
    return img, boxes, labels


def _warp_np(img: np.ndarray, M: np.ndarray, out_hw: Tuple[int, int],
             fill: float, perspective: bool) -> np.ndarray:
    """Pure-numpy inverse-mapped bilinear warp — the cv2-free fallback so
    the augmentation never becomes a hard opencv dependency."""
    h, w = out_hw
    Minv = np.linalg.inv(M)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    ones = np.ones_like(xs)
    src = np.stack([xs, ys, ones], -1) @ Minv.T
    sx, sy = src[..., 0], src[..., 1]
    if perspective:
        sx, sy = sx / src[..., 2], sy / src[..., 2]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]

    def tap(xi, yi):
        inside = ((xi >= 0) & (xi < img.shape[1])
                  & (yi >= 0) & (yi < img.shape[0]))
        vals = img[np.clip(yi, 0, img.shape[0] - 1),
                   np.clip(xi, 0, img.shape[1] - 1)].astype(np.float32)
        return np.where(inside[..., None], vals, fill)

    out = (tap(x0, y0) * (1 - fx) * (1 - fy)
           + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy
           + tap(x0 + 1, y0 + 1) * fx * fy)
    return out.astype(np.float32)


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 20, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """Keep boxes that survived the warp (augmentations.py:343): still
    >2px each side, aspect ratio < 20, area > 10% of the pre-warp box."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def mosaic_array_source(images: np.ndarray, boxes: np.ndarray,
                        labels: np.ndarray, valid: np.ndarray,
                        out_size: int, max_boxes: int, seed: int,
                        perspective: Optional[Dict] = None,
                        fill: float = 0.0):
    """MapSource over in-memory arrays where each sample is a fresh
    4-image mosaic (+ optional random_perspective) — wires the mosaic
    path into the npz/synthetic detection flows. ``fill`` defaults to 0
    because array datasets here are float images (not 0-255 JPEG)."""
    local = threading.local()
    n = len(images)

    def fetch(i: int) -> Dict[str, np.ndarray]:
        rng = thread_rng(local, seed)
        idxs = [i] + [int(rng.integers(0, n)) for _ in range(3)]
        imgs = [np.asarray(images[j], np.float32) for j in idxs]
        bxs = [np.asarray(boxes[j][valid[j]], np.float32) for j in idxs]
        lbs = [np.asarray(labels[j][valid[j]]) for j in idxs]
        # 4 images' boxes merge into one sample: carry 4x the per-image
        # capacity so mosaic never silently truncates ground truth
        canvas, b, l, v = mosaic4(imgs, bxs, lbs, out_size, rng,
                                  max_boxes=4 * max_boxes,
                                  perspective=perspective, fill=fill)
        return {"image": canvas, "boxes": b, "labels": l, "valid": v}

    return MapSource(n, fetch)
