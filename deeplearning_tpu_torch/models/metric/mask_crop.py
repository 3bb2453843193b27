"""Happy-Whale staged FCN-mask-crop pipeline — the port of
``deeplearning_tpu/models/metric/mask_crop.py``.

Stage 1 segments, stage 2 trains retrieval on the crops:

    predict = make_mask_predictor(fcn)                       # stage 1
    write_masks(predict, paths, masks_dir)
    source = mask_crop_source(paths, labels, masks_dir)     # bridge
    ...ArcFace / triplet training on the crops...            # stage 2

Stage-1 inference is one batched forward of the port's segmentation
module under ``torch.no_grad()`` in eval mode, on the module's own device
(the JAX module's ``jax.jit``); the crop itself is host-side numpy, as in
the reference (it feeds the input pipeline, not the card). ``mask_to_bbox``
and ``crop_by_mask`` are copies of JAX's.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ...data.transforms import resize_bilinear

__all__ = ["mask_to_bbox", "crop_by_mask", "make_mask_predictor",
           "mask_crop_source", "write_masks"]


def mask_to_bbox(mask: np.ndarray, threshold: float = 0.5,
                 pad_frac: float = 0.05, min_size: int = 8
                 ) -> Tuple[int, int, int, int]:
    """Tight (x0, y0, x1, y1) around ``mask > threshold``, padded by
    pad_frac of each side; full image when the mask is empty/tiny."""
    h, w = mask.shape[:2]
    ys, xs = np.nonzero(mask > threshold)
    if len(xs) == 0:
        return 0, 0, w, h
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    if (x1 - x0) < min_size or (y1 - y0) < min_size:
        return 0, 0, w, h
    px = int((x1 - x0) * pad_frac)
    py = int((y1 - y0) * pad_frac)
    return (max(x0 - px, 0), max(y0 - py, 0),
            min(x1 + px, w), min(y1 + py, h))


def crop_by_mask(image: np.ndarray, mask: np.ndarray,
                 out_hw: Optional[Tuple[int, int]] = None,
                 threshold: float = 0.5, pad_frac: float = 0.05
                 ) -> np.ndarray:
    """Crop ``image`` to the mask bbox (optionally resized to out_hw) —
    the data_loader.py:110-130 crop-before-augment step. The mask may be
    at a different resolution than the image (stage 1 predicts at a
    fixed size); the bbox is rescaled into image space."""
    x0, y0, x1, y1 = mask_to_bbox(mask, threshold, pad_frac)
    ih, iw = image.shape[:2]
    mh, mw = mask.shape[:2]
    if (mh, mw) != (ih, iw):
        sx, sy = iw / mw, ih / mh
        x0, x1 = int(x0 * sx), min(int(round(x1 * sx)), iw)
        y0, y1 = int(y0 * sy), min(int(round(y1 * sy)), ih)
    crop = image[y0:y1, x0:x1]
    if out_hw is not None:
        crop = resize_bilinear(crop, out_hw)
    return crop


def make_mask_predictor(seg_model: torch.nn.Module, *,
                        threshold: float = 0.5):
    """Stage-1 inference: images (B, H, W, C) numpy → float masks
    (B, H, W) numpy in [0, 1], through ``seg_model`` in eval mode under
    ``torch.no_grad()`` on the device its parameters lie on. Handles
    1-logit (sigmoid) and K-logit (argmax != background) segmentation
    heads, and dict outputs with an 'out' key (the torchvision
    fcn_resnet50 output shape)."""
    device = next(seg_model.parameters()).device

    @torch.no_grad()
    def predict_masks(images: np.ndarray) -> np.ndarray:
        seg_model.eval()
        out = seg_model(torch.as_tensor(np.asarray(images, np.float32),
                                        device=device))
        if isinstance(out, dict):
            out = out.get("out", next(iter(out.values())))
        if out.shape[-1] == 1:
            masks = torch.sigmoid(out[..., 0].float())
        else:
            masks = (torch.argmax(out, dim=-1) != 0).float()
        return masks.cpu().numpy()

    predict_masks.threshold = threshold
    return predict_masks


def mask_crop_source(paths, labels, masks_dir: str,
                     out_hw: Tuple[int, int] = (224, 224),
                     transform=None):
    """folder_source variant that crops each image by its stored stage-1
    mask (masks_dir/<stem>.png) before the usual transform — the
    retrieval loader's image+mask path."""
    from ...data.datasets import load_image
    from ...data.loader import MapSource

    labels = np.asarray(labels)

    def fetch(i: int):
        img = load_image(paths[i])
        stem = os.path.splitext(os.path.basename(paths[i]))[0]
        mask_path = os.path.join(masks_dir, stem + ".png")
        if os.path.exists(mask_path):
            from PIL import Image
            mask = np.asarray(Image.open(mask_path).convert("L"),
                              np.float32) / 255.0
            img = crop_by_mask(img, mask, out_hw)
        else:
            img = resize_bilinear(img, out_hw)
        if transform is not None:
            img = transform(img)
        return {"image": np.asarray(img, np.float32),
                "label": np.asarray(labels[i], np.int32)}

    return MapSource(len(paths), fetch)


def write_masks(predict_masks, paths, out_dir: str, *,
                image_size: Tuple[int, int] = (256, 256),
                batch: int = 16) -> int:
    """Stage-1 driver (predict.py:run surface): batch images through the
    predictor, write <stem>.png binary masks. Returns #written."""
    from PIL import Image

    from ...data.datasets import load_image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for start in range(0, len(paths), batch):
        chunk = paths[start:start + batch]
        imgs = np.stack([resize_bilinear(load_image(p), image_size)
                         for p in chunk])
        masks = predict_masks(imgs)
        for p, m in zip(chunk, masks):
            stem = os.path.splitext(os.path.basename(p))[0]
            arr = ((m > predict_masks.threshold) * 255).astype(np.uint8)
            Image.fromarray(arr, "L").save(
                os.path.join(out_dir, stem + ".png"))
            n += 1
    return n
