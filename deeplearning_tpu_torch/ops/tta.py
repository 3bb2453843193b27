"""Test-time augmentation (TTA) for inference — the port of
``deeplearning_tpu/ops/tta.py``.

Classification averages the class probabilities of the identity and a
horizontal flip (softmax, then mean). YOLOX's multi-scale TTA (yolov5's
``forward_augment``: scales 1, 0.83, 0.67, the second view flipped) runs
the network once a (scale, flip) view, each view resized to a
``size_divisor``-aligned shape with ``train/multiscale.py``'s emulation of
``jax.image.resize`` (the triangle kernel, antialiased on the way down),
decodes each view on its own anchor grid, maps its boxes back to the input
frame, concatenates the views along the candidate axis and suppresses
them in one ``postprocess_decoded`` call: one NMS (K3 on the card) over
every view's candidates.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

__all__ = ["flip_lr_boxes", "descale_boxes", "classify_tta", "yolox_tta",
           "yolox_tta_decoded"]


def flip_lr_boxes(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Mirror xyxy boxes horizontally inside an image of ``width``."""
    x1 = width - boxes[..., 2]
    x2 = width - boxes[..., 0]
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def descale_boxes(boxes: torch.Tensor, scale, flip_lr: bool,
                  width: float) -> torch.Tensor:
    """Map xyxy boxes predicted in a scaled (and flipped) frame back to the
    base frame: un-mirror x in the AUGMENTED frame of ``width``, then
    divide by the scale gain, a float or an (sx, sy) pair."""
    if flip_lr:
        boxes = flip_lr_boxes(boxes, width)
    sx, sy = scale if isinstance(scale, (tuple, list)) else (scale, scale)
    # a true division by the gains rounded to the boxes' dtype, as JAX
    # divides (a python scalar divisor becomes a reciprocal product)
    gains = torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype)
    return boxes / gains.to(boxes.device)


def classify_tta(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 images: torch.Tensor, flip: bool = True,
                 extra_views: Sequence[Callable] = ()) -> torch.Tensor:
    """Class probabilities averaged over views of NHWC ``images``: the
    identity and a horizontal flip (and ``extra_views``)."""
    views = [lambda x: x]
    if flip:
        views.append(lambda x: x.flip(2))
    views.extend(extra_views)
    return sum(torch.softmax(logits_fn(v(images)), dim=-1)
               for v in views) / len(views)


def yolox_tta_decoded(raw_fn: Callable[[torch.Tensor], torch.Tensor],
                      images: torch.Tensor,
                      scales: Sequence[float] = (1.0, 0.83, 0.67),
                      flips: Sequence[bool] = (False, True, False),
                      size_divisor: int = 32) -> torch.Tensor:
    """Every (scale, flip) view's decoded rows in the input frame,
    concatenated along the candidate axis: (B, ΣA, 5+C)."""
    from ..models.detection.yolox import decode_outputs, yolox_grid
    from ..train.multiscale import _resize_images
    _, h, w, _ = images.shape
    merged = []
    for scale, flip in zip(scales, flips):
        sh = max(size_divisor,
                 int(round(h * scale / size_divisor)) * size_divisor)
        sw = max(size_divisor,
                 int(round(w * scale / size_divisor)) * size_divisor)
        view = images
        if (sh, sw) != (h, w):
            view = _resize_images(view, (sh, sw))
        if flip:
            view = view.flip(2)
        raw = raw_fn(view)
        centers, strides = yolox_grid((sh, sw))
        dec = decode_outputs(raw, torch.from_numpy(centers).to(raw.device),
                             torch.from_numpy(strides).to(raw.device))
        boxes = descale_boxes(dec[..., :4], (sw / w, sh / h), flip,
                              float(sw))
        merged.append(torch.cat([boxes, dec[..., 4:]], dim=-1))
    return torch.cat(merged, dim=1)


def yolox_tta(raw_fn: Callable[[torch.Tensor], torch.Tensor],
              images: torch.Tensor,
              scales: Sequence[float] = (1.0, 0.83, 0.67),
              flips: Sequence[bool] = (False, True, False),
              size_divisor: int = 32,
              score_thresh: float = 0.01,
              nms_thresh: float = 0.65,
              max_det: int = 100,
              nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Multi-scale + flip TTA for the YOLOX family. ``raw_fn(images) ->
    (B, A, 5+C)`` is the model's forward; returns the padded detections
    {boxes, scores, labels, valid} of one class-aware NMS over every
    view's candidates."""
    from ..models.detection.yolox import postprocess_decoded
    with torch.no_grad():
        decoded = yolox_tta_decoded(raw_fn, images, scales, flips,
                                    size_divisor)
        return postprocess_decoded(decoded, score_thresh=score_thresh,
                                   nms_thresh=nms_thresh, max_det=max_det,
                                   nms_impl=nms_impl)
