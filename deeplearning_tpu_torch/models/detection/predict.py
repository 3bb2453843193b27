"""Family-dispatch inference builder for the registry detectors: the port
of ``deeplearning_tpu/models/detection/predict.py``.

``build_predict_fn(model, name, num_classes, ...)`` returns
``predict_fn(images) -> {boxes, scores, labels, valid}``: the model's
forward and its family's fixed-shape postprocess, ``max_det`` slots an
image, padded slots carrying class −1 (never a real class). The image size
is read off the batch, so each bucket builds its own anchors, grid or
locations, cached per (size, device): a served batch uploads none. Every
NMS call goes through ``ops/nms.py``: on the card, ``nms_impl="auto"``
launches K3 once a batch (twice for Faster R-CNN: the proposals, then the
detections).

Families: RetinaNet, YOLOX, YOLOv5 (and ``yolov5_from_spec``), FCOS and
Faster R-CNN. Faster R-CNN runs its RoI stage on the first call's pyramid
(no backbone recompute) and returns 0-based foreground labels (its model
classes are 1-based, 0 the background); its padded slots keep class −1
(the JAX branch subtracts 1 from them too, giving −2). A name of no family
raises ``ValueError``, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["build_predict_fn", "is_detection_model", "head_classes",
           "DETECTION_PREFIXES"]

DETECTION_PREFIXES = ("retinanet", "yolox", "yolov5", "fcos", "fasterrcnn")


def is_detection_model(name: str) -> bool:
    """True when ``name`` belongs to a detection family (the serving
    engine's task auto-detect)."""
    return name.startswith(DETECTION_PREFIXES)


def head_classes(name: str, num_classes: int) -> int:
    """The classes a model's head is built with to answer ``num_classes``
    foreground classes: Faster R-CNN's head carries class 0, the
    background, besides them."""
    return num_classes + (1 if name.startswith("fasterrcnn") else 0)


def _cached(make: Callable):
    """``get(hw, device)``: ``make(hw)``'s numpy arrays (a tuple, a dict or
    one array) as tensors on ``device``, built once per (size, device).
    Tensors built under a tracing mode (``torch.export``, a fake-mode
    walk) are fake or traced: they are returned but never cached, so a
    later eager call builds real ones."""
    cache: Dict[Tuple, object] = {}

    def up(a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def get(hw, device):
        key = (hw, device)
        if key in cache:
            return cache[key]
        made = make(hw)
        if isinstance(made, dict):
            out = {k: up(v, device) for k, v in made.items()}
            leaves = list(out.values())
        elif isinstance(made, tuple):
            out = leaves = tuple(up(v, device) for v in made)
        else:
            out = up(made, device)
            leaves = [out]
        if all(type(t) is torch.Tensor for t in leaves):
            cache[key] = out
        return out
    return get


def build_predict_fn(model: torch.nn.Module, name: str, num_classes: int,
                     *, score_thresh: float = 0.05, max_det: int = 100,
                     post_nms_top_n: int = 256,
                     nms_impl: str = "auto") -> Callable:
    """``predict_fn(images (B, H, W, 3)) -> det dict`` for a registry
    detector in eval mode. ``post_nms_top_n`` sizes Faster R-CNN's proposal
    stage; ``nms_impl`` selects the suppression path (``ops/nms.nms``) for
    every family."""
    kw = dict(max_det=max_det, score_thresh=score_thresh, nms_impl=nms_impl)

    if name.startswith("retinanet"):
        from .retinanet import retinanet_anchors, retinanet_postprocess
        anchors = _cached(retinanet_anchors)

        def predict_fn(images):
            hw = tuple(images.shape[1:3])
            with torch.no_grad():
                return retinanet_postprocess(
                    model(images), anchors(hw, images.device), hw, **kw)
        return predict_fn

    if name.startswith("yolox"):
        from .yolox import yolox_grid, yolox_postprocess
        grids = _cached(yolox_grid)

        def predict_fn(images):
            centers, strides = grids(tuple(images.shape[1:3]), images.device)
            with torch.no_grad():
                return yolox_postprocess(model(images), centers, strides,
                                         **kw)
        return predict_fn

    if name.startswith("yolov5"):
        from .yolov5 import yolov5_grid, yolov5_postprocess
        grids = _cached(yolov5_grid)

        def predict_fn(images):
            grid = grids(tuple(images.shape[1:3]), images.device)
            with torch.no_grad():
                return yolov5_postprocess(model(images), grid, **kw)
        return predict_fn

    if name.startswith("fcos"):
        from .fcos import fcos_locations, fcos_postprocess
        locations = _cached(lambda hw: fcos_locations(hw)[0])

        def predict_fn(images):
            hw = tuple(images.shape[1:3])
            with torch.no_grad():
                return fcos_postprocess(
                    model(images), locations(hw, images.device), hw, **kw)
        return predict_fn

    if name.startswith("fasterrcnn"):
        from .faster_rcnn import (fasterrcnn_anchors, fasterrcnn_postprocess,
                                  generate_proposals)
        anchors = _cached(fasterrcnn_anchors)

        def predict_fn(images):
            hw = tuple(images.shape[1:3])
            with torch.no_grad():
                out = model(images)
                props, pvalid = generate_proposals(
                    out, anchors(hw, images.device), hw,
                    post_nms_top_n=post_nms_top_n, nms_impl=nms_impl)
                out2 = model(images, proposals=props,
                             pyramid=out["pyramid"])
                det = fasterrcnn_postprocess(
                    out2["roi_scores"], out2["roi_deltas"], props, hw,
                    prop_valid=pvalid, **kw)
            det["labels"] = torch.where(det["valid"], det["labels"] - 1,
                                        det["labels"])
            return det
        return predict_fn

    raise ValueError(f"no detection predict path for model {name!r} "
                     "(expected retinanet*/fasterrcnn*/yolox*/yolov5*/"
                     "fcos*)")
