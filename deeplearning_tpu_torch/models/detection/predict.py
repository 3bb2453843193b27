"""Family-dispatch inference builder for the registry detectors: the port
of ``deeplearning_tpu/models/detection/predict.py``.

``build_predict_fn(model, name, num_classes, ...)`` returns
``predict_fn(images) -> {boxes, scores, labels, valid}``: the model's
forward and its family's fixed-shape postprocess, ``max_det`` slots an
image, padded slots carrying class −1 (never a real class). The image size
is read off the batch, so each bucket builds its own anchor grid (cached
per size and device, so a served batch uploads no grid). Every NMS call
goes through ``ops/nms.py``: on the card, ``nms_impl="auto"`` launches the
K3 kernels once a batch.

The YOLOX family is ported. RetinaNet, FCOS, Faster R-CNN and YOLOv5
raise ``NotImplementedError``: they need a backbone, anchors or RoIAlign
that come with the next detection slice, and so does every other name
(the JAX builder raises ``ValueError`` for a name of no family).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

__all__ = ["build_predict_fn", "is_detection_model", "require_ported",
           "DETECTION_PREFIXES"]

DETECTION_PREFIXES = ("retinanet", "yolox", "yolov5", "fcos", "fasterrcnn")
_NEXT_SLICE = ("retinanet", "yolov5", "fcos", "fasterrcnn")


def is_detection_model(name: str) -> bool:
    """True when ``name`` belongs to a detection family (the serving
    engine's task auto-detect)."""
    return name.startswith(DETECTION_PREFIXES)


def require_ported(name: str) -> None:
    """Raise ``NotImplementedError`` unless the port can postprocess
    detector ``name`` (checked before a model is built)."""
    if name.startswith("yolox"):
        return
    if name.startswith(_NEXT_SLICE):
        raise NotImplementedError(
            f"{name!r}: the port serves the YOLOX family; RetinaNet, FCOS, "
            "Faster R-CNN and YOLOv5 (their backbones, anchors and "
            "RoIAlign) come with the next detection slice")
    raise NotImplementedError(
        f"no detection predict path in the port for model {name!r} "
        "(ported: yolox*)")


def build_predict_fn(model: torch.nn.Module, name: str, num_classes: int,
                     *, score_thresh: float = 0.05, max_det: int = 100,
                     post_nms_top_n: int = 256,
                     nms_impl: str = "auto") -> Callable:
    """``predict_fn(images (B, H, W, 3)) -> det dict`` for a registry
    detector in eval mode. ``post_nms_top_n`` sizes Faster R-CNN's proposal
    stage and is accepted for every family; ``nms_impl`` selects the
    suppression path (``ops/nms.nms``)."""
    require_ported(name)                 # the YOLOX family, so far
    from .yolox import yolox_grid, yolox_postprocess
    grids: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def predict_fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        hw = tuple(images.shape[1:3])
        key = (hw, images.device)
        if key not in grids:
            grids[key] = tuple(torch.from_numpy(a).to(images.device)
                               for a in yolox_grid(hw))
        centers, strides = grids[key]
        with torch.no_grad():
            return yolox_postprocess(model(images), centers, strides,
                                     max_det=max_det,
                                     score_thresh=score_thresh,
                                     nms_impl=nms_impl)
    return predict_fn
