"""COCO-format detection dataset (images + ``instances.json``) — the port
of ``deeplearning_tpu/data/coco.py``.

Every sample is resized with padding to one fixed size with its boxes
rescaled, and its gts padded to ``max_gt`` with a ``valid`` mask, so every
batch has one shape. Images are decoded on access, inside the loader's
worker threads, by the port's ``load_image`` (the native libjpeg decode
where it builds). ``mosaic=True`` makes every sample a fresh 4-image
mosaic (``data/mixup.mosaic4``, optionally through random perspective),
its three extra tiles drawn from ``mosaic_pool``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .datasets import load_image
from .label_convert import coco_to_records
from .loader import MapSource
from .mixup import mosaic4
from .transforms import random_flip_lr, resize_with_pad, thread_rng

__all__ = ["load_coco_json", "coco_detection_source"]


def load_coco_json(json_path: str) -> Tuple[Sequence[Dict], Sequence[str]]:
    """(records, class_names) from an instances.json: records carry the
    file name, absolute xyxy boxes and class names (the label_convert
    schema); classes are ordered by category id."""
    with open(json_path) as f:
        coco = json.load(f)
    class_names = [c["name"] for c in
                   sorted(coco["categories"], key=lambda c: c["id"])]
    return coco_to_records(coco), class_names


def coco_detection_source(json_path: Optional[str] = None,
                          images_dir: Optional[str] = None,
                          *, image_size: int = 256, max_gt: int = 16,
                          augment: bool = False, seed: int = 0,
                          records: Optional[Sequence[Dict]] = None,
                          class_names: Optional[Sequence[str]] = None,
                          mosaic: bool = False,
                          perspective: Optional[Dict] = None,
                          mosaic_pool: Optional[Sequence[int]] = None,
                          ) -> Tuple[MapSource, Sequence[str]]:
    """MapSource of fixed-shape samples {image (S, S, 3) float32 in [0, 1],
    boxes (max_gt, 4), labels (max_gt,), valid (max_gt,)} decoded lazily
    from ``images_dir`` (default ``<json dir>/images``). ``augment`` adds a
    horizontal flip drawn from a per-thread stream of ``seed``.
    ``mosaic`` makes every sample a 4-image mosaic padded to
    ``4 · max_gt`` boxes, through ``random_perspective`` with the kwargs
    ``perspective`` when given; ``mosaic_pool`` restricts its three extra
    tiles to those record indices (the training split, so no held-out
    image leaks into a mosaic). Pass ``records`` / ``class_names`` from
    ``load_coco_json`` to build several sources without parsing the json
    again."""
    if records is None:
        if json_path is None:
            raise ValueError("need json_path or records")
        records, class_names = load_coco_json(json_path)
    if images_dir is None:
        if json_path is None:
            raise ValueError("need images_dir when passing records")
        images_dir = os.path.join(os.path.dirname(json_path), "images")
    name_to_id = {n: i for i, n in enumerate(class_names)}
    out_hw = (image_size, image_size)
    local = threading.local()

    def _load_raw(i: int):
        rec = records[i]
        img = load_image(os.path.join(images_dir, rec["filename"]))
        labels = np.asarray([name_to_id[x] for x in rec["names"]],
                            np.int64)
        return (np.asarray(img, np.float32),
                np.asarray(rec["boxes"], np.float32).reshape(-1, 4),
                labels)

    def fetch(i: int) -> Dict[str, np.ndarray]:
        rng = thread_rng(local, seed)
        if mosaic:
            pool = (np.asarray(mosaic_pool) if mosaic_pool is not None
                    else np.arange(len(records)))
            idxs = [i] + [int(pool[rng.integers(0, len(pool))])
                          for _ in range(3)]
            raws = [_load_raw(j) for j in idxs]
            img, boxes, labels, pvalid = mosaic4(
                [r[0] for r in raws], [r[1] for r in raws],
                [r[2] for r in raws], image_size, rng,
                max_boxes=4 * max_gt, perspective=perspective,
                fill=114.0)
            if augment:
                img, boxes = random_flip_lr(img, rng, boxes)
            return {"image": img / 255.0, "boxes": boxes,
                    "labels": labels, "valid": pvalid}
        rec = records[i]
        img = load_image(os.path.join(images_dir, rec["filename"]))
        img, _, boxes = resize_with_pad(img, out_hw, rec["boxes"])
        if augment:
            img, boxes = random_flip_lr(img, rng, boxes)
        pboxes = np.zeros((max_gt, 4), np.float32)
        plabels = np.zeros((max_gt,), np.int64)
        pvalid = np.zeros((max_gt,), bool)
        take = min(len(boxes), max_gt)
        if take:
            pboxes[:take] = boxes[:take]
            plabels[:take] = [name_to_id[x] for x in rec["names"][:take]]
            pvalid[:take] = True
        return {"image": np.asarray(img, np.float32) / 255.0,
                "boxes": pboxes, "labels": plabels, "valid": pvalid}

    return MapSource(len(records), fetch), class_names
