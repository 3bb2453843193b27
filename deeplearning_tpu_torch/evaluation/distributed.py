"""Distributed detection evaluation: per-process shards to global
metrics — the port of ``deeplearning_tpu/evaluation/distributed.py``.

Each rank runs inference on its equal-length slice of the image list;
its detections are fixed-shape padded arrays (boxes / scores / labels
and a valid mask), so the gather is a plain array gather
(``parallel.collectives.host_allgather``: one row a rank) and every rank
fills the port's ``CocoEvaluator`` identically. Padding images carry
``image_valid=False`` (DistributedSampler's wrap-around), and an image
id seen twice counts once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..parallel.collectives import host_allgather
from .coco_eval import CocoEvaluator

__all__ = ["pack_shard", "gather_and_evaluate"]


def pack_shard(image_ids, det: Dict, gt: Dict,
               image_valid: Optional[np.ndarray] = None) -> Dict:
    """One rank's padded per-image arrays for the gather.

    det: {'boxes' (B,D,4), 'scores' (B,D), 'labels' (B,D), 'valid' (B,D)}
    gt:  {'boxes' (B,G,4), 'labels' (B,G), 'valid' (B,G)}
    image_valid: (B,) False for wrap-around padding images.
    """
    b = len(image_ids)
    if image_valid is None:
        image_valid = np.ones((b,), bool)
    return {
        "image_ids": np.asarray(image_ids, np.int64),
        "image_valid": np.asarray(image_valid, bool),
        "det_boxes": np.asarray(det["boxes"], np.float32),
        "det_scores": np.asarray(det["scores"], np.float32),
        "det_labels": np.asarray(det["labels"], np.int64),
        "det_valid": np.asarray(det["valid"], bool),
        "gt_boxes": np.asarray(gt["boxes"], np.float32),
        "gt_labels": np.asarray(gt["labels"], np.int64),
        "gt_valid": np.asarray(gt["valid"], bool),
    }


def gather_and_evaluate(shard: Dict, num_classes: int,
                        allgather: Callable = host_allgather,
                        use_cpp: bool = True) -> Dict[str, float]:
    """Gather every rank's shard and score the union: the 12-metric COCO
    summary, the same on every rank. ``allgather`` is injectable, so one
    process can stand in for a world (tests stack shards)."""
    gathered = {k: np.asarray(v) for k, v in allgather(shard).items()}
    ev = CocoEvaluator(num_classes=num_classes, use_cpp=use_cpp)
    seen = set()
    for p in range(gathered["image_ids"].shape[0]):
        ids = gathered["image_ids"][p]
        # a wrap-around duplicate counts once: folded into the image mask
        valid = gathered["image_valid"][p].copy()
        for i in range(ids.shape[0]):
            if not valid[i]:
                continue
            img_id = int(ids[i])
            if img_id in seen:
                valid[i] = False
            else:
                seen.add(img_id)
        ev.add_batch(
            ids,
            det={"boxes": gathered["det_boxes"][p],
                 "scores": gathered["det_scores"][p],
                 "labels": gathered["det_labels"][p],
                 "valid": gathered["det_valid"][p]},
            gt={"boxes": gathered["gt_boxes"][p],
                "labels": gathered["gt_labels"][p],
                "valid": gathered["gt_valid"][p]},
            image_valid=valid)
    return ev.summarize()
