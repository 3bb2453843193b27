"""PASCAL VOC detection AP (07 11-point and all-points metrics) — a copy of
``deeplearning_tpu/evaluation/voc.py`` on the port's ``box_iou_np``.

Surface of detection/YOLOX/yolox/evaluators/voc_eval.py (the classic
voc_eval port) used by the VOC-trained detectors (RetinaNet/fasterRcnn
train on VOC in the reference). Array-based: no XML parsing — converters
in data/label_convert.py produce the arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .coco_eval import box_iou_np


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(gt_per_image: Dict[int, Dict], detections: np.ndarray,
                   iou_thresh: float = 0.5,
                   use_07_metric: bool = False) -> Dict[str, float]:
    """One class. gt_per_image: {img_id: {'boxes': (G,4),
    'difficult': (G,) bool}}. detections: (D, 6) rows
    [img_id, score, x1, y1, x2, y2]."""
    npos = sum(int((~g["difficult"]).sum()) for g in gt_per_image.values())
    matched = {i: np.zeros(len(g["boxes"]), bool)
               for i, g in gt_per_image.items()}
    if len(detections) == 0:
        return {"ap": 0.0, "precision": np.zeros(0), "recall": np.zeros(0)}
    order = np.argsort(-detections[:, 1], kind="mergesort")
    detections = detections[order]
    tp = np.zeros(len(detections))
    fp = np.zeros(len(detections))
    for di, row in enumerate(detections):
        img_id = int(row[0])
        box = row[2:6]
        gt = gt_per_image.get(img_id)
        if gt is None or len(gt["boxes"]) == 0:
            fp[di] = 1
            continue
        iou = box_iou_np(box[None], gt["boxes"])[0]
        best = int(np.argmax(iou))
        if iou[best] >= iou_thresh:
            if gt["difficult"][best]:
                continue                      # neither tp nor fp
            if not matched[img_id][best]:
                matched[img_id][best] = True
                tp[di] = 1
            else:
                fp[di] = 1
        else:
            fp[di] = 1
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return {"ap": voc_ap(recall, precision, use_07_metric),
            "precision": precision, "recall": recall}


def voc_map(gt: Dict[int, Dict[int, Dict]], dets: Dict[int, np.ndarray],
            num_classes: int, iou_thresh: float = 0.5,
            use_07_metric: bool = False) -> Dict[str, float]:
    """gt: {class: {img: {'boxes','difficult'}}}; dets: {class: (D,6)}."""
    aps = []
    per_class = {}
    for c in range(num_classes):
        res = voc_eval_class(gt.get(c, {}),
                             dets.get(c, np.zeros((0, 6))),
                             iou_thresh, use_07_metric)
        per_class[c] = res["ap"]
        aps.append(res["ap"])
    return {"mAP": float(np.mean(aps)) if aps else 0.0, "per_class": per_class}
