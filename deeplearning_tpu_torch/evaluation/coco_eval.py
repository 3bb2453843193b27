"""COCO-style detection mAP with no pycocotools — the port of
``deeplearning_tpu/evaluation/coco_eval.py``.

COCOeval's semantics over plain arrays: greedy score-ordered matching per
(image, category) at 10 IoU thresholds, crowd gts matched by IoA and
reusable, ignored gts taken only when no real one qualifies, the area
ranges, maxDets 1/10/100 as prefixes of one matching at 100, 101-point
interpolated precision and the 12-metric summary. The matching loops run
in ``native/cocoeval.cpp`` (``coco_match``, a copy of the JAX package's,
built by ``native/build.load`` at first use and bound with ctypes) when
it builds, else in numpy with the same results; the accumulation is numpy
either way.

``add_batch`` takes the predict function's batched, padded outputs as
they come (tensors on the card or the CPU, or numpy arrays) and copies
each array of the batch to the host once; nothing is sliced image by
image on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .metrics import interp_precision_at_recall

__all__ = ["IOU_THRS", "RECALL_THRS", "AREA_RANGES", "MAX_DETS",
           "box_iou_np", "CocoEvaluator"]

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _host(x, dtype) -> np.ndarray:
    """One array on the host: a tensor is copied there once."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def box_iou_np(det: np.ndarray, gt: np.ndarray,
               iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """(D, 4) × (G, 4) xyxy → (D, G); crowd gt uses IoA (COCO semantics)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.prod(np.clip(det[:, 2:] - det[:, :2], 0, None), axis=1)
    area_g = np.prod(np.clip(gt[:, 2:] - gt[:, :2], 0, None), axis=1)
    union = area_d[:, None] + area_g[None, :] - inter
    if iscrowd is not None and iscrowd.any():
        union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


@dataclasses.dataclass
class _ImgEval:
    dt_scores: np.ndarray          # (D,)
    dt_matched: np.ndarray         # (T, D) matched gt id or -1
    dt_ignore: np.ndarray          # (T, D)
    gt_ignore: np.ndarray          # (G,)


class CocoEvaluator:
    """Streaming evaluator: add per-image ground truth + detections, then
    ``summarize()``."""

    def __init__(self, num_classes: int, use_cpp: bool = True):
        self.num_classes = num_classes
        self._gts: Dict[int, Dict] = {}
        self._dts: Dict[int, Dict] = {}
        self.use_cpp = use_cpp

    def add_image(self, image_id: int, *, gt_boxes: np.ndarray,
                  gt_labels: np.ndarray, det_boxes: np.ndarray,
                  det_scores: np.ndarray, det_labels: np.ndarray,
                  gt_crowd: Optional[np.ndarray] = None) -> None:
        """Boxes xyxy in image coords; arrays may be empty."""
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_boxes), bool)
        self._gts[image_id] = {
            "boxes": gt_boxes,
            "labels": np.asarray(gt_labels, np.int64).reshape(-1),
            "crowd": np.asarray(gt_crowd, bool).reshape(-1),
        }
        self._dts[image_id] = {
            "boxes": np.asarray(det_boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(det_scores, np.float64).reshape(-1),
            "labels": np.asarray(det_labels, np.int64).reshape(-1),
        }

    def add_batch(self, image_ids, det: Dict, gt: Dict,
                  image_valid=None) -> None:
        """Consume one eval step's *batched* padded outputs — the shape
        the batched postprocess emits — with exactly one host copy per
        array (each ``_host`` below is the single device-to-host copy for
        the whole batch; no per-image device slicing).

        det: {'boxes' (B,D,4), 'scores' (B,D), 'labels' (B,D),
        'valid' (B,D)}; gt: {'boxes' (B,G,4), 'labels' (B,G),
        'valid' (B,G), optional 'crowd' (B,G)}; ``image_valid`` (B,)
        masks wrap-around padding images. Padded detection slots are
        dropped by the valid mask AND by label < 0 (the
        ``gather_nms_outputs`` fill), so a padded slot can never alias a
        real class-0 / score-0 detection."""
        det_boxes = _host(det["boxes"], np.float64)
        det_scores = _host(det["scores"], np.float64)
        det_labels = _host(det["labels"], np.int64)
        det_valid = _host(det["valid"], bool) & (det_labels >= 0)
        gt_boxes = _host(gt["boxes"], np.float64)
        gt_labels = _host(gt["labels"], np.int64)
        gt_valid = _host(gt["valid"], bool)
        gt_crowd = _host(gt["crowd"], bool) if "crowd" in gt else None
        image_ids = _host(image_ids, np.int64)
        if image_valid is not None:
            image_valid = _host(image_valid, bool)
        for j, img_id in enumerate(image_ids):
            if image_valid is not None and not image_valid[j]:
                continue
            dv = det_valid[j]
            gv = gt_valid[j]
            self.add_image(
                int(img_id),
                gt_boxes=gt_boxes[j][gv],
                gt_labels=gt_labels[j][gv],
                det_boxes=det_boxes[j][dv],
                det_scores=det_scores[j][dv],
                det_labels=det_labels[j][dv],
                gt_crowd=gt_crowd[j][gv] if gt_crowd is not None else None)

    # ------------------------------------------------------------- match
    def _evaluate_img(self, img_id: int, cat: int,
                      area_rng: Tuple[float, float], max_det: int
                      ) -> Optional[_ImgEval]:
        gt = self._gts[img_id]
        dt = self._dts[img_id]
        g_sel = gt["labels"] == cat
        d_sel = dt["labels"] == cat
        g_boxes = gt["boxes"][g_sel]
        g_crowd = gt["crowd"][g_sel]
        d_order = np.argsort(-dt["scores"][d_sel], kind="mergesort")[:max_det]
        d_boxes = dt["boxes"][d_sel][d_order]
        d_scores = dt["scores"][d_sel][d_order]
        if len(g_boxes) == 0 and len(d_boxes) == 0:
            return None

        g_area = np.prod(np.clip(g_boxes[:, 2:] - g_boxes[:, :2], 0, None),
                         axis=1) if len(g_boxes) else np.zeros(0)
        g_ignore = g_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
        # sort gt: non-ignored first (COCO matching preference)
        g_order = np.argsort(g_ignore, kind="mergesort")
        g_boxes = g_boxes[g_order]
        g_ignore_sorted = g_ignore[g_order]
        g_crowd_sorted = g_crowd[g_order]

        iou = box_iou_np(d_boxes, g_boxes, g_crowd_sorted)
        t_count = len(IOU_THRS)
        d_count = len(d_boxes)
        g_count = len(g_boxes)
        dt_matched = -np.ones((t_count, d_count), np.int64)
        gt_matched = -np.ones((t_count, g_count), np.int64)
        dt_ignore = np.zeros((t_count, d_count), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d_count):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g_count):
                    if gt_matched[ti, gi] >= 0 and not g_crowd_sorted[gi]:
                        continue
                    # prefer non-ignored gt; once we have a real match,
                    # don't switch to an ignored one
                    if best_g >= 0 and not g_ignore_sorted[best_g] \
                            and g_ignore_sorted[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best_iou = iou[di, gi]
                    best_g = gi
                if best_g >= 0:
                    dt_matched[ti, di] = best_g
                    gt_matched[ti, best_g] = di
                    dt_ignore[ti, di] = g_ignore_sorted[best_g]
        # unmatched dets outside area range are ignored
        d_area = np.prod(np.clip(d_boxes[:, 2:] - d_boxes[:, :2], 0, None),
                         axis=1)
        out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ignore |= (dt_matched == -1) & out_of_range[None, :]
        return _ImgEval(d_scores, dt_matched, dt_ignore, g_ignore_sorted)

    # ------------------------------------------------- C++ fast matching
    def _evaluate_cpp(self, cat: int, area_rng: Tuple[float, float],
                      max_det: int) -> List[_ImgEval]:
        """Packed all-image matching via native/cocoeval.cpp coco_match —
        identical results to _evaluate_img, C++ inner loops. None when the
        library does not build."""
        import ctypes

        from ..native.build import load
        lib = load("cocoeval")
        if lib is None:
            return None
        d_boxes_l, d_scores_l, g_boxes_l = [], [], []
        g_crowd_l, g_ignore_l = [], []
        d_off, g_off = [0], [0]
        per_img_meta = []
        for img_id in self._gts:
            gt, dt = self._gts[img_id], self._dts[img_id]
            g_sel = gt["labels"] == cat
            d_sel = dt["labels"] == cat
            g_boxes = gt["boxes"][g_sel]
            g_crowd = gt["crowd"][g_sel]
            order = np.argsort(-dt["scores"][d_sel],
                               kind="mergesort")[:max_det]
            d_boxes = dt["boxes"][d_sel][order]
            d_scores = dt["scores"][d_sel][order]
            if len(g_boxes) == 0 and len(d_boxes) == 0:
                per_img_meta.append(None)
                continue
            g_area = np.prod(np.clip(g_boxes[:, 2:] - g_boxes[:, :2], 0,
                                     None), axis=1) if len(g_boxes) else \
                np.zeros(0)
            g_ignore = g_crowd | (g_area < area_rng[0]) | \
                (g_area > area_rng[1])
            g_order = np.argsort(g_ignore, kind="mergesort")
            d_boxes_l.append(d_boxes)
            d_scores_l.append(d_scores)
            g_boxes_l.append(g_boxes[g_order])
            g_crowd_l.append(g_crowd[g_order])
            g_ignore_l.append(g_ignore[g_order])
            d_off.append(d_off[-1] + len(d_boxes))
            g_off.append(g_off[-1] + len(g_boxes))
            per_img_meta.append((len(d_boxes), len(g_boxes)))

        n_img = len(d_off) - 1
        total_d = d_off[-1]
        t_n = len(IOU_THRS)
        cat_ = np.concatenate
        db = cat_(d_boxes_l).astype(np.float64) if d_boxes_l else \
            np.zeros((0, 4))
        gb = cat_(g_boxes_l).astype(np.float64) if g_boxes_l else \
            np.zeros((0, 4))
        gc = cat_(g_crowd_l).astype(np.uint8) if g_crowd_l else \
            np.zeros(0, np.uint8)
        gi = cat_(g_ignore_l).astype(np.uint8) if g_ignore_l else \
            np.zeros(0, np.uint8)
        dt_matched = np.empty((t_n, total_d), np.int64)
        dt_ignore = np.empty((t_n, total_d), np.uint8)
        if n_img:
            c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
            d_off_a = np.asarray(d_off, np.int64)
            g_off_a = np.asarray(g_off, np.int64)
            thrs = np.ascontiguousarray(IOU_THRS, np.float64)
            lib.coco_match(
                ctypes.c_int(n_img), c(d_off_a, ctypes.c_int64),
                c(g_off_a, ctypes.c_int64), c(np.ascontiguousarray(db),
                                              ctypes.c_double),
                c(np.ascontiguousarray(gb), ctypes.c_double),
                c(gc, ctypes.c_uint8), c(gi, ctypes.c_uint8),
                c(thrs, ctypes.c_double), ctypes.c_int(t_n),
                ctypes.c_double(area_rng[0]), ctypes.c_double(area_rng[1]),
                ctypes.c_int64(total_d), c(dt_matched, ctypes.c_int64),
                c(dt_ignore, ctypes.c_uint8))
        evals = []
        k = 0
        for meta in per_img_meta:
            if meta is None:
                continue
            dn, gn = meta
            d0, d1 = d_off[k], d_off[k + 1]
            g0, g1 = g_off[k], g_off[k + 1]
            evals.append(_ImgEval(
                d_scores_l[k], dt_matched[:, d0:d1],
                dt_ignore[:, d0:d1].astype(bool), g_ignore_l[k]))
            k += 1
        return evals

    # -------------------------------------------------------- accumulate
    def accumulate(self) -> Dict[str, np.ndarray]:
        cats = range(self.num_classes)
        t_n = len(IOU_THRS)
        precision = -np.ones((t_n, len(RECALL_THRS), self.num_classes,
                              len(AREA_RANGES), len(MAX_DETS)))
        recall = -np.ones((t_n, self.num_classes, len(AREA_RANGES),
                           len(MAX_DETS)))
        for ki, cat in enumerate(cats):
            for ai, (aname, arng) in enumerate(AREA_RANGES.items()):
                # match ONCE at the largest maxDet; smaller maxDets are
                # score-ordered prefixes of the same greedy matching
                # (pycocotools does the same slicing)
                full = (self._evaluate_cpp(cat, arng, max(MAX_DETS))
                        if self.use_cpp else None)
                if full is None:
                    full = [self._evaluate_img(i, cat, arng, max(MAX_DETS))
                            for i in self._gts]
                    full = [e for e in full if e is not None]
                for mi, max_det in enumerate(MAX_DETS):
                    evals = [
                        _ImgEval(e.dt_scores[:max_det],
                                 e.dt_matched[:, :max_det],
                                 e.dt_ignore[:, :max_det], e.gt_ignore)
                        for e in full]
                    if not evals:
                        continue
                    scores = np.concatenate([e.dt_scores for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e.dt_matched for e in evals], axis=1)[:, order]
                    ignored = np.concatenate(
                        [e.dt_ignore for e in evals], axis=1)[:, order]
                    num_gt = sum(int((~e.gt_ignore).sum()) for e in evals)
                    if num_gt == 0:
                        continue
                    tp = (matched >= 0) & ~ignored
                    fp = (matched < 0) & ~ignored
                    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
                    for ti in range(t_n):
                        rc = tp_cum[ti] / num_gt
                        pr = tp_cum[ti] / np.maximum(
                            tp_cum[ti] + fp_cum[ti], 1e-9)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        precision[ti, :, ki, ai, mi] = \
                            interp_precision_at_recall(pr, rc, RECALL_THRS)
        return {"precision": precision, "recall": recall}

    # --------------------------------------------------------- summarize
    def summarize(self, acc: Optional[Dict] = None) -> Dict[str, float]:
        acc = acc or self.accumulate()
        p, r = acc["precision"], acc["recall"]

        def ap(iou_thr=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou_thr is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou_thr))]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        return {
            "AP": ap(), "AP50": ap(0.5), "AP75": ap(0.75),
            "AP_small": ap(area="small"), "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR1": ar(max_det=1), "AR10": ar(max_det=10),
            "AR100": ar(max_det=100),
            "AR_small": ar(area="small"), "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }
