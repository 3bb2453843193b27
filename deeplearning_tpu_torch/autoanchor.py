"""Autoanchor CLI of the port: check or recompute YOLOv5 anchors for a
COCO-json dataset — the counterpart of ``tools/autoanchor.py``.

  python -m deeplearning_tpu_torch.autoanchor --coco instances.json \\
      --img-size 640
  python -m deeplearning_tpu_torch.autoanchor --coco instances.json \\
      --n 9 --force

The yolov5 autoanchor surface (utils/autoanchor.py: the check_anchors BPR
gate and the kmean_anchors recompute, ``models/detection/yolov5.py``) as
a standalone tool: loads the gt boxes (``data/coco.load_coco_json``),
scales their widths and heights to the training image size, prints the
current anchors' best possible recall, and proposes k-means anchors when
the BPR is below 0.98 (or always with ``--force``). Host-side numpy: it
touches no device.
"""

from __future__ import annotations

import argparse

import numpy as np


def gt_wh_from_coco(path: str, img_size: int) -> np.ndarray:
    """(G, 2) gt widths / heights scaled as training resizes them
    (longest side -> img_size, aspect kept)."""
    from .data.coco import load_coco_json
    records, _ = load_coco_json(path)
    whs = []
    for rec in records:
        scale = img_size / max(rec["height"], rec["width"])
        for box in rec["boxes"]:
            x0, y0, x1, y1 = box
            whs.append(((x1 - x0) * scale, (y1 - y0) * scale))
    return np.asarray(whs, np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.autoanchor",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coco", required=True, help="instances.json")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--n", type=int, default=9, help="anchor count")
    ap.add_argument("--thr", type=float, default=4.0,
                    help="wh ratio threshold (hyp anchor_t)")
    ap.add_argument("--force", action="store_true",
                    help="recompute even when BPR >= 0.98")
    args = ap.parse_args(argv)

    from .models.detection.yolov5 import (DEFAULT_ANCHORS, check_anchors,
                                          kmean_anchors)

    wh = gt_wh_from_coco(args.coco, args.img_size)
    if len(wh) == 0:
        raise SystemExit("no gt boxes in the dataset")
    current = np.asarray(DEFAULT_ANCHORS, np.float64).reshape(-1, 2)
    fit = check_anchors(wh, current, thr=args.thr)
    print(f"current anchors: BPR={fit['bpr']:.4f} "
          f"anchors/target={fit['aat']:.2f} over {len(wh)} gts")
    if fit["bpr"] >= 0.98 and not args.force:
        print("BPR >= 0.98 — current anchors are fine "
              "(yolov5 check_anchors gate)")
        return 0
    proposed = kmean_anchors(wh, n=args.n)
    pfit = check_anchors(wh, proposed, thr=args.thr)
    print(f"k-means anchors: BPR={pfit['bpr']:.4f} "
          f"anchors/target={pfit['aat']:.2f}")
    for row in proposed.round(1):
        print(f"  [{row[0]:.1f}, {row[1]:.1f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
