"""Detection demo CLI of the port: image in → annotated image out — the
counterpart of ``tools/demo.py`` (the YOLOX ``tools/demo.py`` / yolov5
``detect.py`` successor).

  python -m deeplearning_tpu_torch.demo --model yolox_s --num-classes 80 \\
      --input street.jpg --out street_det.png [--ckpt DIR] [--tta]

Builds any registry detector, restores a checkpoint, runs the family's
fixed-shape postprocess (``train/detection.build_task``'s predict; every
NMS through K3 on the card), optionally multi-scale + flip TTA for the
YOLOX family (``ops/tta.yolox_tta``), draws the surviving boxes with
``utils/visualize.draw_boxes`` and writes the annotated image. The
detections also print as JSON lines, in the original frame.

Differences from ``tools/demo.py``, by decision: ``--device`` (default
``cuda``) where JAX reads ``DLTPU_PLATFORM``; ``--seed`` sets the weights
when no ``--ckpt`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.demo", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help="registry name (yolox_*, yolov5*, retinanet_*, "
                         "fcos_*, fasterrcnn_*)")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (a TrainState or a state dict)")
    ap.add_argument("--input", required=True, help="image file")
    ap.add_argument("--out", default=None,
                    help="annotated image path (default <input>_det.png)")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--score", type=float, default=0.3)
    ap.add_argument("--tta", action="store_true",
                    help="multi-scale + flip TTA (YOLOX family only)")
    ap.add_argument("--classes", default=None,
                    help="json mapping class index -> name")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from . import hub
    from .data.datasets import load_image
    from .models.detection.predict import head_classes
    from .ops.resize import resize
    from .predict import load_names
    from .train.detection import build_task
    from .utils.visualize import draw_boxes

    if args.tta and not args.model.startswith("yolox"):
        raise SystemExit("--tta currently supports the YOLOX family")
    model, _ = hub.load(args.model,
                        num_classes=head_classes(args.model,
                                                 args.num_classes),
                        seed=args.seed, ckpt=args.ckpt, device=args.device)
    dev = next(model.parameters()).device
    is_npy = args.input.lower().endswith(".npy")
    raw = np.asarray(load_image(args.input), np.float32)  # (H, W, 3)
    h0, w0 = raw.shape[:2]
    if not is_npy:               # image files decode to 0-255
        raw = raw / 255.0        # .npy is model-ready by convention
    elif raw.max() > 4.0:
        # mean/std-normalized arrays top out near ~3; values beyond that
        # mean raw 0-255 pixels were saved un-normalized
        print(f"warning: .npy input has max {raw.max():.1f} — looks "
              "like raw 0-255 pixels; .npy must be model-ready "
              "(normalized) or detections will be garbage",
              file=sys.stderr)
    images = resize(torch.from_numpy(raw), (args.size, args.size, 3),
                    "bilinear")[None].to(dev)

    with torch.no_grad():
        if args.tta:
            from .ops.tta import yolox_tta
            det = yolox_tta(model, images, score_thresh=args.score,
                            max_det=100)
        else:
            _, predict_fn = build_task(model, args.model, args.num_classes,
                                       score_thresh=args.score, max_det=100)
            det = predict_fn(images)
    det = {k: v[0].cpu().numpy() for k, v in det.items()}
    keep = det["valid"].astype(bool)
    boxes = det["boxes"][keep]
    scores = det["scores"][keep]
    labels = det["labels"][keep]
    boxes = boxes * np.array([w0 / args.size, h0 / args.size] * 2)

    names = load_names(args.classes)
    for b, s, c in zip(boxes, scores, labels):
        print(json.dumps({
            "box": [round(float(x), 1) for x in b],
            "score": round(float(s), 4),
            "label": names.get(int(c), int(c))}))

    # render: image files are 0-1 here; an arbitrary-range .npy is min-max
    # normalized for display only
    disp = raw if not is_npy else \
        (raw - raw.min()) / max(raw.max() - raw.min(), 1e-6)
    annotated = draw_boxes(
        np.clip(disp * 255.0, 0, 255).astype(np.uint8), boxes,
        labels=[names.get(int(c), str(int(c))) for c in labels],
        scores=scores)
    out_path = args.out or os.path.splitext(args.input)[0] + "_det.png"
    from PIL import Image
    Image.fromarray(annotated).save(out_path)
    print(f"wrote {out_path} ({int(keep.sum())} detections)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
