"""Standalone evaluation CLI of the port — the counterpart of
``tools/evaluate.py`` (the per-project val.py / test.py successor).

  python -m deeplearning_tpu_torch.evaluate --model resnet18 \\
      --num-classes 10 --npz data.npz [--ckpt runs/x/ckpt/best] \\
      [--batch 64] [--tta] [--out-json results.json]

Runs the eval forward over a dataset and prints top-1 / top-5 and
per-class accuracy from the confusion matrix (``evaluation/metrics``:
``topk_correct``, ``confusion_matrix``, ``miou_from_confusion``) as one
JSON line, and optionally writes them to ``--out-json``. ``--npz`` holds
model-ready ``images`` and ``labels``; ``--folder`` is an ImageFolder root
whose val split (the training loader stack, the same ``--seed`` as
training) is decoded and moved to the device by the loader. The counts
stay on the device and are read once, at the end.

Differences from ``tools/evaluate.py``, by decision: ``--device``
(default ``cuda``) where JAX reads ``DLTPU_PLATFORM``; the model is
built as the predict CLI builds it (a ViT's attention on K1), for the
data's channels and size (``in_chans``, and ``img_size`` for the families
that take it), where flax infers them at init.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .predict import build_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.evaluate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--npz", default=None,
                    help="npz with model-ready 'images' and 'labels'")
    ap.add_argument("--folder", default=None,
                    help="ImageFolder root (real JPEG eval, val split)")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--val-rate", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0,
                    help="split seed (must match train.seed for the "
                         "--folder val split to be held out) and the "
                         "weights' seed without --ckpt")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--tta", action="store_true",
                    help="average probabilities over a horizontal flip "
                         "(yolov5 val --augment analog)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.npz and not args.folder:
        ap.error("one of --npz / --folder is required")
    import torch

    from .core.device import resolve_device
    from .evaluation.metrics import (confusion_matrix, miou_from_confusion,
                                     topk_correct)
    from .ops.tta import classify_tta

    dev = resolve_device(args.device)
    if args.npz:
        blob = np.load(args.npz)
        images, labels = blob["images"], blob["labels"]

        def batches():
            bs = max(min(args.batch, len(images)), 1)
            n = (len(images) // bs) * bs
            for start in range(0, n, bs):
                yield (torch.from_numpy(np.ascontiguousarray(
                           images[start:start + bs], np.float32)).to(dev),
                       torch.from_numpy(np.asarray(
                           labels[start:start + bs])).to(dev))
        size, channels = images.shape[1], images.shape[-1]
    else:
        # the training side's loader stack (worker-pool decode, clamped
        # val batch) with the same split seed as training
        from .data.build import LoaderConfig, build_classification_loaders
        lcfg = LoaderConfig(global_batch=args.batch,
                            image_size=args.image_size,
                            val_rate=args.val_rate, seed=args.seed,
                            num_workers=args.workers)
        _, val_loader, class_to_idx = build_classification_loaders(
            args.folder, lcfg, device=dev)
        if len(class_to_idx) != args.num_classes:
            ap.error(f"--num-classes {args.num_classes} but folder has "
                     f"{len(class_to_idx)} classes")
        if len(val_loader) == 0:
            raise SystemExit(
                "empty val split — raise --val-rate or add images")

        def batches():
            for batch in val_loader:
                yield batch["image"], batch["label"]
        size, channels = args.image_size, 3
    args.size = size
    extra = {} if channels == 3 else {"in_chans": int(channels)}
    model = build_model(args, **extra).to(dev).eval()

    totals = None
    cm_total = torch.zeros((args.num_classes, args.num_classes),
                           dtype=torch.int64, device=dev)
    with torch.no_grad():
        for imgs, labs in batches():
            if args.tta:
                probs = classify_tta(model, imgs)
                scores = torch.log(probs.clamp(min=1e-30))  # rank-equal
            else:
                scores = model(imgs).float()
            counts = topk_correct(scores, labs)
            totals = counts if totals is None else \
                {k: totals[k] + counts[k] for k in counts}
            cm_total += confusion_matrix(scores.argmax(-1), labs,
                                         args.num_classes)
    if totals is None or int(totals["count"]) == 0:
        raise SystemExit("no samples evaluated (empty dataset?)")

    totals = {k: int(v) for k, v in totals.items()}     # the one fetch
    count = totals["count"]
    stats = miou_from_confusion(cm_total.cpu())
    results = {
        "top1": totals["top1"] / count,
        "top5": totals["top5"] / count,
        "count": count,
        "per_class_acc": [round(float(a), 4) for a in stats["class_acc"]],
    }
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in results.items()}))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
