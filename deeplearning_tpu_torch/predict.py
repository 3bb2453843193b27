"""Inference CLI of the port — the counterpart of ``tools/predict.py``
(the per-project predict.py successor).

  python -m deeplearning_tpu_torch.predict --model mnist_cnn \\
      --ckpt runs/x/ckpt/best --input img.png [--classes idx.json] \\
      [--topk 5] [--tta]

A thin client of ``serve.InferenceEngine``: one code path builds the
session (weights restored once, EMA-preferring), warms exactly the
bucket the input needs, and runs the forward — plain softmax, flip-TTA
(``--tta``; a ViT's attention runs on K1, ``flash_hb``), or a detection
family's fixed-shape postprocess (every NMS through K3 on the card) —
with results reported per image. A multi-image ``.npz`` prints one line
per image; detection output prints only the valid rows (the class −1
padding slots of the fixed-shape outputs stay inside the engine). Serving
the same session under load is ``python -m deeplearning_tpu_torch.serve``;
this is the one-shot surface.

Differences from ``tools/predict.py``, by decision: ``--device`` (default
``cuda``; ``cpu`` asks for the CPU) where JAX reads ``DLTPU_PLATFORM``;
``--seed`` sets the weights when no ``--ckpt`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_batch(path: str, size: int, task: str = "classify") -> np.ndarray:
    """Image files go through the eval transform (resize + /255 for
    detection, the demo's frame); ``.npz`` batches are model-ready by
    convention (the train CLI feeds npz arrays raw), so they bypass
    normalization: mixing the two would double-normalize."""
    from .data.datasets import load_image
    if path.endswith(".npz"):
        return np.asarray(np.load(path)["images"], np.float32)
    raw = np.asarray(load_image(path), np.float32)
    if task == "detect":
        import torch

        from .ops.resize import resize
        if not path.lower().endswith(".npy"):
            raw = raw / 255.0        # .npy is model-ready by convention
        return resize(torch.from_numpy(raw), (size, size, 3),
                      "bilinear").numpy()[None]
    from .data.transforms import classification_eval_transform
    fn = classification_eval_transform((size, size))
    return fn({"image": raw[None]})["image"]


def report_classification(probs: np.ndarray, names, topk: int) -> None:
    for bi, p in enumerate(probs):
        order = np.argsort(-p)[:topk]
        print(f"image {bi}: " + "  ".join(
            f"{names.get(int(i), int(i))}={p[i]:.4f}" for i in order))


def report_detections(det, names) -> None:
    """Per-image detection lines, valid rows only."""
    for bi in range(det["boxes"].shape[0]):
        keep = np.asarray(det["valid"][bi], bool)
        rows = [{"box": [round(float(x), 1) for x in b],
                 "score": round(float(s), 4),
                 "label": names.get(int(c), int(c))}
                for b, s, c in zip(np.asarray(det["boxes"][bi])[keep],
                                   np.asarray(det["scores"][bi])[keep],
                                   np.asarray(det["labels"][bi])[keep])]
        print(f"image {bi}: " + json.dumps(rows))


def load_names(path) -> dict:
    """{class index: name} from a json file of index -> name, or {}."""
    if not path:
        return {}
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def build_model(args, **extra):
    """The registry model of ``args`` on the CPU (the engine moves it),
    its attention on the kernels (``flash_hb``: K1 for a ViT, K2 for a
    Swin), with ``--ckpt``'s weights or ``--seed``'s; ``extra`` factory
    keywords (``in_chans``)."""
    from . import hub
    from .models.detection.predict import head_classes
    kw = dict(hub.model_kwargs(args.model, "flash_hb", args.size))
    kw.update(extra)
    model, _ = hub.load(args.model,
                        num_classes=head_classes(args.model,
                                                 args.num_classes),
                        seed=args.seed, ckpt=args.ckpt, device="cpu", **kw)
    return model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.predict", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (a step dir or 'best')")
    ap.add_argument("--input", required=True)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--classes", default=None,
                    help="json mapping class index -> name")
    ap.add_argument("--tta", action="store_true",
                    help="average probabilities over a horizontal-flip "
                         "view (yolov5 --augment analog)")
    ap.add_argument("--score", type=float, default=0.3,
                    help="detection score threshold")
    ap.add_argument("--max-det", type=int, default=100)
    ap.add_argument("--nms-impl", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .models.detection.predict import is_detection_model
    from .serve import InferenceEngine

    task = "detect" if is_detection_model(args.model) else "classify"
    images = load_batch(args.input, args.size, task)
    n = images.shape[0]
    if args.input.endswith(".npz"):
        # npz batches are model-ready at their own resolution: the engine
        # warms its buckets for the array's shape, not --size
        if images.shape[1] != images.shape[2]:
            raise SystemExit(f"npz images must be square for the "
                             f"bucketed engine, got {images.shape}")
        args.size = images.shape[1]
    # one-shot CLI: warm exactly the bucket this input needs (plus bucket
    # 1, so the engine surface stays uniform), nothing speculative
    engine = InferenceEngine(
        args.model, model=build_model(args), num_classes=args.num_classes,
        image_size=args.size, batch_buckets=sorted({1, n}), tta=args.tta,
        score_thresh=args.score, max_det=args.max_det,
        nms_impl=args.nms_impl, device=args.device)
    names = load_names(args.classes)
    out = engine.infer(images)
    if engine.task == "detect":
        report_detections(out, names)
    else:
        report_classification(out, names, args.topk)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
