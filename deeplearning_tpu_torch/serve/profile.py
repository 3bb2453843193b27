"""Where a served forward's time goes on the card.

    python -m deeplearning_tpu_torch.serve.profile [--attn flash_hb,naive]
        [--buckets 1,8,32] [--iters 10]
    python -m deeplearning_tpu_torch.serve.profile --model yolox_s
        --size 640 [--nms-impl auto,blocked]

For each attention choice (a detector: each NMS path) and bucket: the
host wall time of one ``InferenceEngine.run`` ending in a synchronise
(timed without the profiler, whose own host cost would inflate it), the
device time summed over every CUDA kernel and copy that ``torch.profiler``
records for the same call, the device idle share (1 - device / wall), and
the kernels that take the most device time. One JSON line per (variant,
bucket), then the card's name and power limit. ViT-B/16 (or ``--model``,
e.g. Swin-T, whose ``--attn`` naive is the unfused window attention and
flash_hb the fused kernel) at full width, weights from ``--seed``. A
detector (YOLOX) is served as ``chip_smoke.py`` serves it: BatchNorm
statistics calibrated on seeded images (``calibrate_batchnorm``: with the
init's statistics every box is its grid cell and every score 1.0e-4) and
a score threshold of 0, so every candidate reaches NMS; ``--nms-impl`` auto
runs the K3 kernels, blocked the plain sweep. Needs a card; it never runs
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_bucket(engine, bucket: int, images: np.ndarray, iters: int,
                   top: int = 8) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        engine.run(bucket, images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.run(bucket, images)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            engine.run(bucket, images)
            torch.cuda.synchronize()
    rows = [(e.key, _device_us(e) / 1e3 / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"bucket": bucket, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": [[name[:60], ms, ms / device_ms]
                    for name, ms in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_base_patch16_224")
    ap.add_argument("--attn", default="flash_hb,naive")
    ap.add_argument("--buckets", default="1,8,32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--nms-impl", default="auto,blocked",
                    help="a detector's NMS paths to profile")
    args = ap.parse_args(argv)

    from .. import hub
    from ..models.detection.predict import is_detection_model
    from .engine import InferenceEngine

    buckets = tuple(int(b) for b in args.buckets.split(","))
    images = np.random.default_rng(args.seed).normal(
        size=(max(buckets), args.size, args.size, 3)).astype(np.float32)
    detect = is_detection_model(args.model)
    classes = 80 if detect else 1000
    for variant in (args.nms_impl if detect else args.attn).split(","):
        model, _ = hub.load(args.model, num_classes=classes, seed=args.seed,
                            **hub.model_kwargs(args.model, variant,
                                               args.size))
        extra = {}
        if detect:
            from ..models.detection.yolox import calibrate_batchnorm
            calibrate_batchnorm(model, torch.from_numpy(
                np.random.default_rng(args.seed + 2).normal(size=(
                    8, args.size, args.size, 3)).astype(np.float32)).cuda())
            extra = {"nms_impl": variant, "score_thresh": 0.0}
        engine = InferenceEngine(args.model, model=model,
                                 num_classes=classes, image_size=args.size,
                                 batch_buckets=buckets, **extra)
        for b in buckets:
            row = profile_bucket(engine, b, images[:b], args.iters)
            print(json.dumps({"nms_impl" if detect else "attn": variant,
                              **row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
