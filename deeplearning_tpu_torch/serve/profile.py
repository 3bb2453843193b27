"""Where a served forward's time goes on the card.

    python -m deeplearning_tpu_torch.serve.profile [--attn flash_hb,naive]
        [--buckets 1,8,32] [--iters 10]
    python -m deeplearning_tpu_torch.serve.profile --model yolox_s
        --size 640 [--nms-impl auto,blocked]
    python -m deeplearning_tpu_torch.serve.profile \
        --model fasterrcnn_resnet50_fpn --size 800 --buckets 1,8

For each attention choice (a detector: each NMS path) and bucket: the
host wall time of one ``InferenceEngine.run`` ending in a synchronise
(timed without the profiler, whose own host cost would inflate it), the
device time summed over every CUDA kernel and copy that ``torch.profiler``
records for the same call, the device idle share (1 - device / wall), and
the device time by kind of kernel (convolutions, by the op that launched
them; GEMMs, gathers such as RoIAlign's, sorts and top-k, K3, ...), by the
aten op that launched it, inside BatchNorm calls (each wrapped in a
profiler range while profiled), and the kernels that take the most device
time. One JSON line per (variant, bucket), then the card's name and power
limit. ViT-B/16 (or ``--model``,
e.g. Swin-T, whose ``--attn`` naive is the unfused window attention and
flash_hb the fused kernel) at full width, weights from ``--seed``. A
detector is served as ``chip_smoke.py`` serves it (``seeded_detector``):
weights a flax tree drawn from the seed, with nonzero scales (a ResNet's
residual branches start at scale 0), carried in by the converter, then
BatchNorm statistics calibrated on seeded images (``calibrate_batchnorm``);
a score threshold of 0 (Faster R-CNN: its default 0.05), so every
candidate reaches NMS.
Classes: 80 for YOLOX and YOLOv5, 20 for the others (Faster R-CNN's head
has a background class besides). ``--nms-impl`` auto runs K3, blocked the
plain sweep. Needs a card; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _kinds():
    """Kinds of kernel, by substrings of their names (first match wins):
    the train profiler's, with a detector's before them."""
    from ..train.profile import KINDS
    return (("nms (K3)", ("nms_greedy_sweep",)),
            ("conv", ("fprop", "implicit_gemm", "conv")),
            *KINDS[:2],
            ("gather / index", ("index", "gather", "scatter")),
            ("sort / top-k", ("sort", "radix", "topk")),
            *KINDS[2:])


def kind_of(name: str) -> str:
    for kind, keys in _kinds():
        if any(k in name for k in keys):
            return kind
    return "elementwise / other"


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _device_total_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _batchnorm_ranges(model: torch.nn.Module) -> list:
    """Hooks that wrap every ``models/layers.BatchNorm`` call in a profiler
    range named ``BatchNorm`` (its float32 casts and affine map are plain
    elementwise ops, which no kernel name tells apart from a ReLU or a
    residual add). Returns the hook handles."""
    from ..models.layers import BatchNorm
    handles = []

    def enter(mod, args):
        mod._range = torch.profiler.record_function("BatchNorm")
        mod._range.__enter__()

    def leave(mod, args, out):
        mod._range.__exit__(None, None, None)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            handles += [m.register_forward_pre_hook(enter),
                        m.register_forward_hook(leave)]
    return handles


def profile_bucket(engine, bucket: int, images: np.ndarray, iters: int,
                   top: int = 8) -> dict:
    """One bucket's wall time (unprofiled), device time and idle share, the
    device time by kind of kernel (``kind_of``; every kernel a convolution
    op launched counts as conv), by the aten op that launched it
    (``by_op``, self device time) and inside BatchNorm calls
    (``batchnorm``), and the ``top`` kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        engine.run(bucket, images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.run(bucket, images)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    handles = _batchnorm_ranges(engine.model)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                engine.run(bucket, images)
                torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    events = prof.key_averages()
    # the BatchNorm ranges also show as device-side annotations: not kernels
    rows = [(e.key, _device_us(e) / 1e3 / iters) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "BatchNorm"]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    # a kernel a convolution op launched is a conv, whatever its name (cuDNN
    # launches layout transforms and GEMMs that ``kind_of`` cannot tell)
    under_conv: dict = {}
    for e in prof.events():
        if "convolution" in e.name:
            for k in e.kernels:
                under_conv[k.name] = (under_conv.get(k.name, 0.0)
                                      + k.duration / 1e3 / iters)
    kinds: dict = {}
    for name, ms in rows:
        conv = min(ms, under_conv.get(name, 0.0))
        for kind, part in (("conv", conv), (kind_of(name), ms - conv)):
            kinds[kind] = kinds.get(kind, 0.0) + part
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    ops = sorted(((e.key, _device_us(e) / 1e3 / iters) for e in cpu
                  if e.key.startswith("aten::") and _device_us(e) > 0),
                 key=lambda r: -r[1])
    bn_ms = sum(_device_total_us(e) for e in cpu
                if e.key == "BatchNorm") / 1e3 / iters
    return {"bucket": bucket, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "by_kind": {k: [ms, ms / device_ms] for k, ms in
                        sorted(kinds.items(), key=lambda kv: -kv[1])},
            "by_op": [[name, ms, ms / device_ms] for name, ms in ops[:top]],
            "batchnorm": [bn_ms, bn_ms / device_ms],
            "top": [[name[:60], ms, ms / device_ms]
                    for name, ms in rows[:top]]}


def detector_defaults(name: str):
    """(foreground classes, score threshold) a detector is served with by
    ``chip_smoke.py`` and this profiler."""
    classes = 80 if name.startswith(("yolox", "yolov5")) else 20
    return classes, 0.05 if name.startswith("fasterrcnn") else 0.0


# every seeded ``scale`` (BatchNorm's, FCOS's level scales) is uniform in
# this range: nonzero, so a ResNet's residual branches (scale 0 at init) take
# part in every answer
SCALE_RANGE = (0.5, 1.0)


def seeded_flax_tree(model: torch.nn.Module, seed: int) -> dict:
    """A flax variable tree of numpy float32 arrays for ``model``, drawn
    from ``seed``: conv (HWIO) and dense (in, out) kernels normal with
    variance 1 / fan-in, every ``scale`` uniform in ``SCALE_RANGE``, every
    bias uniform in ±0.1, BatchNorm statistics 0 and 1. Its paths and
    shapes follow from the port's own names (``convert.flax_path``), so
    loading it drives the converter as a flax checkpoint would; it checks
    no layout against JAX (the CPU tests do that)."""
    from ..utils.convert import flax_path
    rng = np.random.default_rng(seed)
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        *mods, leaf = flax_path(key, t.dim()).split("/")
        shape = tuple(t.shape)
        if leaf == "kernel":
            # OIHW -> HWIO, (out, in) -> (in, out)
            shape = shape[2:] + shape[1::-1] if t.dim() == 4 else shape[::-1]
            value = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            value = rng.uniform(*SCALE_RANGE, size=shape)
        elif leaf in ("mean", "var"):
            value = np.full(shape, float(leaf == "var"))
        else:
            value = rng.uniform(-0.1, 0.1, size=shape)
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value.astype(np.float32)
    return tree


def seeded_detector(name: str, classes: int, seed: int, size: int,
                    device="cuda") -> torch.nn.Module:
    """Registry detector ``name`` at full width, its weights a flax tree
    drawn from ``seed`` (``seeded_flax_tree``) carried in by the converter,
    its BatchNorm statistics then calibrated on four seeded images."""
    from .. import hub
    from ..models.detection.predict import head_classes
    from ..models.layers import calibrate_batchnorm
    from ..utils import convert
    model, _ = hub.load(name, num_classes=head_classes(name, classes),
                        seed=seed, device=device)
    model.load_state_dict(convert.from_flax_params(
        seeded_flax_tree(model, seed + 3), like=model))
    calibrate_batchnorm(model, torch.from_numpy(
        np.random.default_rng(seed + 4).normal(
            size=(4, size, size, 3)).astype(np.float32)).to(device))
    return model


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
    classes, score = detector_defaults(args.model) if detect else (1000,
                                                                   None)
    for variant in (args.nms_impl if detect else args.attn).split(","):
        extra = {}
        if detect:
            model = seeded_detector(args.model, classes, args.seed,
                                    args.size)
            extra = {"nms_impl": variant, "score_thresh": score}
        else:
            model, _ = hub.load(args.model, num_classes=classes,
                                seed=args.seed,
                                **hub.model_kwargs(args.model, variant,
                                                   args.size))
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
