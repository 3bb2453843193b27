"""Where a ViT-B/16 (or ``--model``, e.g. Swin-T) train step's time goes
on the card.

    python -m deeplearning_tpu_torch.train.profile [--attn flash_hb,naive]
        [--batch 128] [--iters 5]

For each attention choice: the host wall time of one train step ending in
a synchronise (timed without the profiler, whose own host cost would
inflate it), the device time summed over every CUDA kernel and copy that
``torch.profiler`` records for the same steps, the device idle share
(1 - device / wall), the device time by kind of kernel (the flash and
window-attention kernels, GEMMs, the optimizer's multi-tensor kernels,
...) and the kernels that take the most of it. One JSON line per
attention choice, then the card's name and power limit. The step and the weights are the
bench's (``train/bench.py``). Needs a card; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..serve.profile import _device_us

# kind of kernel, by substrings of its name (first match wins)
KINDS = (("flash attention", ("bwd_dq_", "bwd_dkv_", "fwd_bf16_",
                              "fwd_f32_simt")),
         ("window attention", ("win_bf16_", "win_f32_simt")),
         ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
         ("optimizer", ("multi_tensor", "foreach")),
         ("softmax", ("softmax",)),
         ("layernorm", ("layer_norm", "layernorm")),
         ("copy / cast", ("copy", "memcpy", "memset")),
         ("reduce", ("reduce",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise / other"


def profile_steps(step, state, batch, key, iters: int, top: int = 10
                  ) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            state, _ = step(state, batch, key)
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e) / 1e3 / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    kinds: dict = {}
    for name, ms in rows:
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "by_kind": {k: [ms, ms / device_ms] for k, ms in
                        sorted(kinds.items(), key=lambda kv: -kv[1])},
            "top": [[name[:60], ms, ms / device_ms]
                    for name, ms in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vit_base_patch16_224")
    ap.add_argument("--attn", default="flash_hb,naive")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .. import hub
    from ..core.rng import root_key
    from .classification import make_loss_fn
    from .optim import build_optimizer
    from .schedules import build_schedule
    from .state import TrainState
    from .steps import make_train_step

    dev = torch.device("cuda")
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    data = np.random.default_rng(args.seed)
    batch = {"image": torch.from_numpy(data.normal(
                 size=(args.batch, 224, 224, 3)).astype(np.float32)).to(dev),
             "label": torch.from_numpy(data.integers(
                 0, 1000, args.batch)).to(dev)}
    for attn in args.attn.split(","):
        model, _ = hub.load(args.model, seed=args.seed, device=dev,
                            **hub.model_kwargs(args.model, attn))
        sched = build_schedule("warmup_cosine", base_lr=1e-3,
                               total_steps=10_000, warmup_steps=100)
        tx = build_optimizer("adamw", sched, weight_decay=0.05,
                             params=dict(model.named_parameters()))
        state = TrainState.create(model=model, tx=tx)
        row = profile_steps(step, state, batch, root_key(args.seed),
                            args.iters)
        print(json.dumps({"attn": attn, "batch": args.batch, **row}),
              flush=True)
        del model, state
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
