"""Window-attention benchmark on the card: the port of
``tools/window_bench.py``. Prints JSON lines and writes no file.

    python -m deeplearning_tpu_torch.ops.window_bench            # wpb 8
    python -m deeplearning_tpu_torch.ops.window_bench --wpb 4

At the reference's five shapes (Swin-T stages 1-3 at batch 128, Swin-B
stages 1 and 3 at batch 64; bf16, unmasked, as there) it times the fused
kernel (``window_attention``), its plain version, the unfused reference
the model runs with ``use_pallas=False``, and
``scaled_dot_product_attention`` with the bias as its additive mask (a
library yardstick the port never calls), beside the kernel's bound
(H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16, at a 700 W power
limit). Then it times a Swin-T forward at batch 64 with ``use_pallas``
off and on. Times are CUDA-event means after a warmup; every line names
the card. It needs the card: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["main", "SHAPES", "time_ms"]

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# (BW, N, heads, d): tools/window_bench.py:39-45
SHAPES = [
    (128 * 64, 49, 3, 32),    # Swin-T stage 1, batch 128
    (128 * 16, 49, 6, 32),    # stage 2
    (128 * 4, 49, 12, 32),    # stage 3
    (64 * 64, 49, 4, 32),     # Swin-B stage 1, batch 64
    (64 * 4, 49, 16, 32),     # Swin-B stage 3
]


def time_ms(fn: Callable[[], object], iters: int = 50,
            warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else None}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wpb", type=int, default=8, help="windows per block")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64,
                    help="batch of the Swin-T forward")
    args = ap.parse_args(argv)

    from .. import hub
    from . import window_attention as wa
    from .window_utils import windowed_attention_reference

    dev = resolve_device(None)
    card = _card()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for bw, n, heads, d in SHAPES:
        qkv = torch.randn(bw, n, 3 * heads * d, device=dev, generator=g).to(
            torch.bfloat16).view(bw, n, 3, heads, d)
        bias = torch.randn(heads, n, n, device=dev, generator=g)
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        add = bias.to(torch.bfloat16)[None]
        nbytes = wa.min_bytes(bw, n, heads, d, 2)
        flops = wa.flops(bw, n, heads, d)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        rec = {
            "shape": [bw, n, heads, d], "wpb": args.wpb,
            "kernel_ms": time_ms(lambda: wa.window_attention(
                qkv, bias, windows_per_block=args.wpb)),
            "plain_ms": time_ms(lambda: wa.window_attention_plain(qkv, bias),
                                iters=10),
            "reference_ms": time_ms(
                lambda: windowed_attention_reference(qkv, bias, None),
                iters=10),
            "sdpa_ms": time_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, attn_mask=add)),
            "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_BF16_FLOPS else "operations"),
            **card}
        print(json.dumps(rec), flush=True)
        del qkv, bias, q, k, v, add

    x = torch.from_numpy(np.random.default_rng(args.seed).normal(
        size=(args.batch, 224, 224, 3)).astype(np.float32)).to(dev)
    for use_pallas in (False, True):
        model, _ = hub.load("swin_tiny_patch4_window7_224", seed=args.seed,
                            device=dev, use_pallas=use_pallas)
        with torch.no_grad():
            ms = time_ms(lambda: model(x), iters=10, warmup=3)
        print(json.dumps({"model": "swin_tiny_patch4_window7_224",
                          "use_pallas": use_pallas, "batch": args.batch,
                          "fwd_ms": ms, "img_per_s": args.batch / ms * 1e3,
                          **card}), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
