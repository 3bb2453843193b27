"""Flash-attention (K1) kernel benchmark on the card, at the ViT-B/16
shapes. Prints JSON lines and writes no file.

    python -m deeplearning_tpu_torch.ops.flash_bench
    # the same wrappers over kernels built from another source tree (an
    # earlier design, unpacked from git into a git-ignored directory)
    python -m deeplearning_tpu_torch.ops.flash_bench --csrc DIR --tag old

For heads per CTA 1 and 4 (``flash`` and ``flash_hb``) it times, on bf16
q, k, v that are strided views of one fused (B, N, 3, H, D) projection as
the ViT adapter hands them over (H=12, N=197, D=64):

- the forward kernel at batch 32 (the largest serving bucket) and 128
  (the training batch), beside ``scaled_dot_product_attention`` on the
  same views (a library yardstick the port never calls);
- the dQ and the dK/dV kernel alone at batch 128, and the pair, beside
  SDPA's whole backward through autograd;
- the host time of one forward call at batch 1 (enqueue only, no
  synchronise: argument checks, tensor-map encoding, launch).

Every kernel time sits beside its bound (H100 SXM data sheet: 3.35 TB/s,
989 TFLOP/s bf16, at a 700 W power limit). ``ms`` is the CUDA-event mean
of back-to-back calls after a warmup, the way ``chip_smoke.py`` times;
where the host takes longer to issue a call than the card to run it, that
is the host's time. ``graph_ms`` is the device time of one launch: the
calls captured once in a CUDA graph, and the graph replayed. To see the
spread, run it more than once in one call, in turns with what it is
compared with. It needs the card: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from . import flash_attention as fa

__all__ = ["main", "time_ms"]

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
HEADS, TOKENS, HEAD_DIM = 12, 197, 64


def time_ms(fn: Callable[[], object], iters: int = 100,
            warmup: int = 10) -> float:
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


def graph_ms(fn: Callable[[], object], calls: int = 20,
             replays: int = 10) -> float:
    """Device time of one ``fn`` in ms, without the host: ``calls`` calls
    captured in one CUDA graph, replayed ``replays`` times."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3


def _views(b: int, g: torch.Generator):
    """bf16 (B, N, H, D) q, k, v: slices of one fused projection."""
    qkv = torch.randn(b, TOKENS, 3, HEADS, HEAD_DIM, device="cuda",
                      generator=g).to(torch.bfloat16)
    return qkv.unbind(2)


def _forward(g: torch.Generator) -> List[dict]:
    rows = []
    for b in (32, 128):
        q, k, v = _views(b, g)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        def sdpa_fn():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt,
                                                                    vt)
        sdpa, sdpa_graph = time_ms(sdpa_fn), graph_ms(sdpa_fn)
        bound = _bound_ms(fa.min_bytes(b, HEADS, TOKENS, HEAD_DIM, 2),
                          fa.flops(b, HEADS, TOKENS, HEAD_DIM))
        for hpc in (1, 4):
            def fn():
                return fa.attention_bnhd(q, k, v, heads_per_cta=hpc)
            rows.append({"kernel": fa.KERNEL_NAMES[hpc], "batch": b,
                         "ms": time_ms(fn), "graph_ms": graph_ms(fn),
                         "bound_ms": bound, "sdpa_ms": sdpa,
                         "sdpa_graph_ms": sdpa_graph})
    return rows


def _backward(g: torch.Generator) -> List[dict]:
    b, h, n, d = 128, HEADS, TOKENS, HEAD_DIM
    q, k, v = (x.transpose(1, 2) for x in _views(b, g))
    o, lse = fa.flash_attention_reference(q, k, v)
    do = torch.randn(b, n, h, d, device="cuda", generator=g).to(
        torch.bfloat16).transpose(1, 2)
    lse = lse.reshape(b * h, n).contiguous()
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, n).contiguous()
    grads = [torch.empty(b, n, h, d, device="cuda", dtype=torch.bfloat16
                         ).transpose(1, 2) for _ in range(3)]
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    sdpa = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters=20, warmup=3)
    rows = []
    for hpc in (1, 4):
        for which in ("dq", "dkv", None):
            kernels = (which,) if which else ("dq", "dkv")
            def fn():
                fa._launch_bwd(q, k, v, do, lse, delta, *grads, d ** -0.5,
                               False, hpc, kernels=kernels)
            bound = _bound_ms(fa.bwd_min_bytes(b, h, n, d, 2, kernel=which),
                              fa.bwd_flops(b, h, n, d, kernel=which))
            name = fa.BWD_KERNEL_NAMES[which][hpc] if which else \
                f"dq + dkv, heads_per_cta {hpc}"
            rows.append({"kernel": name, "batch": b, "ms": time_ms(fn),
                         "graph_ms": graph_ms(fn), "bound_ms": bound,
                         "sdpa_backward_ms": sdpa})
    return rows


def _host(g: torch.Generator) -> List[dict]:
    """Host microseconds a forward call takes to return at batch 1."""
    q, k, v = _views(1, g)
    rows = []
    for hpc in (1, 4):
        for _ in range(20):
            fa.attention_bnhd(q, k, v, heads_per_cta=hpc)
        torch.cuda.synchronize()
        calls = 200
        t0 = time.perf_counter()
        for _ in range(calls):
            fa.attention_bnhd(q, k, v, heads_per_cta=hpc)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        rows.append({"kernel": fa.KERNEL_NAMES[hpc], "batch": 1,
                     "host_us_per_call": host_us})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="a label copied into each line")
    ap.add_argument("--csrc", default=None,
                    help="build the kernels from this source directory "
                         "instead of the package's csrc/")
    args = ap.parse_args(argv)
    if args.csrc:
        from .kernels import build
        build.CSRC_DIR = Path(args.csrc).resolve()
    if not torch.cuda.is_available():
        raise RuntimeError("flash_bench times the CUDA kernels: no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for row in _forward(g) + _backward(g) + _host(g):
        print(json.dumps({"tag": args.tag, **row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
