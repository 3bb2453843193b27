#!/usr/bin/env python
"""Card smoke test of the PyTorch/CUDA port: build, check, serve, measure.

    python chip_smoke.py            # one NVIDIA Hopper card (sm_90)

Phases (any failure raises and exits non-zero; nothing is skipped):

1. build the CUDA kernels from ``deeplearning_tpu_torch/csrc`` (nvcc,
   first use) and print the build seconds and the ptxas register report;
2. hold the flash-attention kernel against its plain PyTorch version on
   the card, for both instantiations (one head and four heads per CTA),
   at the ViT-B/16 shape (B=32, H=12, N=197, D=64; bf16 tolerance 2e-2,
   float32 1e-4), a Swin-window shape (N=49, D=32), a causal case, N=1,
   D=16 and D=128;
3. serve ViT-B/16 at full width (224², 12 layers, 768 wide, 1000
   classes, weights from ``--seed``) through ``InferenceEngine`` (buckets
   1/8/32) and ``MicroBatcher``: 64 requests from 8 submitting threads
   with ``attn="flash_hb"`` (the serve default), then 16 requests with
   ``attn="flash"``. Launch counters are zeroed just before each and
   read just after; each must equal 12 × the batches dispatched. Every
   answer must arrive and match ``engine.infer`` of the same image, and
   the engine must match a second engine on the same weights with the
   naive attention (log-probabilities within 0.05: bf16 compute through
   12 layers; top-1 equal unless the two classes tie within that);
4. measure: per-bucket latency and throughput of the served model (flash
   and naive attention, in turns), and each kernel's time at the main
   path's shape against the plain version, against
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   and against its bound (H100 SXM data sheet at a 700 W power limit:
   3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s float32).

The last three lines: the card's name and power limit (nvidia-smi), one
``{"kernels": [...]}`` JSON object, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCE = "deeplearning_tpu_torch/csrc/flash_attn_fwd.cu"
REPLACES = {"flash_attn_fwd": "deeplearning_tpu/ops/pallas/flash_attention.py:38",
            "flash_attn_fwd_hb": "deeplearning_tpu/ops/pallas/flash_attention.py:166"}
ATTN_FOR = {"flash_attn_fwd_hb": "flash_hb", "flash_attn_fwd": "flash"}
HPC_FOR = {"flash_attn_fwd": 1, "flash_attn_fwd_hb": 4}
LOGP_TOL = 0.05
MODEL = "vit_base_patch16_224"
DEPTH, HEADS, TOKENS, HEAD_DIM = 12, 12, 197, 64


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 3
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    # float32 references in full float32 (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")

    # ------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"total {time.perf_counter() - t0:.2f}s")
    for line in (build.ptxas_report("flash_attn_fwd") or "").splitlines():
        if "registers" in line or "bytes spill" in line:
            log("  ptxas:", line.strip())

    # ---------------------------------------- 2. kernel vs plain on card
    errs = {name: 0.0 for name in HPC_FOR}
    g = torch.Generator(device=dev).manual_seed(args.seed)
    cases = [(32, 12, 197, 64, False), (8, 4, 49, 32, False),
             (4, 12, 197, 64, True), (8, 12, 1, 64, False),
             (2, 8, 300, 128, False), (2, 4, 17, 16, True)]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for b, h, n, d, causal in cases:
            # the serve path's layout: strided slices of one fused qkv
            qkv = torch.randn(b, n, 3, h, d, device=dev, generator=g).to(dtype)
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
            ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
            for name, hpc in HPC_FOR.items():
                out, lse = fa._attention(q, k, v, sm_scale=None,
                                         causal=causal, heads_per_cta=hpc)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                log(f"kernel-vs-plain {name} {str(dtype)[6:]} "
                    f"B={b} H={h} N={n} D={d} causal={causal}: "
                    f"max_abs_err {err:.3e} (tol {tol}) lse {lse_err:.3e}")
                check(err <= tol and lse_err <= 1e-3,
                      f"{name} disagrees with the plain version")
                if (b, h, n, d, dtype) == (32, HEADS, TOKENS, HEAD_DIM,
                                           torch.bfloat16):
                    errs[name] = max(errs[name], err)

    # ------------------------------------------------ 3. the main path
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher

    buckets = (1, 8, 32)
    engines = {}
    for attn in ("flash_hb", "flash", "naive"):
        t0 = time.perf_counter()
        model, _ = hub.load(MODEL, num_classes=1000, seed=args.seed,
                            device=dev, attn_fn=get_attn_fn(attn))
        engines[attn] = InferenceEngine(MODEL, model=model,
                                        batch_buckets=buckets, device=dev)
        log(f"engine {attn}: built and warmed in "
            f"{time.perf_counter() - t0:.2f}s; "
            f"{json.dumps(engines[attn].stats())}")
    ref_state = engines["naive"].model.state_dict()
    for attn in ("flash_hb", "flash"):
        state = engines[attn].model.state_dict()
        check(all(torch.equal(state[k], ref_state[k]) for k in ref_state),
              f"{attn} engine weights differ from the naive engine's")

    rng = np.random.default_rng(args.seed)
    images = rng.normal(size=(64, 224, 224, 3)).astype(np.float32)
    launches = {}
    served_ms = {}
    for name, n_req in (("flash_attn_fwd_hb", 64), ("flash_attn_fwd", 16)):
        engine = engines[ATTN_FOR[name]]
        reqs = images[:n_req]
        with MicroBatcher(engine, max_wait_ms=5.0) as mb:
            fa.reset_launch_counts()
            t0 = time.perf_counter()

            def client(part):
                handles = [mb.submit(img) for img in part]
                return [h.result(timeout=120.0) for h in handles]

            with ThreadPoolExecutor(8) as pool:
                rows = [r for part in pool.map(client,
                                               np.array_split(reqs, 8))
                        for r in part]
            served_ms[name] = (time.perf_counter() - t0) * 1e3
            counts = fa.launch_counts()
            batches = mb.dispatched
        launches[name] = counts[name]
        log(f"served {len(rows)}/{n_req} requests via attn="
            f"{ATTN_FOR[name]} in {served_ms[name]:.1f} ms "
            f"({n_req / served_ms[name] * 1e3:.1f} img/s): {batches} "
            f"batches, launches {json.dumps(counts)}")
        check(len(rows) == n_req, "every answer arrives")
        check(counts[name] == DEPTH * batches and counts[name] > 0,
              f"{name} launches == {DEPTH} x batches dispatched")
        served = np.stack(rows)
        check(served.shape == (n_req, 1000) and np.isfinite(served).all(),
              "answers are finite (n, 1000) probabilities")
        single = np.concatenate([engine.infer(img) for img in reqs])
        _compare(served, single, f"{name}: served vs engine.infer")

    x = images[:32]
    lp = {a: engines[a].infer(x) for a in ("flash_hb", "flash", "naive")}
    _compare(lp["flash_hb"], lp["naive"], "flash_hb engine vs naive engine")
    _compare(lp["flash"], lp["naive"], "flash engine vs naive engine")

    # ------------------------------------------------------- 4. measure
    for b in buckets:
        xb = images[:b]
        times = {"flash_hb": [], "naive": []}
        for attn in ("naive", "flash_hb", "flash_hb", "naive") * 5:
            eng = engines[attn]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(b, xb)
            torch.cuda.synchronize()
            times[attn].append((time.perf_counter() - t0) * 1e3)
        line = {a: {"latency_ms_p50": round(statistics.median(t), 3),
                    "img_per_s": round(b / statistics.median(t) * 1e3, 1)}
                for a, t in times.items()}
        log(f"bucket {b}: {json.dumps(line)}")

    kernels = []
    qkv = torch.randn(32, TOKENS, 3, HEADS, HEAD_DIM, device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = fa.flops(32, HEADS, TOKENS, HEAD_DIM)
    nbytes = fa.min_bytes(32, HEADS, TOKENS, HEAD_DIM, 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    plain_ms = _time_ms(lambda: fa.flash_attention_reference(qt, kt, vt))
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    for name, hpc in HPC_FOR.items():
        ms = _time_ms(lambda: fa.attention_bnhd(q, k, v, heads_per_cta=hpc))
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms})
        log(f"timing {name} B=32 H=12 N=197 D=64 bf16: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP; {nbytes / ms / 1e6:.0f} GB/s, "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _compare(probs: np.ndarray, ref: np.ndarray, what: str) -> None:
    """Log-probabilities within LOGP_TOL; top-1 equal unless the reference
    scores the two classes within LOGP_TOL of each other (a tie at bf16
    precision)."""
    lp, lr = np.log(probs), np.log(ref)
    diff = float(np.abs(lp - lr).max())
    top = lp.argmax(1)
    same = int((top == lr.argmax(1)).sum())
    tie_ok = bool((lr[np.arange(len(lr)), top]
                   >= lr.max(1) - LOGP_TOL).all())
    log(f"{what}: max |dlogp| {diff:.3e} (tol {LOGP_TOL}), top-1 equal "
        f"{same}/{len(lp)}")
    check(np.isfinite(lp).all() and diff <= LOGP_TOL and tie_ok, what)


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls)."""
    import torch
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


if __name__ == "__main__":
    sys.exit(main())
