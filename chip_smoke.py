#!/usr/bin/env python
"""Card smoke test of the PyTorch/CUDA port: build, check, serve, train, measure.

    python chip_smoke.py            # one NVIDIA Hopper card (sm_90)

Phases (any failure raises and exits non-zero; nothing is skipped):

1. build the CUDA kernels from ``deeplearning_tpu_torch/csrc`` (nvcc,
   first use) and print the build seconds and the ptxas register report;
2. hold the flash-attention kernel against its plain PyTorch version on
   the card, for both instantiations (one head and four heads per CTA),
   at the ViT-B/16 shape (B=32, H=12, N=197, D=64; bf16 tolerance 2e-2,
   float32 1e-4), a Swin-window shape (N=49, D=32), a causal case, N=1,
   D=16, D=128, ViT-H/14's D=80 (N=257, run zero-padded to the D=128
   kernel; plain and causal) and B*H = 262 144 (N=17, D=16: 65 536 head
   groups at four heads per CTA, past the 65 535 of a grid's y);
3. serve ViT-B/16 at full width (224², 12 layers, 768 wide, 1000
   classes, weights from ``--seed``) through ``InferenceEngine`` (buckets
   1/8/32) and ``MicroBatcher``: 64 requests from 8 submitting threads
   with ``attn="flash_hb"`` (the serve default), then 16 requests with
   ``attn="flash"``. Launch counters are zeroed just before each and
   read just after; each must equal 12 × the batches dispatched. Every
   answer must arrive and match ``engine.infer`` of the same image, and
   the engine must match a second engine on the same weights with the
   naive attention (log-probabilities within 0.05: bf16 compute through
   12 layers; top-1 equal unless the two classes tie within that). Then
   ViT-H/14 at full width and depth (224², patch 14, 32 layers, 1 280
   wide, 16 heads: D = 80) served at bucket 1 through ``MicroBatcher``
   with ``attn="flash_hb"``: 4 requests, the forward counter zeroed just
   before and read just after (32 × batches), each answer equal to
   ``engine.infer`` and to a naive-attention engine's on the same weights
   (log-probabilities within 0.05);
4. measure: per-bucket latency and throughput of the served model (flash
   and naive attention, in turns), and each kernel's time at the main
   path's shape (device time: calls captured in a CUDA graph and replayed;
   the eager call time beside it) against the plain version, against
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   and against its bound (H100 SXM data sheet at a 700 W power limit:
   3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s float32);
5. hold the four flash-attention backward kernels (dQ and dK/dV, one and
   four heads per CTA) against their plain version on the card: dQ, dK
   and dV at the training shape (B=128, H=12, N=197, D=64), N=49/D=32,
   causal, N=1, D=16, D=128 and D=80 (N=257, plain and causal), bf16
   (where the dQ kernel computes delta from O) and float32, q/k/v as
   strided
   fused-qkv slices (bf16: norm-relative error 1e-2 with an RMS floor of
   1e-4; float32: max abs 1e-4), and ``flash_chunk_grads`` (float32
   gradients) the same way;
6. train ViT-B/16 at full width at batch 128 through
   ``make_train_step(make_loss_fn(label_smoothing=0.1))`` with AdamW
   (weight decay 0.05) under warmup-cosine: 3 steps with
   ``attn="flash_hb"``, 2 with ``attn="flash"``. Launch counters are zeroed
   just before each run and read just after; each step must launch 12
   forward and 12 of each backward kernel of its route (24 forward with
   ``remat``, checked on one more step). The first step's loss and
   grad_norm must match a naive-attention state's on the same weights and
   batch (loss 5e-3 relative, grad_norm 5e-2: bf16 compute through 12
   layers); every metric is finite and ``bad_step`` 0; 8 steps on the
   fixed batch at constant lr 1e-4 must lower the loss;
7. measure: train step time, images/s and MFU for flash_hb and naive in
   turns, the ``train/bench.py`` line for both, and each backward
   kernel's time at the training shape (graph replay; dQ computing delta
   from O, as the step runs it) against the plain version, the backward
   of ``scaled_dot_product_attention`` through autograd (a yardstick only)
   and its bound; the dQ + dK/dV pair of each heads-per-CTA beside that
   whole SDPA backward; the forward kernels at the training shape beside
   SDPA's forward;
8. hold the fused window-attention kernel (``csrc/window_attn_fwd.cu``)
   against its plain PyTorch version on the card, bf16 (2e-2) and float32
   (1e-4), with qkv as strided slices of one (B·nW, N, 3·C) projection: the
   four Swin-T stage shapes at batch 32 (masked with nW = 64, 16, 4, then
   unmasked), N = 9 and 16, d = 16 and 64, nW not a multiple of
   ``windows_per_block``, and a mask of whole rows of -1e9 but the diagonal;
9. serve Swin-T at full width (224², patch 4, depths 2/2/6/2, heads
   3/6/12/24, embed 96, 1000 classes, weights from ``--seed``) through
   ``InferenceEngine`` (buckets 1/8/32) and ``MicroBatcher`` with the fused
   kernel: 64 requests from 8 threads. The K2 counter is zeroed just before
   and read just after: 12 × batches dispatched (one launch a block; the
   7×7 last stage runs unshifted, with no mask). Every answer arrives and
   matches ``engine.infer``, and the engine matches an unfused engine on
   the same weights (log-probabilities within 0.05);
10. train Swin-T at full width at batch 128 (the step, optimizer and
   schedule of phase 6): 3 steps with the fused kernel, 12 launches each,
   and one with ``remat``, 24. The first step's loss and grad_norm match an
   unfused state's (loss 5e-3 relative, grad_norm 5e-2); every metric is
   finite and ``bad_step`` 0; 8 steps at constant lr 1e-4 on a fixed batch
   lower the loss;
11. measure: Swin-T per-bucket served latency and its train step (time,
   images/s, MFU), fused and unfused in turns, the ``train/bench.py`` line
   for both, and K2 at the four Swin-T stage shapes at batch 128 against
   its plain version, ``scaled_dot_product_attention`` with the combined
   additive mask (a yardstick only) and its bound;
12. hold the NMS kernel (K3, ``csrc/nms_sweep.cu``: one greedy sweep, a
   CTA an image) against its plain version on the card, exactly (equal
   ``valid``, equal ``idx`` on valid slots): 32 images of N = 8 400
   overlap-heavy boxes (YOLOX-S's candidates at 640²) under the four
   regimes of tests/test_blocked_nms.py (2% NaN scores in the first),
   class-aware with 80 classes at 640² coordinates, tied scores, identical
   boxes (one keep), N = 1, N below and not a multiple of the block,
   max_out > N, N = 20 000, max_out >= n_live over images whose live
   counts differ (NaN and -inf scores), and 12 000 keeps an image (past the
   10 240 kept boxes held in shared memory, with copies only those past it
   suppress); the first images of each also against the greedy oracle;
13. serve YOLOX-S at full width (640², depth 0.33, width 0.5, 80 classes,
   weights from ``--seed``, BatchNorm statistics calibrated on seeded
   images, ``score_thresh`` 0, ``max_det`` 100) through ``InferenceEngine``
   (buckets 1/8/32) and ``MicroBatcher``: 64 requests from 8 threads. The
   K3 counters are zeroed just before and read just after: each kernel once
   a batch dispatched. Every answer has ``max_det`` rows with class -1
   exactly on the invalid ones, and equals ``engine.infer`` of the same
   image at the bucket it was served in (no op mixes images; across buckets
   the top-20 overlap is logged only, since the calibrated random network
   amplifies bf16 rounding differences between cuDNN's per-shape
   algorithms). On one bucket-32 batch the head's raw output goes through
   the postprocess with K3 and with the plain blocked sweep: equal
   detections, at ``max_det`` 100 and over all 8 400 candidates (where the
   alive and suppressed counts must both be > 0);
14. measure: YOLOX-S per-bucket served latency, K3 and plain engines in
   turns, and K3 (the kernel by graph replay, the sweep, the whole call)
   at 32 x 8 400 (the served batch), 1 x 20 000 overlap-heavy boxes and
   its worst case (1 x 20 000 boxes that overlap nowhere, max_out 20 000)
   against the plain version, its bound (greedy's own need) and
   ``torchvision.ops.batched_nms`` where torchvision imports (a yardstick
   only; torch has no NMS call).

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
BWD_SOURCE = "deeplearning_tpu_torch/csrc/flash_attn_bwd.cu"
WIN_SOURCE = "deeplearning_tpu_torch/csrc/window_attn_fwd.cu"
NMS_SOURCE = "deeplearning_tpu_torch/csrc/nms_sweep.cu"
_PALLAS = "deeplearning_tpu/ops/pallas/flash_attention.py"
REPLACES = {"flash_attn_fwd": f"{_PALLAS}:38",
            "flash_attn_fwd_hb": f"{_PALLAS}:166",
            "flash_attn_bwd_dq": f"{_PALLAS}:84",
            "flash_attn_bwd_dkv": f"{_PALLAS}:122",
            "flash_attn_bwd_dq_hb": f"{_PALLAS}:214",
            "flash_attn_bwd_dkv_hb": f"{_PALLAS}:252",
            "window_attn_fwd":
                "deeplearning_tpu/ops/pallas/window_attention.py:43",
            "nms_greedy_sweep": "deeplearning_tpu/ops/pallas/nms.py:45"}
ATTN_FOR = {"flash_attn_fwd_hb": "flash_hb", "flash_attn_fwd": "flash"}
HPC_FOR = {"flash_attn_fwd": 1, "flash_attn_fwd_hb": 4}
LOGP_TOL = 0.05
MODEL = "vit_base_patch16_224"
DEPTH, HEADS, TOKENS, HEAD_DIM = 12, 12, 197, 64
HUGE, HUGE_DEPTH = "vit_huge_patch14_224", 32     # 16 heads of D = 80
SWIN = "swin_tiny_patch4_window7_224"
SWIN_BLOCKS = 12                 # depths 2/2/6/2: one K2 launch a block
# Swin-T's window attention by stage: windows an image, heads, mask windows
SWIN_STAGES = [(64, 3, 64), (16, 6, 16), (4, 12, 4), (1, 24, 0)]
WIN_TOKENS, WIN_HEAD_DIM = 49, 32
YOLOX, YOLOX_SIZE, YOLOX_CLASSES = "yolox_s", 640, 80
YOLOX_ANCHORS = 80 * 80 + 40 * 40 + 20 * 20          # 8 400 candidates
YOLOX_MAX_DET, YOLOX_NMS_TH = 100, 0.65
# (iou_thresh, score_thresh, max_out): tests/test_blocked_nms.py's regimes
NMS_CONFIGS = [(0.5, float("-inf"), 64), (0.3, 0.25, 32), (0.7, 0.5, 16),
               (0.45, 0.05, 100)]


def log(*parts) -> None:
    print(*parts, flush=True)


def phase(n: int, started: float) -> None:
    log(f"--- phase {n} at {time.perf_counter() - started:.1f}s")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    started = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 3
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    from deeplearning_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    # float32 references in full float32 (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")

    # ------------------------------------------------------ 1. build
    phase(1, started)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"total {time.perf_counter() - t0:.2f}s")
    for src in ("flash_attn_fwd", "flash_attn_bwd", "window_attn_fwd",
                "nms_sweep"):
        for line in _ptxas_summary(build.ptxas_report(src) or ""):
            log(f"  ptxas {src}: {line}")

    # ---------------------------------------- 2. kernel vs plain on card
    phase(2, started)
    errs = {name: 0.0 for name in HPC_FOR}
    g = torch.Generator(device=dev).manual_seed(args.seed)
    cases = [(32, 12, 197, 64, False), (8, 4, 49, 32, False),
             (4, 12, 197, 64, True), (8, 12, 1, 64, False),
             (2, 8, 300, 128, False), (2, 4, 17, 16, True),
             (4, 16, 257, 80, False), (2, 16, 257, 80, True),
             (16384, 16, 17, 16, False)]
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
    phase(3, started)
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
    _serve_vit_huge(fa, dev, args.seed)

    # ------------------------------------------------------- 4. measure
    phase(4, started)
    _bucket_latency(engines, ("naive", "flash_hb"), MODEL)

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

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)

    # the kernels' and SDPA's device time: calls replayed from a CUDA graph
    # (an eager loop of B=32 calls measures the host issuing them)
    library_ms, library_call_ms = graph_ms(sdpa), _time_ms(sdpa)
    for name, hpc in HPC_FOR.items():
        def fwd():
            return fa.attention_bnhd(q, k, v, heads_per_cta=hpc)
        ms, call_ms = graph_ms(fwd), _time_ms(fwd)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms})
        log(f"timing {name} B=32 H=12 N=197 D=64 bf16: kernel {ms:.4f} ms "
            f"(graph replay; eager calls {call_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (eager "
            f"{library_call_ms:.4f}), bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
            f"{nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s "
            f"achieved)")

    # ------------------------------- 5. backward kernels vs plain on card
    phase(5, started)
    del engines, lp
    torch.cuda.empty_cache()
    bwd_errs = _check_backward(fa, dev, g)

    # ------------------------------------------- 6. the training path
    phase(6, started)
    train_launches = _train_path(fa, dev, args.seed)

    # ------------------------------------------------------ 7. measure
    phase(7, started)
    _measure_training(dev, args.seed)
    kernels += _time_backward(fa, dev, g, bwd_errs, train_launches)

    # --------------------------------------- 8. K2 vs plain on the card
    phase(8, started)
    from deeplearning_tpu_torch.ops import window_attention as wa
    win_err = _check_window_kernel(wa, dev, g)

    # ------------------------------------------ 9. serve Swin-T (fused)
    phase(9, started)
    win_launches, swin_engines = _serve_swin(wa, dev, args.seed)

    # -------------------------------------------- 10. train Swin-T
    phase(10, started)
    _train_swin(wa, dev, args.seed)

    # ------------------------------------------------------ 11. measure
    phase(11, started)
    _bucket_latency(swin_engines, ("unfused", "fused"), SWIN)
    del swin_engines
    torch.cuda.empty_cache()
    _measure_training(dev, args.seed, SWIN)
    kernels.append(_time_window_kernel(wa, dev, g, win_err, win_launches))

    # ------------------------------------------- 12. K3 vs plain on card
    phase(12, started)
    from deeplearning_tpu_torch.ops import nms as nms_ops
    nms_err = _check_nms_kernels(nms_ops, dev, g)

    # ------------------------------------------------ 13. serve YOLOX-S
    phase(13, started)
    nms_launches, served = _serve_yolox(nms_ops, dev, args.seed)

    # ------------------------------------------------------ 14. measure
    phase(14, started)
    _bucket_latency(served["engines"], ("blocked", "auto"), YOLOX,
                    size=YOLOX_SIZE)
    kernels += _time_nms(nms_ops, dev, g, served, nms_err, nms_launches)
    del served
    torch.cuda.empty_cache()
    log(f"chip_smoke: phases 1-14 in {time.perf_counter() - started:.1f}s")

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


def _bucket_latency(engines, pair, model, size=224) -> None:
    """Per-bucket served latency (one ``engine.run`` ending in a
    synchronise, p50 of 10) of two engines on the same weights, in turns
    (a, b, b, a)."""
    import torch
    images = np.random.default_rng(1).normal(
        size=(32, size, size, 3)).astype(np.float32)
    a, b = pair
    for bucket in engines[a].buckets:
        xb = images[:bucket]
        times = {b: [], a: []}
        for name in (a, b, b, a) * 5:
            eng = engines[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(bucket, xb)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        line = {n: {"latency_ms_p50": round(statistics.median(t), 3),
                    "img_per_s": round(bucket / statistics.median(t) * 1e3,
                                       1)}
                for n, t in times.items()}
        log(f"{model} bucket {bucket}: {json.dumps(line)}")


def _serve_vit_huge(fa, dev, seed) -> None:
    """Phase 3, last: ViT-H/14 (D = 80, which the K1 kernels run
    zero-padded to D = 128) served at bucket 1 through the batcher with
    flash_hb, against engine.infer and a naive-attention engine on the
    same weights."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
    engines = {}
    for attn in ("flash_hb", "naive"):
        t0 = time.perf_counter()
        model, _ = hub.load(HUGE, num_classes=1000, seed=seed, device=dev,
                            attn_fn=get_attn_fn(attn))
        engines[attn] = InferenceEngine(HUGE, model=model, batch_buckets=(1,),
                                        device=dev)
        log(f"engine {HUGE} {attn}: built and warmed in "
            f"{time.perf_counter() - t0:.2f}s; "
            f"{json.dumps(engines[attn].stats())}")
    images = np.random.default_rng(seed + 3).normal(
        size=(4, 224, 224, 3)).astype(np.float32)
    engine, name = engines["flash_hb"], fa.KERNEL_NAMES[4]
    with MicroBatcher(engine, max_wait_ms=5.0) as mb:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [mb.submit(img) for img in images]
        rows = [h.result(timeout=300.0) for h in handles]
        served_ms = (time.perf_counter() - t0) * 1e3
        counts = fa.launch_counts()
        batches = mb.dispatched
    log(f"served {len(rows)}/4 {HUGE} requests via attn=flash_hb at bucket "
        f"1 in {served_ms:.1f} ms: {batches} batches, launches "
        f"{json.dumps(counts)}")
    check(len(rows) == 4, "every answer arrives")
    check(counts[name] == HUGE_DEPTH * batches and batches > 0,
          f"{name} launches == {HUGE_DEPTH} x batches dispatched")
    served = np.stack(rows)
    check(served.shape == (4, 1000) and np.isfinite(served).all(),
          "answers are finite (n, 1000) probabilities")
    single = np.concatenate([engine.infer(img) for img in images])
    _compare(served, single, f"{HUGE}: served vs engine.infer")
    naive = np.concatenate([engines["naive"].infer(img) for img in images])
    _compare(single, naive, f"{HUGE}: flash_hb engine vs naive engine")
    del engines, engine
    torch.cuda.empty_cache()


def _ptxas_summary(report: str) -> list:
    """One line per kernel of a ``ptxas -v`` report: the kernel with its
    template arguments (D, heads per CTA, output type), its registers and
    its spill stores."""
    import re
    out, name, spill = [], None, "?"
    for line in report.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(?:(?:fwd|bwd)_(?:dq_|dkv_)?|win_)"
                             r"(?:bf16_mma|bf16_wgmma|f32_simt)|"
                             r"nms_greedy_sweep_kernel", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            out_t = ",f32" if "EfE" in mangled else (
                ",bf16" if "bfloat16" in mangled else "")
            name = f"{base.group(0) if base else mangled}<{','.join(args)}" \
                   f"{out_t}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {spill} bytes "
                       f"spill stores")
            name, spill = None, "?"
    return out


TRAIN_BATCH = 128
BWD_CASES = [(TRAIN_BATCH, HEADS, TOKENS, HEAD_DIM, False),
             (8, 4, 49, 32, False), (4, 12, 197, 64, True),
             (8, 12, 1, 64, False), (2, 4, 17, 16, True),
             (2, 8, 300, 128, False), (4, 16, 257, 80, False),
             (2, 16, 257, 80, True)]


def _bwd_inputs(fa, dev, g, b, h, n, d, dtype, causal):
    """The training layout: q, k, v strided slices of one fused qkv, dO a
    (B, H, N, D) view of a (B, N, H, D) tensor; O and LSE from the plain
    forward."""
    import torch
    qkv = torch.randn(b, n, 3, h, d, device=dev, generator=g).to(dtype)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    do = torch.randn(b, n, h, d, device=dev, generator=g).to(
        dtype).transpose(1, 2)
    return q, k, v, o, lse, do


def _grad_err(got, want, dtype) -> tuple:
    """(max abs error, pass): bf16 norm-relative 1e-2 with an RMS floor of
    1e-4 (N=1 gradients are 0 up to summation order); float32 max abs
    1e-4."""
    diff = (got.float() - want.float())
    err = diff.abs().max().item()
    if dtype == "float32":
        return err, err <= 1e-4
    floor = 1e-4 * want.numel() ** 0.5
    return err, diff.norm().item() <= 1e-2 * want.float().norm().item() + floor


def _check_backward(fa, dev, g) -> dict:
    """Phase 5: every backward kernel against the plain version. Returns
    the largest max-abs error of each kernel at the training shape in
    bf16 (the kernels line)."""
    import torch
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for b, h, n, d, causal in BWD_CASES:
            q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, b, h, n, d, dtype,
                                              causal)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    causal=causal)
            for hpc in sorted({1, fa._head_block(h, 4)}):
                got = fa._attention_bwd(q, k, v, o, lse, do, sm_scale=None,
                                        causal=causal, heads_per_cta=hpc)
                torch.cuda.synchronize()
                res = [_grad_err(x, w, tag) for x, w in zip(got, want)]
                log(f"kernel-vs-plain bwd hpc={hpc} {tag} B={b} H={h} N={n} "
                    f"D={d} causal={causal}: max_abs_err dq {res[0][0]:.3e} "
                    f"dk {res[1][0]:.3e} dv {res[2][0]:.3e}")
                check(all(ok for _, ok in res) and all(
                    torch.isfinite(x).all().item() for x in got),
                    f"backward hpc={hpc} disagrees with the plain version")
                if (b, n, dtype) == (TRAIN_BATCH, TOKENS, torch.bfloat16):
                    for which, e in (("dq", res[0][0]),
                                     ("dkv", max(res[1][0], res[2][0]))):
                        name = fa.BWD_KERNEL_NAMES[which][hpc]
                        errs[name] = max(errs.get(name, 0.0), e)
            del q, k, v, o, lse, do, want
        # ring attention's chunk backward: global LSE/delta, f32 gradients
        q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, 8, 12, 197, 64, dtype,
                                          False)
        delta = (do.float() * o.float()).sum(-1)
        got = fa.flash_chunk_grads(q, k, v, do, lse, delta)
        want = fa.flash_attention_bwd_reference(q, k, v, None, lse, do,
                                                delta=delta,
                                                out_dtype=torch.float32)
        torch.cuda.synchronize()
        res = [_grad_err(x, w, tag) for x, w in zip(got, want)]
        log(f"kernel-vs-plain flash_chunk_grads {tag} B=8 H=12 N=197 D=64: "
            f"max_abs_err {max(e for e, _ in res):.3e}")
        check(all(x.dtype == torch.float32 for x in got)
              and all(ok for _, ok in res), "flash_chunk_grads disagrees")
    torch.cuda.empty_cache()
    return errs


def _train_state(attn, seed, dev, lr=None, name=MODEL):
    """``name`` (ViT-B/16 or Swin-T) at full width from ``seed`` with the
    bench's optimizer: AdamW wd 0.05 under warmup-cosine (base 1e-3,
    10 000 steps, 100 warmup), or at a constant ``lr``. ``attn`` as the
    CLIs take it: for Swin, "naive" is the unfused window attention and a
    flash name the fused kernel."""
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.schedules import build_schedule
    model, _ = hub.load(name, num_classes=1000, seed=seed, device=dev,
                        **hub.model_kwargs(name, attn))
    sched = (build_schedule("constant", base_lr=lr) if lr is not None else
             build_schedule("warmup_cosine", base_lr=1e-3,
                            total_steps=10_000, warmup_steps=100))
    tx = build_optimizer("adamw", sched, weight_decay=0.05,
                         params=dict(model.named_parameters()))
    return TrainState.create(model=model, tx=tx)


def _train_batch(seed, dev):
    import torch
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(
                size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, 1000, TRAIN_BATCH)).to(dev)}


def _metrics(m) -> dict:
    out = {k: float(v) for k, v in m.items()}
    check(all(np.isfinite(v) for v in out.values()) and out["bad_step"] == 0,
          f"metrics finite and bad_step 0: {out}")
    return out


def _train_path(fa, dev, seed) -> dict:
    """Phase 6: the training main path; returns each backward kernel's
    launches from its route's run."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    batch, key = _train_batch(seed, dev), root_key(seed)
    first, launches = {}, {}
    for attn, hpc, n_steps in (("flash_hb", 4, 3), ("flash", 1, 2)):
        state = _train_state(attn, seed, dev)
        names = [fa.KERNEL_NAMES[hpc], fa.BWD_KERNEL_NAMES["dq"][hpc],
                 fa.BWD_KERNEL_NAMES["dkv"][hpc]]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = []
        for _ in range(n_steps):
            state, m = step(state, batch, key)
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        metrics = [_metrics(m) for m in metrics]
        first[attn] = metrics[0]
        log(f"trained {n_steps} steps via attn={attn} at batch "
            f"{TRAIN_BATCH} in {wall:.2f}s: losses "
            f"{[round(m['loss'], 4) for m in metrics]}, grad_norm "
            f"{metrics[0]['grad_norm']:.4f}, launches {json.dumps(counts)}")
        for name in names:
            check(counts[name] == DEPTH * n_steps,
                  f"{name} launches == {DEPTH} x {n_steps} steps")
            launches[name] = counts[name]
        check(sum(counts.values()) == 3 * DEPTH * n_steps,
              f"attn={attn} launched only its own route's kernels")
        if attn == "flash_hb":
            state.model.remat = True        # one step with checkpointing
            fa.reset_launch_counts()
            state, m = step(state, batch, key)
            torch.cuda.synchronize()
            counts = fa.launch_counts()
            _metrics(m)
            state.model.remat = False
            log(f"remat step via attn=flash_hb: launches {json.dumps(counts)}")
            check(counts[names[0]] == 2 * DEPTH
                  and counts[names[1]] == counts[names[2]] == DEPTH,
                  "remat doubles the forward launches only")
        del state
        torch.cuda.empty_cache()

    state = _train_state("naive", seed, dev)
    state, m = step(state, batch, key)
    first["naive"] = _metrics(m)
    del state
    for attn in ("flash_hb", "flash"):
        a, b = first[attn], first["naive"]
        dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        dn = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
        log(f"first step {attn} vs naive: loss {a['loss']:.5f} vs "
            f"{b['loss']:.5f} (rel {dl:.2e}, tol 5e-3), grad_norm "
            f"{a['grad_norm']:.5f} vs {b['grad_norm']:.5f} (rel {dn:.2e}, "
            f"tol 5e-2)")
        check(dl <= 5e-3 and dn <= 5e-2, f"{attn} first step vs naive")

    state = _train_state("flash_hb", seed, dev, lr=1e-4)
    losses = []
    for _ in range(8):
        state, m = step(state, batch, key)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    log(f"fixed batch, constant lr 1e-4, flash_hb: losses "
        f"{[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "training on a fixed batch lowers the loss")
    del state
    torch.cuda.empty_cache()
    return launches


def _measure_training(dev, seed, name=MODEL) -> None:
    """Phases 7a and 11: step time, images/s and MFU of ``name`` for
    flash_hb (Swin: the fused kernel) and naive in turns (naive, flash_hb,
    flash_hb, naive), then the bench lines."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train import bench, make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    batch, key = _train_batch(seed, dev), root_key(seed)
    states = {a: _train_state(a, seed, dev, name=name)
              for a in ("flash_hb", "naive")}
    step_flops = 3.0 * bench.forward_flops(states["naive"].model,
                                           TRAIN_BATCH, 224)
    times = {a: [] for a in states}
    for attn in ("naive", "flash_hb", "flash_hb", "naive") * 3:
        state = states[attn]
        state, _ = step(state, batch, key)           # untimed warm step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, batch, key)
        torch.cuda.synchronize()
        times[attn].append((time.perf_counter() - t0) / 3)
    for attn, ts in times.items():
        dt = statistics.median(ts)
        log(f"train step {name} {attn} batch {TRAIN_BATCH}: "
            f"{json.dumps({'step_time_ms': round(dt * 1e3, 3), 'images_per_sec': round(TRAIN_BATCH / dt, 1), 'mfu_pct': round(step_flops / dt / bench.PEAK_BF16_FLOPS * 100, 2), 'runs_ms': [round(t * 1e3, 2) for t in ts]})}")
    del states, state
    torch.cuda.empty_cache()
    for attn in ("flash_hb", "naive"):
        log(f"train bench --model {name} --attn {attn}:")
        check(bench.main(["--model", name, "--attn", attn, "--steps", "10",
                          "--seed", str(seed)]) == 0, "train bench runs")
        torch.cuda.empty_cache()


def _time_backward(fa, dev, g, errs, launches) -> list:
    """Phase 7b: each backward kernel alone at the training shape (bf16,
    fused-qkv strides; device time from a CUDA graph's replay; dQ given O,
    so it computes delta and writes it, as the training step runs it), the
    plain backward, the SDPA backward through autograd, and the bound; the
    pair of each heads-per-CTA beside SDPA's backward. Also the forward
    kernels at B=128 beside SDPA's forward."""
    import torch
    b, h, n, d = TRAIN_BATCH, HEADS, TOKENS, HEAD_DIM
    q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, b, h, n, d,
                                      torch.bfloat16, False)
    lse = lse.reshape(b * h, n).contiguous()
    # dK/dV timed alone reads delta: the values the dQ kernel writes
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, n).contiguous()
    grads = [fa._empty_bhnd(q, torch.bfloat16, True) for _ in range(3)]
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse.view(b, h, n), do), iters=10, warmup=2)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters=20, warmup=3)
    rows = []
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    for hpc in (4, 1):
        for which in ("dq", "dkv", None):
            kernels = (which,) if which else ("dq", "dkv")
            names = [fa.BWD_KERNEL_NAMES[w][hpc] for w in kernels]
            before = fa.launch_counts()
            ms = graph_ms(lambda: fa._launch_bwd(
                q, k, v, do, lse, delta, *grads, d ** -0.5, False, hpc,
                kernels=kernels, o=o))
            after = fa.launch_counts()
            check(all(after[x] > before[x] for x in names),
                  f"{names} launched")
            flops = fa.bwd_flops(b, h, n, d, kernel=which)
            nbytes = fa.bwd_min_bytes(b, h, n, d, 2, kernel=which)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
            bound = max(bytes_ms, ops_ms)
            if which is None:       # the pair, beside SDPA's whole backward
                log(f"timing backward pair dq + dkv heads_per_cta={hpc} "
                    f"B={b} H={h} N={n} D={d} bf16: kernels {ms:.4f} ms, "
                    f"sdpa backward {library_ms:.4f} ms "
                    f"({ms / library_ms:.2f}x), plain {plain_ms:.4f} ms, "
                    f"bound {bound:.4f} ms")
                continue
            name = names[0]
            rows.append({
                "name": name, "route": "cuda", "source": BWD_SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms})
            log(f"timing {name} B={b} H={h} N={n} D={d} bf16: kernel "
                f"{ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, sdpa "
                f"backward {library_ms:.4f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
                f"{nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} "
                f"TFLOP/s achieved)")
    qb, kb, vb = (x.transpose(1, 2) for x in (q, k, v))
    fwd_bound = max(fa.min_bytes(b, h, n, d, 2) / HBM_BYTES_PER_S,
                    fa.flops(b, h, n, d) / PEAK_FLOPS["bfloat16"]) * 1e3
    sdpa_ms = graph_ms(lambda: torch.nn.functional.
                       scaled_dot_product_attention(q, k, v))
    for name, hpc in HPC_FOR.items():
        ms = graph_ms(lambda: fa.attention_bnhd(qb, kb, vb,
                                                heads_per_cta=hpc))
        log(f"timing {name} B={b} H={h} N={n} D={d} bf16: kernel {ms:.4f} "
            f"ms (graph replay), sdpa {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x), "
            f"bound {fwd_bound:.4f} ms")
    return rows


WIN_CASES = [  # BW, N, heads, d, nW (0: no mask), windows_per_block, diag
    *((32 * w, WIN_TOKENS, h, WIN_HEAD_DIM, nw, 8, False)
      for w, h, nw in SWIN_STAGES),             # Swin-T at batch 32
    (24, 9, 4, 32, 4, 8, False), (16, 16, 4, 32, 4, 8, False),
    (64, 49, 4, 16, 4, 8, False), (64, 49, 2, 64, 16, 8, False),
    (36, 49, 3, 32, 6, 4, False),               # nW not a multiple of wb
    (16, 49, 3, 32, 8, 8, True)]                # whole rows masked


def _window_inputs(dev, g, bw, n, heads, d, dtype, nw, diag=False):
    """qkv as the model hands it over (a view of one (BW, N, 3C)
    projection), a bias (heads, N, N), and a shift mask over nW windows of
    the squarest grid (None for nW = 0; ``diag``: rows of -1e9 but the
    diagonal)."""
    import torch
    from deeplearning_tpu_torch.ops.window_utils import shift_window_mask
    qkv = torch.randn(bw, n, 3 * heads * d, device=dev, generator=g).to(
        dtype).view(bw, n, 3, heads, d)
    bias = torch.randn(heads, n, n, device=dev, generator=g)
    mask = None
    if nw and diag:
        mask = torch.full((nw, n, n), -1e9, device=dev)
        mask[:, torch.arange(n), torch.arange(n)] = 0.0
    elif nw:
        side = int(round(n ** 0.5))
        rows = max(r for r in range(1, nw + 1) if nw % r == 0 and r * r <= nw)
        mask = torch.from_numpy(shift_window_mask(
            rows * side, nw // rows * side, side, side // 2)).to(dev)
    return qkv, bias, mask


def _check_window_kernel(wa, dev, g) -> float:
    """Phase 8: K2 against its plain version. Returns the largest max-abs
    error at the four Swin-T stage shapes in bf16 (the kernels line)."""
    import torch
    err_main = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for i, (bw, n, heads, d, nw, wb, diag) in enumerate(WIN_CASES):
            qkv, bias, mask = _window_inputs(dev, g, bw, n, heads, d, dtype,
                                             nw, diag)
            out = wa.window_attention(qkv, bias, mask, windows_per_block=wb)
            ref = wa.window_attention_plain(qkv, bias, mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            log(f"kernel-vs-plain window_attn_fwd {str(dtype)[6:]} BW={bw} "
                f"N={n} heads={heads} d={d} nW={nw} wb={wb} diag={diag}: "
                f"max_abs_err {err:.3e} (tol {tol})")
            check(out.shape == (bw, n, heads * d) and out.dtype == dtype
                  and err <= tol, "window_attn_fwd disagrees with the plain "
                                  "version")
            if dtype == torch.bfloat16 and i < len(SWIN_STAGES):
                err_main = max(err_main, err)
    return err_main


def _serve_swin(wa, dev, seed):
    """Phase 9: Swin-T served through the batcher with the fused kernel.
    Returns K2's launches and the fused and unfused engines."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
    engines = {}
    for name, use_pallas in (("fused", True), ("unfused", False)):
        t0 = time.perf_counter()
        model, _ = hub.load(SWIN, num_classes=1000, seed=seed, device=dev,
                            use_pallas=use_pallas)
        engines[name] = InferenceEngine(SWIN, model=model,
                                        batch_buckets=(1, 8, 32), device=dev)
        log(f"engine {SWIN} {name}: built and warmed in "
            f"{time.perf_counter() - t0:.2f}s; "
            f"{json.dumps(engines[name].stats())}")
    ref_state = engines["unfused"].model.state_dict()
    state = engines["fused"].model.state_dict()
    check(set(state) == set(ref_state) and all(
        torch.equal(state[k], ref_state[k]) for k in ref_state),
        "fused and unfused Swin-T engines share their weights")

    images = np.random.default_rng(seed + 1).normal(
        size=(64, 224, 224, 3)).astype(np.float32)
    engine = engines["fused"]
    with MicroBatcher(engine, max_wait_ms=5.0) as mb:
        wa.reset_launch_counts()
        t0 = time.perf_counter()

        def client(part):
            handles = [mb.submit(img) for img in part]
            return [h.result(timeout=120.0) for h in handles]

        with ThreadPoolExecutor(8) as pool:
            rows = [r for part in pool.map(client, np.array_split(images, 8))
                    for r in part]
        served_ms = (time.perf_counter() - t0) * 1e3
        launches = wa.launch_counts()[wa.KERNEL_NAME]
        batches = mb.dispatched
    log(f"served {len(rows)}/64 {SWIN} requests (fused) in {served_ms:.1f} "
        f"ms ({64 / served_ms * 1e3:.1f} img/s): {batches} batches, "
        f"window_attn_fwd launches {launches}")
    check(len(rows) == 64, "every answer arrives")
    check(launches == SWIN_BLOCKS * batches and launches > 0,
          f"window_attn_fwd launches == {SWIN_BLOCKS} x batches dispatched")
    served = np.stack(rows)
    check(served.shape == (64, 1000) and np.isfinite(served).all(),
          "answers are finite (n, 1000) probabilities")
    single = np.concatenate([engine.infer(img) for img in images])
    _compare(served, single, "Swin-T served vs engine.infer")
    x = images[:32]
    _compare(engine.infer(x), engines["unfused"].infer(x),
             "Swin-T fused engine vs unfused engine")
    return launches, engines


def _train_swin(wa, dev, seed) -> None:
    """Phase 10: the Swin-T training path through the fused kernel."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    batch, key = _train_batch(seed, dev), root_key(seed)
    state = _train_state("flash_hb", seed, dev, name=SWIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, counts = [], []
    for remat in (False, False, False, True):
        state.model.remat = remat
        wa.reset_launch_counts()
        state, m = step(state, batch, key)
        counts.append(wa.launch_counts()[wa.KERNEL_NAME])
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = [_metrics(m) for m in metrics]
    log(f"trained {SWIN} 3 steps + 1 remat step (fused) at batch "
        f"{TRAIN_BATCH} in {wall:.2f}s: losses "
        f"{[round(m['loss'], 4) for m in metrics]}, grad_norm "
        f"{metrics[0]['grad_norm']:.4f}, window_attn_fwd launches a step "
        f"{counts}")
    check(counts == [SWIN_BLOCKS] * 3 + [2 * SWIN_BLOCKS],
          f"{SWIN_BLOCKS} launches a step, {2 * SWIN_BLOCKS} with remat")
    del state
    torch.cuda.empty_cache()

    state = _train_state("naive", seed, dev, name=SWIN)
    wa.reset_launch_counts()
    state, m = step(state, batch, key)
    ref = _metrics(m)
    check(wa.launch_counts()[wa.KERNEL_NAME] == 0,
          "the unfused step launches no window_attn_fwd")
    del state
    a = metrics[0]
    dl = abs(a["loss"] - ref["loss"]) / abs(ref["loss"])
    dn = abs(a["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    log(f"first {SWIN} step fused vs unfused: loss {a['loss']:.5f} vs "
        f"{ref['loss']:.5f} (rel {dl:.2e}, tol 5e-3), grad_norm "
        f"{a['grad_norm']:.5f} vs {ref['grad_norm']:.5f} (rel {dn:.2e}, tol "
        f"5e-2)")
    check(dl <= 5e-3 and dn <= 5e-2, "fused first step vs unfused")

    state = _train_state("flash_hb", seed, dev, lr=1e-4, name=SWIN)
    losses = []
    for _ in range(8):
        state, m = step(state, batch, key)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    log(f"{SWIN} fixed batch, constant lr 1e-4, fused: losses "
        f"{[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "training Swin-T on a fixed batch lowers the loss")
    del state
    torch.cuda.empty_cache()


def _time_window_kernel(wa, dev, g, err, launches) -> dict:
    """Phase 11c: K2 at the four Swin-T stage shapes at the training batch
    (bf16, masks as the shifted blocks have them), against the plain
    version, SDPA with the combined additive mask (a yardstick) and the
    bound. Returns the kernels-line entry, at stage 1."""
    import torch
    import torch.nn.functional as F
    entry = None
    for stage, (wins, heads, nw) in enumerate(SWIN_STAGES, 1):
        bw, n, d = TRAIN_BATCH * wins, WIN_TOKENS, WIN_HEAD_DIM
        qkv, bias, mask = _window_inputs(dev, g, bw, n, heads, d,
                                         torch.bfloat16, nw)
        ms = _time_ms(lambda: wa.window_attention(qkv, bias, mask))
        plain_ms = _time_ms(lambda: wa.window_attention_plain(qkv, bias,
                                                               mask),
                            iters=10, warmup=2)
        # SDPA over (B, nW, heads, N, d) views with a (nW, heads, N, N) mask
        q, k, v = (x.transpose(1, 2).unflatten(0, (TRAIN_BATCH, wins))
                   for x in qkv.unbind(2))
        comb = bias[None] if mask is None else bias[None] + mask[:, None]
        comb = comb.to(torch.bfloat16)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=comb))
        nbytes = wa.min_bytes(bw, n, heads, d, 2, nw)
        flops = wa.flops(bw, n, heads, d)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"timing window_attn_fwd stage {stage} BW={bw} N={n} "
            f"heads={heads} d={d} nW={nw} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} "
            f"GFLOP; {nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} "
            f"TFLOP/s achieved)")
        if entry is None:
            entry = {"name": wa.KERNEL_NAME, "route": "cuda",
                     "source": WIN_SOURCE,
                     "replaces": REPLACES[wa.KERNEL_NAME],
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "library_ms": library_ms}
        del qkv, bias, mask, q, k, v, comb
    torch.cuda.empty_cache()
    return entry


def _nms_boxes(dev, g, cases, n, span=64.0, wh_max=24.0, nan_frac=0.0):
    """Overlap-heavy boxes (cases, n, 4) and scores (cases, n): the
    ``make_cases`` recipe of tests/test_blocked_nms.py, made on the card."""
    import torch
    ctr = torch.rand(cases, n, 2, device=dev, generator=g) * span
    wh = 2.0 + torch.rand(cases, n, 2, device=dev, generator=g) * (
        wh_max - 2.0)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.rand(cases, n, device=dev, generator=g)
    if nan_frac:
        nan = torch.rand(cases, n, device=dev, generator=g) < nan_frac
        scores = torch.where(nan, torch.full_like(scores, float("nan")),
                             scores)
    return boxes, scores


def _keep_mismatches(ref, got) -> int:
    """Slots where two (idx, valid) results differ: valid, or idx on a
    valid slot. 0 is the contract."""
    (i1, v1), (i2, v2) = ref, got
    return int((v1 != v2).sum()) + int(((i1 != i2) & v1 & v2).sum())


def _check_nms_kernels(nms_ops, dev, g) -> int:
    """Phase 12: K3 against its plain version (and the greedy oracle on the
    first images of each case), exactly. Returns the mismatching slots over
    every case (0, or the run has failed)."""
    import torch
    from deeplearning_tpu_torch.ops.nms_bench import past_shared_memory
    inf = float("inf")
    cases = []      # name, boxes, scores, classes, th, st, max_out, greedy
    for ci, (th, st, mo) in enumerate(NMS_CONFIGS):
        b, s = _nms_boxes(dev, g, 32, YOLOX_ANCHORS,
                          nan_frac=0.02 if ci == 0 else 0.0)
        cases.append((f"regime {ci}", b, s, None, th, st, mo, 2))
    b, s = _nms_boxes(dev, g, 32, YOLOX_ANCHORS, span=640.0, wh_max=160.0)
    cls = torch.randint(0, YOLOX_CLASSES, (32, YOLOX_ANCHORS), device=dev,
                        generator=g)
    cases.append(("80 classes at 640²", b, s, cls, YOLOX_NMS_TH, 0.0,
                  YOLOX_MAX_DET, 2))
    b, s = _nms_boxes(dev, g, 32, YOLOX_ANCHORS)
    cases.append(("tied scores (16 levels)", b, (s * 16).floor() / 16, None,
                  0.5, -inf, 100, 2))
    b = torch.tensor([10., 10., 20., 20.], device=dev).expand(
        4, 500, 4).contiguous()
    cases.append(("identical boxes", b, torch.rand(4, 500, device=dev,
                                                   generator=g),
                  None, 0.5, -inf, 10, 4))
    for n, mo in ((1, 5), (7, 32), (1000, 64), (130, 200)):
        b, s = _nms_boxes(dev, g, 8, n, span=80.0)
        cases.append((f"N={n} max_out={mo}", b, s, None, 0.5, -inf, mo, 8))
    b, s = _nms_boxes(dev, g, 1, 20_000)
    cases.append(("N=20000", b, s, None, 0.5, -inf, 100, 1))
    # max_out >= n_live, and each image's live count another (a per-image
    # score cut; -inf and NaN scores among them)
    b, s = _nms_boxes(dev, g, 8, 3000, span=400.0, wh_max=12.0,
                      nan_frac=0.01)
    s[1, :50] = -inf
    cut = torch.linspace(0.0, 0.9, 8, device=dev)[:, None]
    s = torch.where(s < cut, torch.full_like(s, -inf), s)  # NaN stays NaN
    cases.append(("max_out >= n_live, live counts differ", b, s, None, 0.5,
                  -inf, 3000, 2))
    # 12 000 keeps an image, past the kept boxes shared memory holds, and
    # copies that only those past it suppress
    b, s = past_shared_memory(g, 2)
    cases.append(("kept list past shared memory", b, s, None, 0.5, -inf,
                  b.shape[1], 1))

    total = 0
    for name, b, s, cls, th, st, mo, n_greedy in cases:
        def call(impl, b=b, s=s, cls=cls):
            if cls is None:
                return nms_ops.nms(b, s, th, mo, st, impl=impl)
            return nms_ops.batched_nms(b, s, cls, th, mo, st, impl=impl)
        got = call("auto")
        bad = _keep_mismatches(call("blocked"), got)
        k = n_greedy
        greedy = call("greedy", b[:k], s[:k],
                      None if cls is None else cls[:k])
        bad_greedy = _keep_mismatches(greedy, tuple(x[:k] for x in got))
        torch.cuda.synchronize()
        kept = got[1].sum(dim=1)
        live = (s > st).sum(dim=1)
        log(f"kernel-vs-plain nms {name}: B={b.shape[0]} N={b.shape[1]} "
            f"th={th} score>{st} max_out={mo}: alive {int(live.sum())} "
            f"(per image {int(live.min())}-{int(live.max())}), kept "
            f"{int(kept.sum())} (per image {int(kept.min())}-"
            f"{int(kept.max())}), mismatching slots vs blocked {bad}, vs "
            f"greedy on {k} images {bad_greedy}")
        check(bad == 0 and bad_greedy == 0,
              f"nms kernel disagrees with the plain version ({name})")
        if name == "identical boxes":
            check(bool((kept == 1).all()), "identical boxes keep one")
        if name == "kept list past shared memory":
            check(bool((kept == 12_000).all()), "12 000 keeps an image")
        total += bad + bad_greedy
        del b, s, got, greedy
    torch.cuda.empty_cache()
    return total


def _yolox_counts(nms_ops, raw, centers, strides, max_det):
    """The served postprocess through K3 and through the plain blocked sweep
    on one raw head output; returns (alive, kept) after checking the two
    equal."""
    import torch
    from deeplearning_tpu_torch.models.detection.yolox import (
        decode_outputs, yolox_postprocess)
    dets = {impl: yolox_postprocess(raw, centers, strides, score_thresh=0.0,
                                    max_det=max_det, nms_impl=impl)
            for impl in ("auto", "blocked")}
    torch.cuda.synchronize()
    check(all(torch.equal(dets["auto"][k], dets["blocked"][k])
              for k in dets["auto"]),
          f"YOLOX detections through K3 == through the plain sweep "
          f"(max_det {max_det})")
    dec = decode_outputs(raw, centers, strides)
    score = (torch.sigmoid(dec[..., 4:5]) * torch.sigmoid(dec[..., 5:])
             ).amax(dim=-1)
    return int((score > 0.0).sum()), int(dets["auto"]["valid"].sum())


def _serve_yolox(nms_ops, dev, seed):
    """Phase 13: YOLOX-S served through the batcher with K3. Returns K3's
    launches and what phase 14 measures on."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.models.detection.yolox import (
        calibrate_batchnorm, yolox_grid)
    from deeplearning_tpu_torch.ops.boxes import box_iou
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
    t0 = time.perf_counter()
    model, _ = hub.load(YOLOX, num_classes=YOLOX_CLASSES, seed=seed,
                        device=dev)
    rng = np.random.default_rng(seed + 2)
    calibrate_batchnorm(model, torch.from_numpy(rng.normal(size=(
        8, YOLOX_SIZE, YOLOX_SIZE, 3)).astype(np.float32)).to(dev))
    engines = {impl: InferenceEngine(
        YOLOX, model=model, num_classes=YOLOX_CLASSES,
        image_size=YOLOX_SIZE, batch_buckets=(1, 8, 32), device=dev,
        score_thresh=0.0, max_det=YOLOX_MAX_DET, nms_impl=impl)
        for impl in ("auto", "blocked")}
    log(f"engine {YOLOX} (K3 and plain): built, calibrated and warmed in "
        f"{time.perf_counter() - t0:.2f}s; "
        f"{json.dumps(engines['auto'].stats())}")

    images = rng.normal(size=(64, YOLOX_SIZE, YOLOX_SIZE, 3)).astype(
        np.float32)
    engine = engines["auto"]
    with MicroBatcher(engine, max_wait_ms=5.0) as mb:
        torch.cuda.synchronize()
        nms_ops.reset_launch_counts()
        t0 = time.perf_counter()

        def client(part):
            handles = [mb.submit(img) for img in part]
            return [h.result(timeout=120.0) for h in handles]

        with ThreadPoolExecutor(8) as pool:
            rows = [r for part in pool.map(client, np.array_split(images, 8))
                    for r in part]
        served_ms = (time.perf_counter() - t0) * 1e3
        counts = nms_ops.launch_counts()
        batches = mb.dispatched
    log(f"served {len(rows)}/64 {YOLOX} requests through K3 in "
        f"{served_ms:.1f} ms ({64 / served_ms * 1e3:.1f} img/s): {batches} "
        f"batches, launches {json.dumps(counts)}")
    check(len(rows) == 64, "every answer arrives")
    check(batches > 0 and all(counts[k] == batches
                              for k in nms_ops.KERNEL_NAMES),
          "K3 launches once a batch dispatched")
    for row in rows:
        check(row["boxes"].shape == (YOLOX_MAX_DET, 4)
              and row["valid"].shape == (YOLOX_MAX_DET,)
              and np.isfinite(row["boxes"]).all()
              and bool(((row["labels"] == -1) == ~row["valid"]).all()),
              "max_det rows an answer, class -1 exactly on invalid rows")
    # served vs engine.infer of the same image at the bucket it was served
    # in: exact, since no op of the forward or of K3 mixes images. A batch
    # may have gone out in any bucket, so each answer is held against the
    # engine's answer at each bucket and must equal one. Across buckets the
    # answers differ: the calibrated random network amplifies the bf16
    # rounding differences of cuDNN's per-shape algorithms through its ~70
    # layers (a 1e-3 input change moves its raw outputs by up to ~3 on the
    # CPU), so the top-20 overlap with bucket 1 is logged, not gated.
    refs = {}
    for bucket in engine.buckets:
        parts = [engine.infer(images[i:i + bucket])
                 for i in range(0, len(images), bucket)]
        refs[bucket] = {k: np.concatenate([p[k] for p in parts])
                        for k in parts[0]}
    equal_at = []
    for i, row in enumerate(rows):
        hit = [b for b, ref in refs.items()
               if all(np.array_equal(row[k], ref[k][i]) for k in row)]
        equal_at.append(hit[0] if hit else None)
    log(f"{YOLOX} served vs engine.infer of the same image: equal at bucket "
        f"{json.dumps({str(b): equal_at.count(b) for b in engine.buckets})}"
        f", equal at none {equal_at.count(None)}")
    check(None not in equal_at, "every served answer == engine.infer")
    matched = total = 0
    for i, row in enumerate(rows):
        one = {k: v[i] for k, v in refs[1].items()}
        top = min(20, int(row["valid"].sum()))
        ref_n = int(one["valid"].sum())
        iou = box_iou(torch.from_numpy(row["boxes"][:top]),
                      torch.from_numpy(one["boxes"][:ref_n])).numpy()
        ok = (iou >= 0.9) & (row["labels"][:top, None]
                             == one["labels"][None, :ref_n])
        matched += int(ok.any(axis=1).sum())
        total += top
    log(f"{YOLOX} served vs bucket 1, for information: {matched}/{total} "
        f"top-20 rows with a same-label box at IoU >= 0.9")

    # one served bucket-32 batch: K3 and the plain sweep on one raw output
    x = torch.from_numpy(images[:32]).to(dev)
    centers, strides = (torch.from_numpy(a).to(dev)
                        for a in yolox_grid((YOLOX_SIZE, YOLOX_SIZE)))
    with torch.no_grad():
        raw = model(x)
    alive, kept = _yolox_counts(nms_ops, raw, centers, strides,
                                YOLOX_MAX_DET)
    log(f"{YOLOX} bucket-32 batch, max_det {YOLOX_MAX_DET}: K3 == plain; "
        f"alive {alive}, kept {kept}")
    alive_all, kept_all = _yolox_counts(nms_ops, raw, centers, strides,
                                        YOLOX_ANCHORS)
    log(f"{YOLOX} bucket-32 batch, every candidate ({YOLOX_ANCHORS} slots): "
        f"K3 == plain; alive {alive_all}, kept {kept_all}, suppressed "
        f"{alive_all - kept_all}")
    check(alive > 0 and alive_all - kept_all > 0,
          "candidates were alive and suppressed in the checked batch")
    return counts, {"engines": engines, "raw": raw, "centers": centers,
                    "strides": strides}


def _time_nms(nms_ops, dev, g, served, err, launches) -> list:
    """Phase 14b: K3 at YOLOX-S's served batch (32 x 8 400, its class-offset
    boxes), at 1 x 20 000 overlap-heavy boxes and in its worst case (1 x
    20 000 boxes that overlap nowhere, max_out 20 000: every candidate
    kept, each tested against every box kept before it): the kernel alone
    (a CUDA graph's replay), the sweep and the whole call against the
    plain version, the bound (greedy's own need) and torchvision's
    batched_nms where it imports. Returns the kernels-line entry (at the
    served batch)."""
    import torch
    from deeplearning_tpu_torch.models.detection.yolox import decode_outputs
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    from deeplearning_tpu_torch.ops.nms_bench import disjoint_boxes
    try:
        import torchvision
        tv_nms = torchvision.ops.batched_nms
        log(f"torchvision {torchvision.__version__}: batched_nms is timed "
            f"as a yardstick only")
    except Exception as exc:  # noqa: BLE001 - a yardstick, not a phase
        tv_nms = None
        log(f"torchvision does not import ({type(exc).__name__}: {exc}); "
            f"torch itself has no NMS call, so library_ms is null")
    dec = decode_outputs(served["raw"], served["centers"], served["strides"])
    score_all = torch.sigmoid(dec[..., 4:5]) * torch.sigmoid(dec[..., 5:])
    best, label = score_all.amax(dim=-1), score_all.argmax(dim=-1)
    inf = float("inf")
    workloads = [
        ("YOLOX-S served batch", nms_ops.class_offset_boxes(dec[..., :4],
                                                             label),
         best, 0.0, YOLOX_NMS_TH, YOLOX_MAX_DET, label),
        ("overlap-heavy", *_nms_boxes(dev, g, 1, 20_000), -inf, 0.5, 100,
         None),
        ("worst case, no overlaps", disjoint_boxes(g, 1, 20_000),
         torch.rand(1, 20_000, device=dev, generator=g), -inf, 0.5, 20_000,
         None)]
    lib = nms_ops._lib()
    entries = []
    for name, boxes, scores, st, th, mo, classes in workloads:
        b, n = scores.shape
        worst = mo >= n
        sboxes, alive0, order, _ = nms_ops.sort_pad_candidates(
            boxes, scores, st, nms_ops.WORD)
        npad = sboxes.shape[1]
        n_live = nms_ops.live_counts(alive0)
        live_t = torch.tensor(n_live, dtype=torch.int32, device=dev)
        out = torch.empty((b, npad), dtype=torch.bool, device=dev)
        cap = max(0, min(mo, npad) - nms_ops.KEPT_SMEM)
        spill = torch.empty((b, max(cap, 1), 4), device=dev)
        th32 = float(torch.tensor(th, dtype=torch.float32))
        rc = [0]

        def kernel_call():
            rc[0] |= lib.nms_greedy_sweep(
                sboxes.data_ptr(), alive0.data_ptr(), live_t.data_ptr(),
                spill.data_ptr(), out.data_ptr(), b, npad, cap, mo, th32,
                torch.cuda.current_stream().cuda_stream)
        reps = dict(calls=2, replays=3) if worst else {}
        iters = dict(iters=3, warmup=1) if worst else {}
        ms = {"kernel": graph_ms(kernel_call, **reps),
              "sweep": _time_ms(lambda: nms_ops.nms_sweep(sboxes, alive0,
                                                          th, mo), **iters),
              "call": _time_ms(lambda: nms_ops.nms(boxes, scores, th, mo, st,
                                                   impl="auto"), **iters)}
        check(rc[0] == 0, "the timed K3 launches succeeded")
        plain_ms = _time_ms(lambda: nms_ops.nms_sweep_plain(
            sboxes, alive0, th, mo, nms_ops.WORD), iters=2, warmup=1)
        plain_call_ms = _time_ms(lambda: nms_ops.nms(
            boxes, scores, th, mo, st, impl="blocked"), iters=2, warmup=1)
        library_ms = None
        if tv_nms is not None:
            flat = boxes.reshape(-1, 4)
            idxs = torch.arange(b, device=dev).repeat_interleave(n)
            if classes is not None:
                # per image and class, on the un-offset boxes
                flat = dec[..., :4].reshape(-1, 4)
                idxs = idxs * YOLOX_CLASSES + classes.reshape(-1)
            library_ms = _time_ms(lambda: tv_nms(flat, scores.reshape(-1),
                                                 idxs, th), iters=5,
                                  warmup=1)
        alive = nms_ops.nms_sweep(sboxes, alive0, th, mo)
        torch.cuda.synchronize()
        check(torch.equal(out, alive), "the timed kernel's keeps == the "
                                       "sweep's")
        ious = nms_ops.greedy_ious(alive, alive0, mo)
        nbytes = nms_ops.sweep_bytes(alive, alive0, mo)
        call_bytes = b * n * 20 + b * mo * 9      # boxes + scores, idx + valid
        bound = {
            "nms_greedy_sweep": (nbytes / HBM_BYTES_PER_S * 1e3,
                                 ious * nms_ops.OPS_PER_IOU
                                 / PEAK_FLOPS["float32"] * 1e3),
            "call": (call_bytes / HBM_BYTES_PER_S * 1e3,
                     ious * nms_ops.OPS_PER_IOU
                     / PEAK_FLOPS["float32"] * 1e3)}
        lib_txt = "null" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"timing nms {name} B={b} N={n} (Npad {npad}, live "
            f"{min(n_live)}-{max(n_live)}) th={th} max_out={mo}: "
            f"nms_greedy_sweep {ms['kernel']:.4f} ms (graph replay), sweep "
            f"{ms['sweep']:.4f} ms, whole call {ms['call']:.4f} ms; plain "
            f"sweep {plain_ms:.4f} ms, plain call {plain_call_ms:.4f} ms; "
            f"torchvision batched_nms {lib_txt}; kept {int(alive.sum())}, "
            f"greedy IoUs {ious}")
        for key, (bytes_ms, ops_ms) in bound.items():
            log(f"  bound {key}: {max(bytes_ms, ops_ms):.5f} ms (bytes "
                f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms: "
                f"{'bytes' if bytes_ms >= ops_ms else 'operations'})")
        if not entries:                   # the kernels line: served batch
            bytes_ms, ops_ms = bound["nms_greedy_sweep"]
            entries.append({
                "name": "nms_greedy_sweep", "route": "cuda",
                "source": NMS_SOURCE,
                "replaces": REPLACES["nms_greedy_sweep"],
                "launches": launches["nms_greedy_sweep"],
                "max_abs_err": float(err), "ms": ms["kernel"],
                "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms})
        del out, alive, spill
    torch.cuda.empty_cache()
    return entries


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
