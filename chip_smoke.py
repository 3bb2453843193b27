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
   kernel; plain and causal), D=256 (N=257: two column blocks a row
   block) and D=160 (N=65, causal, zero-padded to D=256), B*H =
   262 144 (N=17, D=16: 65 536 head groups at four heads per CTA, past the
   65 535 of a grid's y), and past the tensor-core kernels, on the wide
   SIMT kernel: D=320 (N=65), D=300 (N=257, causal, zero-padded to 320)
   and D=512 (N=129);
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
   causal, N=1, D=16, D=128, D=80 (N=257, plain and causal), D=256
   (N=257), D=160 (N=65, causal), and the wide SIMT kernels' D=320
   (N=65), D=300 (N=257, causal) and D=512 (N=129), bf16 (where the dQ
   kernel computes
   delta from O) and float32, q/k/v as strided
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
   unmasked), N = 9 and 16, d = 16, 64 and 128, d = 24 (zero-padded to
   32), N = 144 (window 12: two 64-row tiles, two passes over the keys) at
   d = 24 and d = 128, nW not a multiple of ``windows_per_block``, a
   number of images that is not a multiple of it (nW = 64), a mask of
   whole rows of -1e9 but the diagonal, and past the tensor-core kernel,
   on the wide SIMT kernel: d = 160 and 256 at N = 49 and N = 144; then
   the wide kernels' device times (graph replay, bf16): K1 forward and
   backward at B=8, H=12, N=197, D=320, and K2 at Swin-T stage 1's
   windows of batch 8 with d = 160, beside the plain versions and bounds;
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
   for both, and K2 at the four Swin-T stage shapes at batch 128 (masked
   as Swin-T's shifted blocks are) against its plain version,
   ``scaled_dot_product_attention`` with the combined additive mask (a
   yardstick only) and its bound, all three by CUDA-graph replay;
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
   only; torch has no NMS call);
15. hold K3 against its plain version and the greedy oracle, exactly, at
   the candidate sets of the other detectors: 32 x 25 200 class-aware (80
   classes at 640², YOLOv5-S's candidates), Faster R-CNN's RPN (8 x 4 507,
   IoU 0.7, 256 kept, score floor -1e8) and its box stage (8 x 5 120, 20
   classes, a tenth of the rows padded with -inf);
16. serve at full width and depth, weights a flax tree drawn from
   ``--seed`` with nonzero scales, carried in by the converter, and
   BatchNorm statistics calibrated on seeded images: Faster R-CNN R50-FPN at 800² (20 classes plus background,
   ``post_nms_top_n`` 256, score 0.05, buckets 1/8; two K3 launches a
   batch, proposals and detections), RetinaNet R50-FPN and FCOS R50-FPN
   at 512² (20 classes) and YOLOv5-S at 640² (80 classes), each of those
   at bucket 8 and score 0, one K3 launch a batch. Each through
   ``MicroBatcher``: 16 requests from 8 threads, the K3 counter zeroed just
   before and read just after; every answer ``max_det`` (100) rows with
   class -1 exactly on the invalid ones and equal to ``engine.infer`` of
   the same image at the bucket it was served in; on one batch of the
   largest bucket, the proposals and detections through K3 equal those
   through the plain blocked sweep on one forward;
17. measure: each detector's per-bucket served latency, K3 and plain
   engines in turns, and K3 at each candidate set one batch of it served
   (recorded from the NMS calls: the kernel by graph replay, the whole
   call, the plain sweep and call) beside its bound;
18. the feed: ``DevicePrefetcher(depth=2)`` over a ``DataLoader`` of 224²
   uint8 images made float32 per sample, two epochs of 4 batches of 128
   consumed under ``torch.cuda.set_sync_debug_mode("error")`` with the
   main stream kept busy: every batch of epoch 0 bit-equal to its host
   batch, every batch of epoch 1 (dropped after an exact digest, so the
   allocator may reuse it) intact; a fetch that raises reaches the
   consumer with its traceback; ``stats()`` printed;
19. ViT-B/16 trained through the port's ``Trainer``, built by the train
   CLI's ``build`` (phases 6-7's set-up: 224², batch 128, flash_hb, AdamW
   wd 0.05 under warmup-cosine, label smoothing 0.1; the CLI's synthetic
   data): 2 epochs of 4 steps, then one eval. K1 counted from zero just
   before ``train()``: 12 forward launches a forward (8 steps + 4 eval
   batches), 12 dQ and 12 dK/dV a step; every loss the Trainer logged
   equal to a hand loop of ``make_train_step`` over the same loader's
   batches (max difference printed; tolerance ``TRAINER_LOSS_TOL``);
   every step under ``set_sync_debug_mode("error")``, lifted only inside
   the lagged metric fetches;
20. resume: a run stopped after epoch 1 (its checkpoint written) and
   resumed ends with parameters bit-equal to phase 19's; a flipped byte
   in the newest step makes the restore fall back to the step before;
21. measure: the Trainer's step with the feed on (prefetch 2) and off
   (prefetch 0), in turns, over 16-step epochs: the steady step (CUDA
   events around steps 4-15), the epoch overhead, images/s, data-wait
   share, kernel time a step (profiled epoch), idle share,
   ``throughput()``, beside phase 7's bare step;
22. Swin-T (full width and depth, 224², batch 128, random weights from
   the seed) trained through the Trainer built by the train CLI's
   ``build`` with ``model.attn=flash_hb`` (the fused K2) and
   ``train.strict=transfers``, prefetch 2: 2 epochs of 4 steps and one
   eval. K2 counted from zero just before ``train()``: 12 launches a
   forward (8 steps + 4 eval batches); one strict section a step and no
   sync outside the lagged fetches; the losses equal a hand loop of the
   step over the same batches (``TRAINER_LOSS_TOL``); a deliberate
   ``.item()`` inside a strict section raises; peak device memory;
23. rollback: ``DLTPU_FAULTS=nan@step:6``, ``train.recovery=rollback``
   with ``RecoveryPolicy(anchor_every=2)``: one rollback, a skipped window
   ``[anchor, bad]`` with anchor < 6 <= bad <= 6 + metrics_lag +
   log_every, a finished run with a finite last loss, ``flightrec.json``
   'recovered', the peak device memory beside phase 22's;
24. preemption: with ``DLTPU_HEARTBEAT`` set, a SIGTERM sent to the
   process at step 5 raises ``Preempted`` at that step's boundary, the
   checkpoint of step 5 verifies by CRC, ``flightrec.json`` says
   'preempted', the heartbeat's step is >= 5; a fresh Trainer resumes at
   step 5 with every tensor of the state bit-equal, then trains to the
   end;
25. async checkpoints: the same 8 steps with ``async_checkpoint`` on and
   off, in turns, 3 runs each: the seconds the loop blocks in ``save``,
   the step time of epoch 1 (beside the async write of epoch 0's
   checkpoint); every written step verifies and restores bit-equal to the
   state at its own step, though the parameters were updated in place
   after it;
26. folder data: 1 024 seeded uint8 ``.npy`` images of 256² in 8 class
   folders, one corrupted; ``build_classification_loaders`` (8 threads,
   imagenet augment, 224²) with ``quarantine=``: ``measure_throughput``
   images/s over an epoch, then one Swin-T Trainer epoch from the folder
   and its data-wait share; exactly one sample quarantined a pass and
   every batch full; whether the native JPEG decode builds, and its
   largest difference from PIL on JPEG copies of 64 images where PIL
   imports;
27. YOLOX-S trained at full width through ``train.detection`` (``build``,
   ``train_steps``, ``evaluate``, as ``run`` calls them; the ``yolox_s``
   experiment's overrides: 640², 80 classes, ``max_gt`` 50, batch 8,
   multi-scale buckets 480-800 every 4 steps; 64 synthetic images, 24
   steps, the L1 term from step 20; weights from ``--seed``), then its
   COCO evaluation (the 64 images in one predict call, score 0.3). K3
   counted from zero just before the run and read just after: one launch
   a predict call (training launches none). Every logged loss finite,
   step 16's total below step 0's; the steady step by bucket (CUDA
   events) and ``simota_assign``'s share of a step's device time (its
   profiler range); 4 steps of a resident batch under sync debug mode
   "error"; the first batch's loss from one raw output on the card and on
   the CPU (SimOTA's assignment equal, terms within 1e-5). The evaluation
   again through the plain sweep: equal detections and summary; the C++
   matcher's summary equal to numpy's. Then one batch at score 0 over
   every candidate through both sweeps (alive and suppressed both > 0),
   its detections scored by the C++ matcher (built and loaded) and by
   numpy, the plain sweep's too: some match a ground truth (AR100 > 0),
   the three summaries equal, the host seconds of each matcher;
28. RetinaNet R50-FPN trained the same way at 512² (20 classes, batch 8,
   12 steps at Adam lr 1e-4, no multi-scale) with the same checks (the
   anchor matches for the assignment; step 10's loss below step 0's);
29. Faster R-CNN R50-FPN trained the same way at 800² (20 classes plus
   the background, batch 8, 12 steps at Adam lr 1e-4, 256 proposals and
   128 sampled RoIs an image): K3 counted from zero just before the run
   launches exactly once a train step (the proposals, between the two
   forwards) and twice a predict call; on one step's batch, the RPN's
   8 x 4 507 candidates (asserted) give the same proposals through K3 and
   through the plain sweep, ``generate_proposals`` and ``sample_rois``
   run under sync debug mode "error", and ``balanced_sample`` on the card
   takes exactly min(256, candidates) anchors an image, half positive at
   most, and at most 128 RoIs, a quarter positive at most, no padded
   proposal among them; the card's anchor matches and all-candidate RPN
   loss equal the CPU's; the same evaluation checks, over the 5 120
   (proposal, class) pairs an image at score 0; K3's share of a step's
   device time (profiler) and RoIAlign's backward at the step's RoIs
   (CUDA events: forward and backward less forward);
30. FCOS R50-FPN trained the same way at 512² (20 classes, batch 8, 36
   steps at Adam lr 1e-4: in 12 its box head barely moves, and no box
   matches a ground truth): the targets and loss on the card equal the
   CPU's; at score 0 the top 1 000 (location, class) pairs an image;
31. YOLOv5-S trained the same way at 640² (80 classes, batch 8, 48 steps
   at Adam lr 1e-3) on 4-image mosaics through ``random_perspective`` at
   hyp.scratch's values (degrees 0, translate 0.1, scale 0.5, shear 0),
   the last 16 steps on the raw arrays: the closing line prints, step
   27's loss is below step 0's, the targets and loss on the card equal the
   CPU's, every one of the 25 200 candidates an image at score 0; the
   mosaic feed's images/s (8 threads, prefetch 2) beside the step's.

The kernels line's K3 entry is timed on YOLOX-S's served batch (phase
14); its launches are the sum over the five served detection paths
(phases 13 and 16), the trained detectors' evaluations (phases 27-31)
and Faster R-CNN's train steps (phase 29), each counted from zero just
before its run. The
flash_hb K1 entries add phase 19's launches to phase 3's (forward) and
phase 6's (dQ, dK/dV). The K2 entry adds the launches of phases 22-26 to
phase 9's, each counted from zero just before its run.

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
# the Trainer's losses vs a hand loop of make_train_step on the same batches
# (the same kernels in the same order: aimed at 0)
TRAINER_LOSS_TOL = 1e-6
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
# the rest of detection, served at full width and depth: (registry name,
# image size, buckets, K3 launches a batch). Classes and score threshold are
# serve/profile.detector_defaults': Faster R-CNN keeps its default 0.05, the
# one-stage heads serve at 0, as YOLOX-S does, so every candidate reaches K3.
DETECTORS = [("fasterrcnn_resnet50_fpn", 800, (1, 8), 2),
             ("retinanet_resnet50_fpn", 512, (8,), 1),
             ("fcos_resnet50_fpn", 512, (8,), 1),
             ("yolov5s", 640, (8,), 1)]
DET_MAX = 100
DET_REQUESTS = 16
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
             (2, 4, 257, 256, False), (2, 4, 65, 160, True),
             (16384, 16, 17, 16, False), (2, 4, 65, 320, False),
             (2, 4, 257, 300, True), (1, 4, 129, 512, False)]
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
    lp = {a: engines[a].infer(x) for a in ("flash_hb", "flash")}
    # the naive control must not reach K1: else K1 would meet itself
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    lp["naive"] = engines["naive"].infer(x)
    torch.cuda.synchronize()
    check(not any(fa.launch_counts().values()),
          "the naive engine launches no K1 kernel")
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
    bare_ms = _measure_training(dev, args.seed)
    kernels += _time_backward(fa, dev, g, bwd_errs, train_launches)

    # --------------------------------------- 8. K2 vs plain on the card
    phase(8, started)
    from deeplearning_tpu_torch.ops import window_attention as wa
    win_err = _check_window_kernel(wa, dev, g)

    _time_wide_kernels(fa, wa, dev, g)

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

    # ----------------- 15. K3 vs plain at the other detectors' shapes
    phase(15, started)
    kernels[-1]["max_abs_err"] += _check_nms_detection_shapes(nms_ops, dev,
                                                              g)

    # ------------- 16. serve Faster R-CNN, RetinaNet, FCOS, YOLOv5-s
    phase(16, started)
    detectors = {}
    for spec in DETECTORS:
        launched, detectors[spec[0]] = _serve_detector(nms_ops, dev,
                                                       args.seed, *spec)
        # the kernels line counts K3 over every served detection path
        kernels[-1]["launches"] += launched["nms_greedy_sweep"]

    # ------------------------------------------------------ 17. measure
    phase(17, started)
    for name, size, *_ in DETECTORS:
        _bucket_latency(detectors[name].pop("engines"), ("blocked", "auto"),
                        name, size=size)
        torch.cuda.empty_cache()
    _time_detection_nms(nms_ops, detectors)
    del detectors
    torch.cuda.empty_cache()
    log(f"chip_smoke: phases 1-17 in {time.perf_counter() - started:.1f}s")

    # ------------------------------------- 18. the feed: DevicePrefetcher
    phase(18, started)
    t18 = time.perf_counter()
    _feed(dev, args.seed)

    # ------------------------- 19. ViT-B/16 trained through the Trainer
    phase(19, started)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_train")
    trained = _train_through_trainer(fa, dev, args.seed, workdir)
    by_name = {k["name"]: k for k in kernels}
    for name, n in trained["launches"].items():
        # the kernels line counts K1 over the served and trained paths
        by_name[name]["launches"] += n

    # ------------------------------------------------------ 20. resume
    phase(20, started)
    _resume(args.seed, workdir, trained["params"])
    del trained

    # ------------------------------------------------------ 21. measure
    phase(21, started)
    _measure_trainer(args.seed, bare_ms)
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"chip_smoke: phases 18-21 in {time.perf_counter() - t18:.1f}s")

    # ----------------- 22. Swin-T through the Trainer, strict=transfers
    phase(22, started)
    t22 = time.perf_counter()
    win = by_name[wa.KERNEL_NAME]
    # the kernels line counts K2 over every phase that runs it, each
    # counted from zero just before its run
    strict_run = _strict_swin(wa, dev, args.seed, workdir + "_swin")
    win["launches"] += strict_run["launches"]

    # ------------------------------------------- 23. divergence rollback
    phase(23, started)
    win["launches"] += _rollback_swin(wa, args.seed, workdir + "_rollback",
                                      strict_run["peak"])

    # ------------------------------------- 24. preemption and heartbeat
    phase(24, started)
    win["launches"] += _preempt_swin(wa, args.seed, workdir + "_preempt")

    # ---------------------------------------------- 25. async checkpoints
    phase(25, started)
    win["launches"] += _async_checkpoints(wa, dev, args.seed,
                                          workdir + "_async")

    # --------------------------------------------------- 26. folder data
    phase(26, started)
    win["launches"] += _folder_feed(wa, dev, args.seed, workdir + "_folder")
    log(f"chip_smoke: phases 22-26 in {time.perf_counter() - t22:.1f}s")

    # ----------- 27. YOLOX-S trained (multi-scale, SimOTA) and COCO-scored
    phase(27, started)
    t27 = time.perf_counter()
    torch.cuda.empty_cache()
    from deeplearning_tpu_torch.core.experiment import get_exp
    k3 = by_name["nms_greedy_sweep"]
    # the kernels line counts K3 over the trained detectors' evaluations too
    k3["launches"] += _train_and_score(
        nms_ops, dev, args.seed, YOLOX,
        get_exp(exp_name=YOLOX).cli_overrides() + YOLOX_TRAIN)

    # --------------------------- 28. RetinaNet R50-FPN trained and scored
    phase(28, started)
    torch.cuda.empty_cache()
    k3["launches"] += _train_and_score(nms_ops, dev, args.seed, RETINA,
                                       RETINA_TRAIN)
    log(f"chip_smoke: phases 27-28 in {time.perf_counter() - t27:.1f}s")

    # --------- 29. Faster R-CNN R50-FPN trained: K3 inside its train step
    phase(29, started)
    t29 = time.perf_counter()
    torch.cuda.empty_cache()
    k3["launches"] += _train_and_score(nms_ops, dev, args.seed, FRCNN,
                                       FRCNN_TRAIN)

    # ------------------------------------ 30. FCOS R50-FPN trained, scored
    phase(30, started)
    torch.cuda.empty_cache()
    k3["launches"] += _train_and_score(nms_ops, dev, args.seed, FCOS,
                                       FCOS_TRAIN)

    # ---------------- 31. YOLOv5-S trained on mosaic + random perspective
    phase(31, started)
    torch.cuda.empty_cache()
    k3["launches"] += _train_and_score(nms_ops, dev, args.seed, YOLOV5,
                                       YOLOV5_TRAIN)
    log(f"chip_smoke: phases 29-31 in {time.perf_counter() - t29:.1f}s; "
        f"all in {time.perf_counter() - started:.1f}s")

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
    import copy
    engines = {}
    t0 = time.perf_counter()
    model, _ = hub.load(HUGE, num_classes=1000, seed=seed, device=dev,
                        attn_fn=get_attn_fn("flash_hb"))
    # the naive engine serves a copy of the same weights with its attention
    # swapped (building a second 632M-parameter model from the seed on the
    # host would take ~9 s more); that it launches no K1 is checked below
    naive = copy.deepcopy(model)
    for m in naive.modules():
        if hasattr(m, "attn_fn"):
            m.attn_fn = get_attn_fn("naive")
    for attn, mdl in (("flash_hb", model), ("naive", naive)):
        engines[attn] = InferenceEngine(HUGE, model=mdl, batch_buckets=(1,),
                                        device=dev)
        log(f"engine {HUGE} {attn}: built and warmed in "
            f"{time.perf_counter() - t0:.2f}s; "
            f"{json.dumps(engines[attn].stats())}")
        t0 = time.perf_counter()
    del model, naive
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
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    naive = np.concatenate([engines["naive"].infer(img) for img in images])
    torch.cuda.synchronize()
    check(not any(fa.launch_counts().values()),
          f"{HUGE}: the naive engine launches no K1 kernel")
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
            args = re.findall(r"L[ib](\d+)E", mangled)
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
             (2, 16, 257, 80, True), (2, 4, 257, 256, False),
             (2, 4, 65, 160, True), (2, 4, 65, 320, False),
             (2, 4, 257, 300, True), (1, 4, 129, 512, False)]


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


def _measure_training(dev, seed, name=MODEL) -> float:
    """Phases 7a and 11: step time, images/s and MFU of ``name`` for
    flash_hb (Swin: the fused kernel) and naive in turns (naive, flash_hb,
    flash_hb, naive), then the bench lines. Returns flash_hb's step time
    in ms."""
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
    step_ms = statistics.median(times["flash_hb"]) * 1e3
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
    return step_ms


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
    (16, 49, 3, 32, 8, 8, True),                # whole rows masked
    (64, 49, 2, 128, 4, 8, False), (32, 49, 3, 24, 4, 8, False),
    (8, 144, 2, 24, 4, 4, False),               # window 12, d padded
    (8, 144, 2, 128, 4, 3, False),
    (320, 49, 3, 32, 64, 3, False),             # 5 images, 3 a CTA
    (32, 49, 3, 160, 4, 8, False),              # d > 128: the wide kernel
    (16, 49, 2, 256, 4, 3, True), (8, 144, 2, 160, 4, 4, False),
    (8, 144, 3, 256, 0, 2, False)]


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


def _time_wide_kernels(fa, wa, dev, g) -> None:
    """Phase 8, last: the wide SIMT kernels' device time (CUDA-graph
    replay), bf16: K1 at ViT-B/16's 197 tokens and 12 heads with D = 320
    at batch 8 (forward; dQ and dK/dV), K2 at Swin-T stage 1's windows
    (batch 8: BW 512, N 49, 3 heads, nW 64) with d = 160 (run at 192).
    Each beside its plain version, SDPA where it takes the shape (a
    yardstick), and its bound."""
    import torch
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    rep = dict(calls=3, replays=3)
    b, h, n, d = 8, HEADS, TOKENS, 320
    qkv = torch.randn(b, n, 3, h, d, device=dev, generator=g).to(
        torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    o, lse = fa.flash_attention_reference(q, k, v)
    do = torch.randn_like(o)
    rows = {
        "forward": (lambda: fa._attention(q, k, v, sm_scale=None,
                                          causal=False, heads_per_cta=1),
                    lambda: fa.flash_attention_reference(q, k, v),
                    fa.min_bytes(b, h, n, d, 2), fa.flops(b, h, n, d)),
        "dq + dkv": (lambda: fa._attention_bwd(
            q, k, v, o, lse, do, sm_scale=None, causal=False,
            heads_per_cta=1),
            lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do),
            fa.bwd_min_bytes(b, h, n, d, 2), fa.bwd_flops(b, h, n, d))}
    for what, (fn, plain, nbytes, flops) in rows.items():
        ms, plain_ms = graph_ms(fn, **rep), _time_ms(plain, iters=3,
                                                     warmup=1)
        bound = max(nbytes / HBM_BYTES_PER_S,
                    flops / PEAK_FLOPS["bfloat16"]) * 1e3
        log(f"timing wide K1 {what} B={b} H={h} N={n} D={d} bf16: kernel "
            f"{ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP; {flops / ms / 1e9:.1f} TFLOP/s achieved)")
    try:
        qt, kt, vt = q.contiguous(), k.contiguous(), v.contiguous()
        sdpa_ms = graph_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(qt, kt, vt), **rep)
        log(f"timing wide K1 forward: sdpa {sdpa_ms:.4f} ms (a yardstick)")
    except RuntimeError as exc:
        log(f"timing wide K1 forward: sdpa does not take D={d} ({exc})")
    bw, wn, heads, wd, nw = 8 * 64, WIN_TOKENS, 3, 160, 64
    wqkv, bias, mask = _window_inputs(dev, g, bw, wn, heads, wd,
                                      torch.bfloat16, nw)
    ms = graph_ms(lambda: wa.window_attention(wqkv, bias, mask), **rep)
    plain_ms = _time_ms(lambda: wa.window_attention_plain(wqkv, bias, mask),
                        iters=3, warmup=1)
    nbytes = wa.min_bytes(bw, wn, heads, wd, 2, nw)
    flops = wa.flops(bw, wn, heads, wd)
    bound = max(nbytes / HBM_BYTES_PER_S,
                flops / PEAK_FLOPS["bfloat16"]) * 1e3
    log(f"timing wide K2 BW={bw} N={wn} heads={heads} d={wd} nW={nw} bf16: "
        f"kernel {ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s achieved)")
    del qkv, q, k, v, o, lse, do, wqkv
    torch.cuda.empty_cache()


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
    bound; device time by CUDA-graph replay (the eager call time beside
    the kernel's). Returns the kernels-line entry, at stage 1."""
    import torch
    import torch.nn.functional as F
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    entry = None
    for stage, (wins, heads, nw) in enumerate(SWIN_STAGES, 1):
        bw, n, d = TRAIN_BATCH * wins, WIN_TOKENS, WIN_HEAD_DIM
        qkv, bias, mask = _window_inputs(dev, g, bw, n, heads, d,
                                         torch.bfloat16, nw)
        ms = graph_ms(lambda: wa.window_attention(qkv, bias, mask))
        call_ms = _time_ms(lambda: wa.window_attention(qkv, bias, mask))
        plain_ms = graph_ms(lambda: wa.window_attention_plain(qkv, bias,
                                                              mask),
                            calls=5, replays=3)
        # SDPA over (B, nW, heads, N, d) views with a (nW, heads, N, N) mask
        q, k, v = (x.transpose(1, 2).unflatten(0, (TRAIN_BATCH, wins))
                   for x in qkv.unbind(2))
        comb = bias[None] if mask is None else bias[None] + mask[:, None]
        comb = comb.to(torch.bfloat16)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=comb))
        nbytes = wa.min_bytes(bw, n, heads, d, 2, nw)
        flops = wa.flops(bw, n, heads, d)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"timing window_attn_fwd stage {stage} BW={bw} N={n} "
            f"heads={heads} d={d} nW={nw} bf16: kernel {ms:.4f} ms (graph "
            f"replay; eager calls {call_ms:.4f}), plain "
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


def _check_nms_detection_shapes(nms_ops, dev, g) -> int:
    """Phase 15: K3 against its plain version and the greedy oracle,
    exactly, at the candidate sets the other detectors serve: YOLOv5-S's
    25 200 an image (32 images, 80 classes offset at 640², past the 20 000
    phase 12 holds), Faster R-CNN's RPN (8 x 4 507, class-agnostic, IoU
    0.7, 256 kept, score floor -1e8) and its box stage (8 x 5 120, 20
    classes, a tenth of the proposals padded with -inf scores). Returns the
    mismatching slots (0, or the run has failed)."""
    import torch
    from deeplearning_tpu_torch.serve.profile import detector_defaults
    inf = float("inf")
    box_score = detector_defaults("fasterrcnn_resnet50_fpn")[1]
    b, s = _nms_boxes(dev, g, 32, 25_200, span=640.0, wh_max=160.0)
    cls = torch.randint(0, 80, (32, 25_200), device=dev, generator=g)
    rpn_b, rpn_s = _nms_boxes(dev, g, 8, 4_507, span=800.0, wh_max=300.0)
    box_b, box_s = _nms_boxes(dev, g, 8, 5_120, span=800.0, wh_max=300.0)
    box_s = torch.where(torch.arange(5_120, device=dev) >= 4_608,
                        torch.full_like(box_s, -inf), box_s * 0.3)
    box_cls = torch.arange(5_120, device=dev).remainder(20)[None].expand(
        8, -1)
    cases = [("YOLOv5-S 32 x 25 200, 80 classes", b, s, cls, 0.45, 0.05,
              DET_MAX, 1),
             ("Faster R-CNN RPN 8 x 4 507", rpn_b, rpn_s, None, 0.7, -1e8,
              256, 2),
             ("Faster R-CNN boxes 8 x 5 120, 20 classes", box_b, box_s,
              box_cls, 0.5, box_score, DET_MAX, 2)]
    total = 0
    for name, b, s, cls, th, st, mo, k in cases:
        def call(impl, b=b, s=s, cls=cls):
            if cls is None:
                return nms_ops.nms(b, s, th, mo, st, impl=impl)
            return nms_ops.batched_nms(b, s, cls, th, mo, st, impl=impl)
        nms_ops.reset_launch_counts()
        got = call("auto")
        check(nms_ops.launch_counts()["nms_greedy_sweep"] == 1,
              "one K3 launch a batch")
        bad = _keep_mismatches(call("blocked"), got)
        greedy = call("greedy", b[:k], s[:k], None if cls is None
                      else cls[:k])
        bad_greedy = _keep_mismatches(greedy, tuple(x[:k] for x in got))
        torch.cuda.synchronize()
        kept = got[1].sum(dim=1)
        log(f"kernel-vs-plain nms {name}: th={th} score>{st} max_out={mo}: "
            f"alive {int((s > st).sum())}, kept {int(kept.sum())} (per image "
            f"{int(kept.min())}-{int(kept.max())}), mismatching slots vs "
            f"blocked {bad}, vs greedy on {k} images {bad_greedy}")
        check(bad == 0 and bad_greedy == 0 and int(kept.min()) > 0,
              f"nms kernel disagrees with the plain version ({name})")
        total += bad + bad_greedy
        del got, greedy
    torch.cuda.empty_cache()
    return total


def _record_nms(nms_ops, fn):
    """``fn()`` with every ``ops/nms.nms`` call's candidates recorded:
    (boxes, scores, iou_threshold, max_out, score_threshold) a call, the
    boxes class-offset where the call was class-aware."""
    calls, inner = [], nms_ops.nms

    def recording(boxes, scores, iou_threshold, max_out,
                  score_threshold=float("-inf"), **kw):
        calls.append((boxes.clone(), scores.clone(), iou_threshold, max_out,
                      score_threshold))
        return inner(boxes, scores, iou_threshold, max_out, score_threshold,
                     **kw)
    nms_ops.nms = recording
    try:
        out = fn()
    finally:
        nms_ops.nms = inner
    return out, calls


def _both_impls(name, model, x, size, score):
    """One batch's detections through K3 and through the plain blocked
    sweep on ONE forward (Faster R-CNN: its proposals too, then one RoI
    stage on them); returns (K3's, plain's, candidates alive)."""
    import torch
    from deeplearning_tpu_torch.models.detection import (
        faster_rcnn, fcos, retinanet, yolov5)
    hw, dev = (size, size), x.device
    dets = {}
    with torch.no_grad():
        out = model(x)
        if name.startswith("fasterrcnn"):
            anchors = torch.from_numpy(faster_rcnn.fasterrcnn_anchors(
                hw)).to(dev)
            props = {impl: faster_rcnn.generate_proposals(
                out, anchors, hw, nms_impl=impl) for impl in ("auto",
                                                              "blocked")}
            check(all(torch.equal(a, b) for a, b in zip(
                props["auto"], props["blocked"])),
                f"{name}: proposals through K3 == through the plain sweep")
            p, pv = props["auto"]
            out2 = model(x, proposals=p, pyramid=out["pyramid"])
            for impl in ("auto", "blocked"):
                dets[impl] = faster_rcnn.fasterrcnn_postprocess(
                    out2["roi_scores"], out2["roi_deltas"], p, hw,
                    prop_valid=pv, score_thresh=score, max_det=DET_MAX,
                    nms_impl=impl)
            alive = int((torch.softmax(out2["roi_scores"], -1)[..., 1:]
                         > score).sum())
        else:
            for impl in ("auto", "blocked"):
                kw = dict(score_thresh=score, max_det=DET_MAX,
                          nms_impl=impl)
                if name.startswith("retinanet"):
                    dets[impl] = retinanet.retinanet_postprocess(
                        out, torch.from_numpy(retinanet.retinanet_anchors(
                            hw)).to(dev), hw, **kw)
                elif name.startswith("fcos"):
                    dets[impl] = fcos.fcos_postprocess(
                        out, torch.from_numpy(fcos.fcos_locations(hw)[0]).to(
                            dev), hw, **kw)
                else:
                    grid = {k: torch.from_numpy(v).to(dev) for k, v in
                            yolov5.yolov5_grid(hw).items()}
                    dets[impl] = yolov5.yolov5_postprocess(out, grid, **kw)
            alive = -1
    torch.cuda.synchronize()
    return dets["auto"], dets["blocked"], alive


def _serve_detector(nms_ops, dev, seed, name, size, buckets, per_batch):
    """Phase 16: one detector served at full width and depth through the
    batcher with K3: DET_REQUESTS requests from 8 threads, the K3 counter
    zeroed just before and read just after (``per_batch`` launches a batch
    dispatched), every answer ``DET_MAX`` rows with class -1 exactly on the
    invalid ones and equal to ``engine.infer`` of the same image at the
    bucket it was served in; on one batch of the largest bucket, the
    detections through K3 equal those through the plain sweep. Returns
    K3's launches and what phase 17 measures on."""
    import torch
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
    from deeplearning_tpu_torch.serve.profile import (detector_defaults,
                                                      seeded_detector)
    t0 = time.perf_counter()
    classes, score = detector_defaults(name)
    # a flax tree drawn from the seed through the converter, with nonzero
    # scales (a fresh ResNet's zero residual scales would leave its 3x3
    # convolutions out of every answer), statistics calibrated on seeded
    # images
    model = seeded_detector(name, classes, seed, size, dev)
    engines = {impl: InferenceEngine(
        name, model=model, num_classes=classes, image_size=size,
        batch_buckets=buckets, device=dev, score_thresh=score,
        max_det=DET_MAX, nms_impl=impl) for impl in ("auto", "blocked")}
    log(f"engine {name} (K3 and plain): built, seeded, calibrated and "
        f"warmed in {time.perf_counter() - t0:.2f}s; "
        f"{json.dumps(engines['auto'].stats())}")
    rng = np.random.default_rng(seed + 5)
    images = rng.normal(size=(DET_REQUESTS, size, size, 3)).astype(
        np.float32)
    engine = engines["auto"]
    with MicroBatcher(engine, max_wait_ms=5.0) as mb:
        torch.cuda.synchronize()
        nms_ops.reset_launch_counts()
        t0 = time.perf_counter()

        def client(part):
            handles = [mb.submit(img) for img in part]
            return [h.result(timeout=300.0) for h in handles]

        with ThreadPoolExecutor(8) as pool:
            rows = [r for part in pool.map(client, np.array_split(images, 8))
                    for r in part]
        served_ms = (time.perf_counter() - t0) * 1e3
        counts = nms_ops.launch_counts()
        batches = mb.dispatched
    log(f"served {len(rows)}/{DET_REQUESTS} {name} requests at {size}² "
        f"through K3 in {served_ms:.1f} ms "
        f"({DET_REQUESTS / served_ms * 1e3:.1f} img/s): {batches} batches, "
        f"launches {json.dumps(counts)}")
    check(len(rows) == DET_REQUESTS, "every answer arrives")
    check(batches > 0 and counts["nms_greedy_sweep"] == per_batch * batches,
          f"{name}: K3 launches {per_batch} x batches dispatched")
    for row in rows:
        check(row["boxes"].shape == (DET_MAX, 4)
              and row["valid"].shape == (DET_MAX,)
              and np.isfinite(row["boxes"]).all()
              and bool(((row["labels"] == -1) == ~row["valid"]).all())
              and bool((row["labels"] < classes).all()),
              f"{name}: max_det rows, class -1 exactly on invalid rows")
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
    valid = sum(int(r["valid"].sum()) for r in rows)
    log(f"{name} served vs engine.infer of the same image: equal at bucket "
        f"{json.dumps({str(b): equal_at.count(b) for b in engine.buckets})}"
        f", equal at none {equal_at.count(None)}; valid rows {valid}/"
        f"{DET_REQUESTS * DET_MAX}")
    check(None not in equal_at, f"{name}: every served answer == "
                                f"engine.infer")
    check(valid > 0, f"{name}: some detection passes score {score}")

    top = max(buckets)
    x = torch.from_numpy(images[:top]).to(dev)
    k3, plain, alive = _both_impls(name, model, x, size, score)
    check(all(torch.equal(k3[k], plain[k]) for k in k3),
          f"{name}: detections through K3 == through the plain sweep")
    log(f"{name} bucket-{top} batch: K3 == plain sweep (proposals and "
        f"detections); valid {int(k3['valid'].sum())}"
        + (f", candidates alive {alive}" if alive >= 0 else ""))
    _, calls = _record_nms(nms_ops, lambda: engine.run(top, images[:top]))
    torch.cuda.synchronize()
    return counts, {"engines": engines, "calls": calls}


def _time_detection_nms(nms_ops, detectors) -> None:
    """Phase 17b: K3 at each served candidate set (recorded from one
    largest-bucket batch of each detector): the kernel by CUDA-graph
    replay, the whole call, the plain sweep and call, and the bound."""
    for name, rec in detectors.items():
        for i, (boxes, scores, th, mo, st) in enumerate(rec["calls"]):
            ms, plain, bound, kept, ious = _time_k3(nms_ops, boxes, scores,
                                                    st, th, mo)
            bytes_ms, ops_ms = bound
            b, n = scores.shape
            log(f"timing nms {name} call {i} B={b} N={n} th={th} "
                f"max_out={mo} score>{st}: nms_greedy_sweep "
                f"{ms['kernel']:.4f} ms (graph replay), whole call "
                f"{ms['call']:.4f} ms; plain sweep {plain['sweep']:.4f} ms, "
                f"plain call {plain['call']:.4f} ms; bound "
                f"{max(bytes_ms, ops_ms):.5f} ms ("
                f"{'bytes' if bytes_ms >= ops_ms else 'operations'}); kept "
                f"{kept}, greedy IoUs {ious}")


def _time_k3(nms_ops, boxes, scores, st, th, mo):
    """K3 at one candidate set: ({kernel (graph replay), sweep, call} ms,
    {sweep, call} ms of the plain version, (bytes ms, operations ms) of
    the bound, kept, greedy's IoUs)."""
    import torch
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    dev = boxes.device
    b, n = scores.shape
    sboxes, alive0, _, _ = nms_ops.sort_pad_candidates(boxes, scores, st,
                                                       nms_ops.WORD)
    npad = sboxes.shape[1]
    live_t = torch.tensor(nms_ops.live_counts(alive0), dtype=torch.int32,
                          device=dev)
    out = torch.empty((b, npad), dtype=torch.bool, device=dev)
    cap = max(0, min(mo, npad) - nms_ops.KEPT_SMEM)
    spill = torch.empty((b, max(cap, 1), 4), device=dev)
    th32 = float(torch.tensor(th, dtype=torch.float32))
    lib, rc = nms_ops._lib(), [0]

    def kernel_call():
        rc[0] |= lib.nms_greedy_sweep(
            sboxes.data_ptr(), alive0.data_ptr(), live_t.data_ptr(),
            spill.data_ptr(), out.data_ptr(), b, npad, cap, mo, th32,
            torch.cuda.current_stream().cuda_stream)
    worst = mo >= n
    reps = dict(calls=2, replays=3) if worst else {}
    iters = dict(iters=3, warmup=1) if worst else {}
    ms = {"kernel": graph_ms(kernel_call, **reps),
          "sweep": _time_ms(lambda: nms_ops.nms_sweep(sboxes, alive0, th,
                                                      mo), **iters),
          "call": _time_ms(lambda: nms_ops.nms(boxes, scores, th, mo, st,
                                               impl="auto"), **iters)}
    check(rc[0] == 0, "the timed K3 launches succeeded")
    plain = {"sweep": _time_ms(lambda: nms_ops.nms_sweep_plain(
                 sboxes, alive0, th, mo, nms_ops.WORD), iters=2, warmup=1),
             "call": _time_ms(lambda: nms_ops.nms(
                 boxes, scores, th, mo, st, impl="blocked"), iters=2,
                 warmup=1)}
    alive = nms_ops.nms_sweep(sboxes, alive0, th, mo)
    torch.cuda.synchronize()
    check(torch.equal(out, alive), "the timed kernel's keeps == the sweep's")
    ious = nms_ops.greedy_ious(alive, alive0, mo)
    nbytes = nms_ops.sweep_bytes(alive, alive0, mo)
    bound = (nbytes / HBM_BYTES_PER_S * 1e3,
             ious * nms_ops.OPS_PER_IOU / PEAK_FLOPS["float32"] * 1e3)
    return ms, plain, bound, int(alive.sum()), ious


# ------------------------------------------- phases 18-21: the train slice
FEED_STEPS = 4            # batches an epoch of phase 18's feed
TRAINER_STEPS = 4         # steps an epoch of phases 19-20 (2 epochs)
MEASURE_STEPS = 16        # steps an epoch of phase 21
STEADY_FROM = 4           # phase 21's steady step: steps 4 to 15


def _feed(dev, seed) -> None:
    """Phase 18: ``DevicePrefetcher(depth=2)`` over a ``DataLoader`` of
    224² uint8 images made float32 per sample (4 fetch threads), two
    epochs of 4 batches of 128, consumed under
    ``set_sync_debug_mode("error")`` while the main stream is kept busy
    (fp32 matmuls queued ahead of each read, so the side stream's copies
    race the reads). Epoch 0 keeps every batch and holds it against its
    host batch bit for bit (the copy event waited on); epoch 1 drops each
    batch after queuing an exact digest of it (the int64 sum of its
    float32 bit patterns), so the allocator may reuse its memory: equal
    digests show the handed-over tensors were ``record_stream``-ed. A
    fetch that raises reaches the consumer with its traceback."""
    import traceback
    import torch
    from deeplearning_tpu_torch.data import (DataLoader, DevicePrefetcher,
                                             MapSource)
    from deeplearning_tpu_torch.train.__main__ import classification_source
    n = TRAIN_BATCH * FEED_STEPS
    rng = np.random.default_rng(seed + 18)
    images = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, n).astype(np.int32)
    source = classification_source(images, labels, 3)
    check(isinstance(source, MapSource), "uint8 images convert per sample")
    host = DataLoader(source, TRAIN_BATCH, seed=seed)
    pf = DevicePrefetcher(DataLoader(source, TRAIN_BATCH, seed=seed,
                                     device=dev, num_workers=4), depth=2)
    busy = torch.randn(4096, 4096, device=dev)
    kept, digests = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for epoch in (0, 1):
            pf.set_epoch(epoch)
            for batch in pf:
                for _ in range(4):
                    torch.mm(busy, busy)
                digests.append(batch["image"].view(torch.int32)
                               .to(torch.int64).sum())
                if epoch == 0:
                    kept.append(batch)
                del batch
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = pf.stats()
    same, digest_ok = 0, 0
    for epoch in (0, 1):
        host.set_epoch(epoch)
        for i, hb in enumerate(host):
            if epoch == 0:
                same += int(all(torch.equal(kept[i][k].cpu(),
                                            torch.from_numpy(hb[k]))
                                for k in ("image", "label")))
            want = int(hb["image"].view(np.int32).astype(np.int64).sum())
            digest_ok += int(digests[epoch * FEED_STEPS + i].item() == want)
    log(f"feed: 2 epochs of {FEED_STEPS} batches of {TRAIN_BATCH} x 224² "
        f"uint8->float32 in {wall:.2f}s under sync debug mode 'error'; "
        f"bit-equal batches {same}/{FEED_STEPS}, equal digests "
        f"{digest_ok}/{2 * FEED_STEPS}; stats {json.dumps(stats)}")
    check(same == FEED_STEPS, "every delivered batch equals its host batch")
    check(digest_ok == 2 * FEED_STEPS,
          "batches read after the allocator could reuse them are intact")
    check(stats["batches_fed"] == 2 * FEED_STEPS, "every batch was fed")
    alone = iter(pf.loader)
    check(next(alone)["image"].device.type == "cuda",
          "the wrapped loader, iterated alone, still moves its batches")
    alone.close()

    def unreadable(i):
        if i == 2 * TRAIN_BATCH + 5:
            raise ValueError(f"sample {i} is unreadable")
        return source.fetch(i)
    bad = DevicePrefetcher(DataLoader(MapSource(n, unreadable), TRAIN_BATCH,
                                      shuffle=False, device=dev), depth=2)
    fed = 0
    try:
        for _ in bad:
            fed += 1
        check(False, "a worker's exception reaches the consumer")
    except ValueError as exc:
        frames = [f.name for f in traceback.extract_tb(exc.__traceback__)]
        log(f"feed: worker error relayed after {fed} batches: {exc!r}, "
            f"traceback through {frames[-2:]}")
        check(fed == 2 and "unreadable" in frames,
              "the worker's error arrives in order, with its traceback")
    del kept, busy
    torch.cuda.empty_cache()


def _smoke_cfg(workdir=None, steps=TRAINER_STEPS):
    """Phases 6-7's training set-up through the train CLI's Config:
    ViT-B/16 at 224², batch 128, flash_hb, AdamW (wd 0.05) under
    warmup-cosine, label smoothing 0.1; the CLI's synthetic data (its
    ``load_data``), 2 epochs of ``steps`` steps."""
    from deeplearning_tpu_torch.train.__main__ import (Config, DataCfg,
                                                       ModelCfg, OptimCfg,
                                                       TrainCfg)
    return Config(
        model=ModelCfg(name=MODEL, num_classes=1000, attn="flash_hb"),
        data=DataCfg(image_size=224, channels=3, global_batch=TRAIN_BATCH,
                     n_train=TRAIN_BATCH * steps, prefetch=2),
        optim=OptimCfg(name="adamw", lr=1e-3, weight_decay=0.05,
                       schedule="warmup_cosine", warmup_steps=2),
        train=TrainCfg(epochs=2, label_smoothing=0.1, workdir=workdir,
                       device="cuda"))


def _cli():
    """The train CLI module, its synthetic data made once for every
    build of phases 19-20 (the same seed gives the same arrays)."""
    import functools
    from deeplearning_tpu_torch.train import __main__ as cli
    if not hasattr(cli.load_data, "cache_info"):
        cli.load_data = functools.lru_cache(maxsize=1)(cli.load_data)
    return cli


class _NoSyncBetweenLogPoints:
    """Arms ``torch.cuda.set_sync_debug_mode("error")`` from each epoch's
    start to its end, and lifts it only inside the lagged metric fetches
    (``deferred.poll`` / ``drain``: the one designed sync a log point, the
    window JAX's ``strict="transfers"`` leaves out too). A sync anywhere
    else between log points (the feed, the step, the optimizer, the
    metrics push) raises where it happens."""

    def __init__(self, trainer):
        self.armed_steps = 0
        self._armed = False
        cb = trainer.callbacks
        cb.register("before_epoch", lambda t: self._arm(True))
        cb.register("after_epoch", lambda t: self._arm(False))
        cb.register("after_iter", self._count)
        d = trainer.deferred
        for name in ("poll", "drain"):
            setattr(d, name, self._unguarded(getattr(d, name)))

    def _arm(self, on: bool) -> None:
        import torch
        self._armed = on
        torch.cuda.set_sync_debug_mode("error" if on else 0)

    def _count(self, trainer, metrics) -> None:
        self.armed_steps += int(self._armed)

    def _unguarded(self, fn):
        def call():
            import torch
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(
                    "error" if self._armed else 0)
        return call


def _train_through_trainer(fa, dev, seed, workdir) -> dict:
    """Phase 19: ViT-B/16 trained by the port's Trainer, built by the train
    CLI's ``build``: 2 epochs of 4 steps, then one eval (every 2 epochs).
    K1's launches counted from zero just before ``train()``; every loss
    the Trainer logged (its flight record of each fetched step) against a
    hand loop of ``make_train_step`` over the same loader's batches."""
    import shutil
    import torch
    from deeplearning_tpu_torch.obs import flight
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    trainer = cli.build(_smoke_cfg(workdir), eval_every_epochs=2)
    guard = _NoSyncBetweenLogPoints(trainer)
    log(f"trainer built in {time.perf_counter() - t0:.2f}s: log_every "
        f"{trainer.log_every}, metrics_lag {trainer.metrics_lag}, feed "
        f"{type(trainer.train_loader).__name__}(depth "
        f"{trainer.train_loader.depth})")
    flight.get_recorder().clear()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.train()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    steps = 2 * TRAINER_STEPS
    forwards = steps + TRAINER_STEPS           # 8 train steps + 4 eval
    logged = [e["metrics"]["loss"] for e in flight.get_recorder().events(
        "step")]
    log(f"Trainer: {steps} steps + 1 eval in {wall:.2f}s (incl. 3 "
        f"checkpoint writes), {guard.armed_steps} steps under sync debug "
        f"mode 'error', eval {json.dumps(trainer._last_eval)} "
        f"({trainer.eval_fetches} host fetch), losses "
        f"{[round(x, 5) for x in logged]}, launches {json.dumps(counts)}")
    want = {fa.KERNEL_NAMES[4]: DEPTH * forwards,
            fa.BWD_KERNEL_NAMES["dq"][4]: DEPTH * steps,
            fa.BWD_KERNEL_NAMES["dkv"][4]: DEPTH * steps}
    for name, n in want.items():
        check(counts[name] == n, f"{name} launches == {n}")
    check(sum(counts.values()) == sum(want.values()),
          "the Trainer launched only flash_hb's kernels")
    check(guard.armed_steps == steps, "every step ran under the guard")
    check(trainer.eval_fetches == 1 and all(
        np.isfinite(v) for v in trainer._last_eval.values()),
        "one eval, one host fetch, finite results")
    check(trainer.state.step == steps and len(logged) == steps
          and all(np.isfinite(logged)), "every step logged a finite loss")
    check(trainer.ckpt.latest_step() == steps and os.path.isdir(
        os.path.join(workdir, "ckpt", "best")), "checkpoints with best")
    final = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    del trainer
    torch.cuda.empty_cache()

    ref = cli.build(_smoke_cfg(None))
    hand = []
    for epoch in range(2):
        ref.train_loader.set_epoch(epoch)
        for batch in ref.train_loader:
            ref.state, m = ref.train_step(ref.state, batch, ref.rng)
            hand.append(m["loss"])
    hand = [float(x) for x in hand]
    diff = max(abs(a - b) for a, b in zip(logged, hand))
    params_equal = all(torch.equal(p, final[n])
                       for n, p in ref.state.params.items())
    log(f"Trainer vs hand loop of make_train_step: max |dloss| {diff:.3e} "
        f"(tol {TRAINER_LOSS_TOL}); final params bit-equal {params_equal}")
    check(len(hand) == steps and diff <= TRAINER_LOSS_TOL,
          "the Trainer's losses equal the hand loop's")
    del ref
    torch.cuda.empty_cache()
    return {"launches": {n: counts[n] for n in want}, "params": final}


def _resume(seed, workdir, final) -> None:
    """Phase 20: a run stopped after its first epoch (its step-4
    checkpoint written) and resumed by a fresh Trainer in the same workdir
    ends with parameters bit-equal to phase 19's uninterrupted run; then a
    flipped byte in the newest step (8) makes the restore fall back to
    step 4, moving the corrupt step aside."""
    import shutil
    import torch
    cli = _cli()
    wd = workdir + "_resume"
    shutil.rmtree(wd, ignore_errors=True)

    class Stop(Exception):
        pass

    def stop_after_first_save(trainer, step):
        if step == TRAINER_STEPS:
            raise Stop

    first = cli.build(_smoke_cfg(wd), eval_every_epochs=2)
    first.callbacks.register("on_checkpoint", stop_after_first_save)
    try:
        first.train()
        check(False, "the first run stops after epoch 1")
    except Stop:
        pass
    check(first.ckpt.all_steps() == [TRAINER_STEPS],
          "the stopped run left its step-4 checkpoint")
    del first
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = cli.build(_smoke_cfg(wd), eval_every_epochs=2)
    resumed.train()
    torch.cuda.synchronize()
    equal = sum(torch.equal(p, final[n])
                for n, p in resumed.state.params.items())
    log(f"resume: from step {TRAINER_STEPS} to {resumed.state.step} in "
        f"{time.perf_counter() - t0:.2f}s; params bit-equal to the "
        f"uninterrupted run: {equal}/{len(final)}")
    check(resumed.state.step == 2 * TRAINER_STEPS and equal == len(final),
          "the resumed run ends bit-equal to the uninterrupted one")

    path = os.path.join(wd, "ckpt", str(2 * TRAINER_STEPS), "state.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    _, step = resumed.ckpt.auto_resume(resumed.state)
    moved = os.path.isdir(os.path.join(wd, "ckpt",
                                       f"corrupt-{2 * TRAINER_STEPS}"))
    older = any(not torch.equal(p, final[n])
                for n, p in resumed.state.params.items())
    log(f"resume with a flipped byte in step {2 * TRAINER_STEPS}: restored "
        f"step {step} (state step {resumed.state.step}), corrupt step moved "
        f"aside {moved}")
    check(step == TRAINER_STEPS and resumed.state.step == TRAINER_STEPS
          and moved and older, "a corrupt newest step falls back to step 4")
    del resumed
    shutil.rmtree(wd, ignore_errors=True)
    torch.cuda.empty_cache()


def _measure_trainer(seed, bare_ms) -> None:
    """Phase 21: the Trainer's step with the feed on (prefetch 2: pinned
    staging, side-stream copies) and off (prefetch 0: the loader copies
    on the loop's thread), epochs of ``MEASURE_STEPS`` steps, in turns
    (0, 2, 2, 0) twice on one state. The step is the steady one: CUDA
    events on the loop's stream before step ``STEADY_FROM`` and after the
    last step, so the feed's start-up and the epoch-end drain stay out;
    the epoch's wall less its steps is reported apart as the epoch
    overhead. Per route: the steady step (median over the four runs),
    images/s, the share of the steady window's host time spent waiting
    for batches (the Trainer's ``data_wait`` spans), the device time a
    step from one profiled epoch (kernels only; copies apart) and the
    idle share 1 - kernel time / steady step; then ``throughput()`` of
    each. Beside phase 7's bare step on a resident batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning_tpu_torch.data import DataLoader
    from deeplearning_tpu_torch.obs import spans
    from deeplearning_tpu_torch.serve.profile import _device_us
    from deeplearning_tpu_torch.train.trainer import Trainer
    cli = _cli()
    on = cli.build(_smoke_cfg(None, steps=MEASURE_STEPS),
                   eval_every_epochs=10 ** 9)
    loader = DataLoader(on.train_loader.loader.source, TRAIN_BATCH,
                        seed=seed, device=on.train_loader.device)
    off = Trainer(state=on.state, train_step=on.train_step,
                  train_loader=loader, prefetch=0, seed=seed,
                  log_every=on.log_every, epochs=0)
    routes = {"prefetch=2": on, "prefetch=0": off}
    marks, events = [], []

    def before_iter(tr, batch):
        if len(marks) == STEADY_FROM:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    def after_iter(tr, metrics):
        marks.append(time.perf_counter())
        if len(marks) == MEASURE_STEPS:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
    for t in routes.values():
        t.callbacks.register("before_iter", before_iter)
        t.callbacks.register("after_iter", after_iter)
    tracer = spans.enable()
    steady_n = MEASURE_STEPS - STEADY_FROM

    def epoch(t):
        t.epoch, t.epochs = t.epochs, t.epochs + 1
        marks.clear()
        events.clear()
        tracer.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(marks) == MEASURE_STEPS and len(events) == 2,
              "phase 21 ran every step of its epoch")
        step = events[0].elapsed_time(events[1]) / 1e3 / steady_n
        waits = [e["dur"] / 1e6 for e in tracer.events()
                 if e.get("name") == "data_wait"]
        host = marks[-1] - marks[STEADY_FROM - 1]
        return wall, step, sum(waits[STEADY_FROM:MEASURE_STEPS]) / host

    epoch(on)                                  # warm both routes
    epoch(off)
    rows = {name: {"walls": [], "steps": [], "waits": []} for name in routes}
    for name in ("prefetch=0", "prefetch=2", "prefetch=2", "prefetch=0") * 2:
        wall, step, wait = epoch(routes[name])
        rows[name]["walls"].append(wall)
        rows[name]["steps"].append(step)
        rows[name]["waits"].append(wait)
    for name, t in routes.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            epoch(t)
        kernels = sum(_device_us(e) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith(("Memcpy", "Memset")))
        copies = sum(_device_us(e) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.key.startswith("Memcpy"))
        r = rows[name]
        step = statistics.median(r["steps"])
        kernel_ms = kernels / 1e3 / MEASURE_STEPS
        r.update({
            "step_ms": step * 1e3,
            "runs_step_ms": [s * 1e3 for s in r.pop("steps")],
            "epoch_ms": statistics.median(r["walls"]) * 1e3,
            "epoch_overhead_ms": (statistics.median(r.pop("walls"))
                                  - MEASURE_STEPS * step) * 1e3,
            "images_per_sec": TRAIN_BATCH / step,
            "data_wait_share": statistics.median(r.pop("waits")),
            "kernel_ms_per_step": kernel_ms,
            "copy_ms_per_step": copies / 1e3 / MEASURE_STEPS,
            "idle_share": 1.0 - kernel_ms / (step * 1e3)})
    spans.disable()
    for name, t in routes.items():
        rows[name]["throughput_images_per_sec"] = t.throughput(n_iters=8,
                                                               lag=3)
        rows[name]["throughput_stats"] = t.throughput_stats
    for name, r in rows.items():
        log(f"Trainer step {MODEL} {name} batch {TRAIN_BATCH}, epochs of "
            f"{MEASURE_STEPS} steps, steady steps {STEADY_FROM}-"
            f"{MEASURE_STEPS - 1}: {json.dumps(r)}")
    log(f"bare step (phase 7, flash_hb, resident batch): {bare_ms:.3f} ms; "
        f"steady Trainer step, prefetch=2: "
        f"{rows['prefetch=2']['step_ms']:.3f} ms, prefetch=0: "
        f"{rows['prefetch=0']['step_ms']:.3f} ms")
    check(all(r["throughput_images_per_sec"] > 0 and
              np.isfinite(r["step_ms"]) for r in rows.values()),
          "both routes measured")
    del on, off, routes
    torch.cuda.empty_cache()


# ------------------------ phases 22-26: the robust half of the Trainer
FOLDER_IMAGES, FOLDER_CLASSES, FOLDER_SIZE = 1024, 8, 256
JPEG_IMAGES = 64
ASYNC_RUNS = (True, False, False, True, True, False)   # in turns, 3 each


def _swin_cfg(workdir=None, steps=TRAINER_STEPS, **train):
    """Phases 19-20's set-up with Swin-T (the fused K2 kernel through the
    train CLI's ``model.attn=flash_hb``) and the given ``train.*``."""
    import dataclasses
    cfg = _smoke_cfg(workdir, steps)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name=SWIN),
        train=dataclasses.replace(cfg.train, **train))


def _state_tensors(state) -> list:
    """Every tensor of a ``TrainState`` (params, buffers, optimizer
    moments, EMA) in a fixed order, cloned on the card."""
    def walk(tree):
        if hasattr(tree, "detach"):
            return [tree.detach().clone()]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in walk(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in walk(v)]
        return []
    return walk(state.state_dict())


def _gib(n: int) -> float:
    return n / 2 ** 30


def _strict_swin(wa, dev, seed, workdir) -> dict:
    """Phase 22: Swin-T trained by the Trainer with ``train.strict=
    transfers`` and prefetch 2, 2 epochs of 4 steps and one eval. K2
    counted from zero just before ``train()``: 12 launches a forward
    (8 steps + 4 eval batches); one strict section a step; every epoch
    also armed whole by ``_NoSyncBetweenLogPoints`` (lifted only in the
    lagged fetches); the logged losses against a hand loop of the same
    step over the same loader's batches; a deliberate ``.item()`` inside
    a strict section raises."""
    import shutil
    import torch
    from deeplearning_tpu_torch.analysis import strict
    from deeplearning_tpu_torch.obs import flight
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = cli.build(_swin_cfg(workdir, strict="transfers"),
                        eval_every_epochs=2)
    guard = _NoSyncBetweenLogPoints(trainer)
    flight.get_recorder().clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.train()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wa.launch_counts()[wa.KERNEL_NAME]
    peak = torch.cuda.max_memory_allocated()
    steps = 2 * TRAINER_STEPS
    forwards = steps + TRAINER_STEPS
    logged = [e["metrics"]["loss"]
              for e in flight.get_recorder().events("step")]
    log(f"Swin-T Trainer (strict=transfers): {steps} steps + 1 eval in "
        f"{wall:.2f}s, {trainer.strict_sections} strict sections, "
        f"{guard.armed_steps} steps under the epoch guard, K2 launches "
        f"{launches} (want {SWIN_BLOCKS} x {forwards}), eval "
        f"{json.dumps(trainer._last_eval)}, losses "
        f"{[round(x, 5) for x in logged]}, peak device memory "
        f"{_gib(peak):.3f} GiB")
    check(launches == SWIN_BLOCKS * forwards,
          f"K2 launches == {SWIN_BLOCKS} x (steps + eval batches)")
    check(trainer.strict_sections == steps and guard.armed_steps == steps,
          "every step ran in a strict section")
    check(trainer.state.step == steps and len(logged) == steps
          and all(np.isfinite(logged)), "every step logged a finite loss")
    x = torch.ones(4, device=dev)
    try:
        with strict.strict_section(frozenset({"transfers"})):
            x.sum().item()
        raised = None
    except RuntimeError as exc:
        raised = str(exc).splitlines()[0]
    log(f"a deliberate .item() in a strict section: {raised!r}")
    check(raised is not None and torch.cuda.get_sync_debug_mode() == 0,
          "a fetch inside a strict section raises")
    del trainer
    torch.cuda.empty_cache()

    ref = cli.build(_swin_cfg(None))
    hand = []
    for epoch in range(2):
        ref.train_loader.set_epoch(epoch)
        for batch in ref.train_loader:
            ref.state, m = ref.train_step(ref.state, batch, ref.rng)
            hand.append(m["loss"])
    hand = [float(v) for v in hand]
    diff = max(abs(a - b) for a, b in zip(logged, hand))
    log(f"Swin-T Trainer vs hand loop: max |dloss| {diff:.3e} (tol "
        f"{TRAINER_LOSS_TOL})")
    check(len(hand) == steps and diff <= TRAINER_LOSS_TOL,
          "the strict Trainer's losses equal the hand loop's")
    del ref
    torch.cuda.empty_cache()
    return {"launches": launches, "peak": peak}


def _rollback_swin(wa, seed, workdir, peak_22) -> int:
    """Phase 23: ``DLTPU_FAULTS=nan@step:6`` with ``train.recovery=
    rollback`` and ``RecoveryPolicy(anchor_every=2)``: the parameters
    are poisoned after step 6, the lagged metrics surface the NaN, the
    Trainer rolls back to the newest verified anchor, reseeds the loader,
    damps a cooldown and finishes; the peak device memory (the pending
    anchors and the anchor, ~0.34 GB each) beside phase 22's."""
    import shutil
    import torch
    from deeplearning_tpu_torch.elastic import faults
    from deeplearning_tpu_torch.obs import flight
    from deeplearning_tpu_torch.train.recovery import (RecoveryManager,
                                                       RecoveryPolicy)
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    os.environ[faults.ENV_VAR] = "nan@step:6"
    faults.reset()
    try:
        trainer = cli.build(
            _swin_cfg(workdir, recovery="rollback"), eval_every_epochs=2,
            recovery=RecoveryManager(RecoveryPolicy(anchor_every=2)))
        flight.get_recorder().clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ[faults.ENV_VAR]
        faults.reset()
    launches = wa.launch_counts()[wa.KERNEL_NAME]
    peak = torch.cuda.max_memory_allocated()
    stats = trainer._recovery.stats()
    logged = [e["metrics"]["loss"]
              for e in flight.get_recorder().events("step")]
    with open(os.path.join(workdir, "flightrec.json")) as f:
        reason = json.load(f)["reason"]
    window = trainer.metrics_lag + trainer.log_every
    log(f"rollback: {json.dumps(stats)} in {wall:.2f}s, final step "
        f"{trainer.state.step}, last loss {logged[-1]:.5f}, flightrec "
        f"reason {reason!r}, K2 launches {launches}, peak device memory "
        f"{_gib(peak):.3f} GiB (phase 22: {_gib(peak_22):.3f} GiB)")
    check(stats["rollbacks"] == 1 and len(stats["skipped_windows"]) == 1,
          "one rollback")
    anchor, bad = stats["skipped_windows"][0]
    check(anchor < 6 <= bad <= 6 + window,
          f"skipped window [anchor, bad] with anchor < 6 <= bad <= "
          f"6 + {window}")
    # the rollback lands in epoch 1, which is replayed from the anchor
    check(np.isfinite(logged[-1]) and all(np.isfinite(trainer._last_eval[k])
                                          for k in trainer._last_eval)
          and trainer.state.step == anchor + TRAINER_STEPS,
          "the run finished from the anchor with a finite loss")
    check(reason == "recovered", "flightrec.json says 'recovered'")
    del trainer
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _preempt_swin(wa, seed, workdir) -> int:
    """Phase 24: with ``DLTPU_HEARTBEAT`` set, an ``after_iter`` hook sends
    SIGTERM to the process at step 5: ``Preempted`` at that step's
    boundary, the checkpoint of step 5 verified by CRC, ``flightrec.json``
    'preempted', the heartbeat's step >= 5; a fresh Trainer auto-resumes
    at step 5 with every tensor of the state (params, buffers, moments)
    bit-equal to the preempted one's, then trains to the end."""
    import shutil
    import signal
    import torch
    from deeplearning_tpu_torch.elastic import Preempted
    from deeplearning_tpu_torch.elastic import heartbeat as hb
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    beat = os.path.join(workdir, "heartbeat.json")
    os.environ[hb.ENV_VAR] = beat
    sent = []

    def sigterm_at_5(trainer, metrics):
        if trainer.host_step == 5 and not sent:
            sent.append(time.perf_counter())
            os.kill(os.getpid(), signal.SIGTERM)
    wa.reset_launch_counts()
    try:
        trainer = cli.build(_swin_cfg(workdir), eval_every_epochs=2)
        trainer.callbacks.register("after_iter", sigterm_at_5)
        try:
            trainer.train()
            check(False, "the SIGTERM preempts the run")
        except Preempted as exc:
            landed = time.perf_counter() - sent[0]
            step = exc.step
    finally:
        del os.environ[hb.ENV_VAR]
    before = _state_tensors(trainer.state)
    ok = trainer.ckpt.verify_step(5)
    with open(os.path.join(workdir, "flightrec.json")) as f:
        reason = json.load(f)["reason"]
    beat_step = hb.read_heartbeat(beat)["step"]
    log(f"preempted at step {step} ({landed:.2f}s from the signal to a "
        f"flushed checkpoint), steps on disk {trainer.ckpt.all_steps()}, "
        f"step 5 verified {ok}, flightrec reason {reason!r}, heartbeat "
        f"step {beat_step}")
    check(step == 5 and trainer.ckpt.latest_step() == 5 and ok,
          "Preempted at step 5 with its checkpoint verified")
    check(reason == "preempted" and beat_step >= 5,
          "flightrec 'preempted', heartbeat step >= 5")
    del trainer
    torch.cuda.empty_cache()
    fresh = cli.build(_swin_cfg(workdir), eval_every_epochs=2)
    equal = []
    fresh.callbacks.register("before_train", lambda t: equal.append(sum(
        torch.equal(a, b) for a, b in zip(_state_tensors(t.state), before))
        if t.state.step == 5 else -1))
    fresh.train()
    launches = wa.launch_counts()[wa.KERNEL_NAME]
    log(f"resume after preemption: {equal[0]}/{len(before)} tensors "
        f"bit-equal at step 5, trained to step {fresh.state.step}")
    check(equal == [len(before)], "the resumed state is bit-equal")
    check(fresh.state.step == 5 + TRAINER_STEPS, "trained to the end")
    del fresh, before
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _async_checkpoints(wa, dev, seed, workdir) -> int:
    """Phase 25: the same 8 Swin-T steps (2 epochs of 4, a checkpoint at
    each epoch's end) with ``async_checkpoint`` on and off, in turns, 3
    runs each, on one state. Per run: the seconds the loop blocks in
    ``save`` and in the Trainer's final ``wait_until_finished`` (which
    joins the last async write), the step time of epoch 1 (CUDA events;
    the async write of epoch 0's checkpoint runs beside it) and the host
    seconds of each of its dispatches, and the writer's seconds in the
    pinned copy and in ``torch.save``. The first async run allocates its
    pinned staging; the later ones take over the previous manager's
    buffers, as a run's second save does. Every written step verifies and
    restores bit-equal to the state at its own step (cloned when its save
    returned, before the next step was queued)."""
    import shutil
    import statistics
    import torch
    from deeplearning_tpu_torch.train.trainer import Trainer
    cli = _cli()
    base = cli.build(_swin_cfg(None))
    loader = base.train_loader.loader
    rows = {True: [], False: []}
    warm = None
    wa.reset_launch_counts()
    for i, arm in enumerate(ASYNC_RUNS):
        wd = f"{workdir}/{i}"
        shutil.rmtree(wd, ignore_errors=True)
        t = Trainer(state=base.state, train_step=base.train_step,
                    train_loader=loader, prefetch=2, seed=seed, epochs=2,
                    log_every=base.log_every, workdir=wd,
                    async_checkpoint=arm, log_backends=("csv",))
        staging = "none"
        if arm:
            staging = "cold" if warm is None else "warm"
            if warm is not None:
                t.ckpt._staging, t.ckpt._stream = warm._staging, warm._stream
        blocked, final, refs, marks, overlap = [], [], {}, [], []
        dispatch, host = [], {"to_host_s": [], "write_s": []}
        inside = []
        save, wait = t.ckpt.save, t.ckpt.wait_until_finished

        def timed(*a, _save=save, **k):
            inside.append(1)
            t0 = time.perf_counter()
            try:
                _save(*a, **k)
            finally:
                inside.pop()
            blocked.append(time.perf_counter() - t0)

        def timed_wait(_wait=wait):
            t0 = time.perf_counter()
            _wait()
            if not inside:
                final.append(time.perf_counter() - t0)

        def clocked(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                host[key].append(time.perf_counter() - t0)
                return out
            return run
        t.ckpt.save, t.ckpt.wait_until_finished = timed, timed_wait
        t.ckpt._to_host = clocked("to_host_s", t.ckpt._to_host)
        t.ckpt._write_step = clocked("write_s", t.ckpt._write_step)

        def on_ckpt(tr, step):
            refs[step] = _state_tensors(tr.state)

        def epoch_mark(tr):
            if tr.epoch == 1:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                w = tr.ckpt._writer
                overlap.append(w is not None and w.is_alive())

        def iter_mark(tr, **_):
            if tr.epoch == 1:
                dispatch.append(time.perf_counter())
        t.callbacks.register("on_checkpoint", on_ckpt)
        t.callbacks.register("before_epoch", epoch_mark)
        t.callbacks.register("after_epoch", epoch_mark)
        t.callbacks.register("before_iter", iter_mark)
        t.callbacks.register("after_iter", iter_mark)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = marks[0].elapsed_time(marks[1]) / TRAINER_STEPS
        same = total = 0
        for step, want in refs.items():
            check(t.ckpt.verify_step(step), f"step {step} verifies")
            got = torch.load(os.path.join(wd, "ckpt", str(step), "state.pt"),
                             map_location=dev, weights_only=True)
            have = []

            def walk(tree):
                if hasattr(tree, "detach"):
                    have.append(tree)
                elif isinstance(tree, dict):
                    for k in sorted(tree):
                        walk(tree[k])
                elif isinstance(tree, (list, tuple)):
                    for v in tree:
                        walk(v)
            walk(got)
            total += len(want)
            same += sum(torch.equal(a, b) for a, b in zip(have, want))
            check(len(have) == len(want), "every tensor was written")
        # host seconds of each epoch-1 dispatch (before_iter to after_iter)
        dispatch_ms = [1e3 * (b - a)
                       for a, b in zip(dispatch[::2], dispatch[1::2])]
        rows[arm].append({"blocked_s": sum(blocked), "saves": len(blocked),
                          "blocked_each_s": blocked,
                          "final_wait_s": sum(final),
                          "loop_blocked_s": sum(blocked) + sum(final),
                          "step_ms": step_ms,
                          "dispatch_ms": statistics.median(dispatch_ms),
                          "wall_s": wall, "staging": staging, **host,
                          "writer_busy_at_epoch_1": overlap[0],
                          "equal": f"{same}/{total}"})
        log(f"checkpoints {'async' if arm else 'sync'} run {i}: "
            f"{json.dumps(rows[arm][-1])}")
        check(same == total and len(refs) == 2,
              "every written step restores bit-equal to its own step")
        check(len(dispatch_ms) == TRAINER_STEPS, "every epoch-1 step timed")
        if arm:
            warm = t.ckpt
        del refs, t
        shutil.rmtree(wd, ignore_errors=True)
    launches = wa.launch_counts()[wa.KERNEL_NAME]
    for arm in (True, False):
        r = rows[arm]

        def med(key):
            return (f"{statistics.median(x[key] for x in r):.4f} (runs "
                    f"{[round(x[key], 4) for x in r]})")
        log(f"checkpoints {'async' if arm else 'sync'} ({len(r)} runs of "
            f"{2 * TRAINER_STEPS} steps, 2 saves each), medians: blocked "
            f"in save {med('blocked_s')} s, final wait {med('final_wait_s')}"
            f" s, loop blocked in all {med('loop_blocked_s')} s; epoch-1 "
            f"step {med('step_ms')} ms, its host dispatch "
            f"{med('dispatch_ms')} ms; staging "
            f"{[x['staging'] for x in r]}")
    del base, warm
    torch.cuda.empty_cache()
    return launches


def _folder_feed(wa, dev, seed, workdir) -> int:
    """Phase 26: 1 024 seeded uint8 ``.npy`` images of 256 x 256 x 3 in 8
    class folders, one of epoch 0's training files overwritten with
    garbage; ``build_classification_loaders`` (num_workers 8, augment
    imagenet, 224², batch 128) with ``quarantine=``; ``measure_throughput``
    over one epoch, then one Swin-T Trainer epoch from the folder (prefetch
    2) with its data-wait share, split into the set-up before the epoch,
    each step's host interval, data wait and dispatch, each step's device
    time (CUDA events at ``before_iter``) and the drain after the last
    step. Exactly one sample quarantined a pass,
    every batch full. Then the native libjpeg decode against PIL on JPEG
    copies of 64 of the images, where PIL imports."""
    import io
    import shutil
    import torch
    from deeplearning_tpu_torch.data import native_decode
    from deeplearning_tpu_torch.data.build import (
        LoaderConfig, build_classification_loaders, measure_throughput)
    from deeplearning_tpu_torch.data.datasets import read_split_data
    from deeplearning_tpu_torch.data.loader import epoch_indices
    from deeplearning_tpu_torch.data.quarantine import QuarantineLog
    from deeplearning_tpu_torch.obs import spans
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.train.trainer import Trainer
    shutil.rmtree(workdir, ignore_errors=True)
    root = os.path.join(workdir, "images")
    rng = np.random.default_rng(seed + 26)
    t0 = time.perf_counter()
    per_class = FOLDER_IMAGES // FOLDER_CLASSES
    for c in range(FOLDER_CLASSES):
        os.makedirs(os.path.join(root, f"class_{c}"))
        for i in range(per_class):
            np.save(os.path.join(root, f"class_{c}", f"{i:04d}.npy"),
                    rng.integers(0, 256, (FOLDER_SIZE, FOLDER_SIZE, 3),
                                 dtype=np.uint8))
    written = time.perf_counter() - t0
    cfg = LoaderConfig(global_batch=TRAIN_BATCH, image_size=224,
                       num_workers=8, seed=seed, augment="imagenet")
    split = read_split_data(root, cfg.val_rate, cfg.seed)
    first = int(epoch_indices(len(split["train_paths"]), shuffle=True,
                              seed=cfg.seed, epoch=0,
                              drop_last_to=TRAIN_BATCH)[0])
    bad_path = split["train_paths"][first]
    with open(bad_path, "wb") as f:
        f.write(b"not an array")
    qlog = QuarantineLog(os.path.join(workdir, "quarantine.jsonl"))
    train, val, classes = build_classification_loaders(
        root, cfg, device=dev, quarantine=qlog)
    n = len(train)
    ips = measure_throughput(train, n_batches=n - 1, warmup=1)
    after_measure = qlog.quarantined
    log(f"folder: {FOLDER_IMAGES} x {FOLDER_SIZE}² uint8 .npy in "
        f"{FOLDER_CLASSES} classes written in {written:.2f}s; "
        f"{len(split['train_paths'])} train / {len(split['val_paths'])} "
        f"val, {n} batches of {TRAIN_BATCH} an epoch; measure_throughput "
        f"(8 threads, imagenet augment, 224², moved to the card) "
        f"{ips:.1f} images/s; quarantined {after_measure}")
    check(after_measure == 1, "one sample quarantined in the measured epoch")

    state = _train_state("flash_hb", seed, dev, name=SWIN)
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    trainer = Trainer(state=state, train_step=step, train_loader=train,
                      prefetch=2, seed=seed, epochs=1, log_every=n,
                      log_backends=("csv",))
    sizes, stamps = [], {}

    def stamp(name):
        def hook(t, **kw):
            if "batch" in kw:
                sizes.append(int(kw["batch"]["image"].shape[0]))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.setdefault(name, []).append((time.perf_counter(), ev))
        return hook
    for name in ("before_epoch", "before_iter", "after_iter", "after_epoch"):
        trainer.callbacks.register(name, stamp(name))
    tracer = spans.enable()
    tracer.clear()
    wa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    launches = wa.launch_counts()[wa.KERNEL_NAME]
    span_s = {}
    for e in tracer.events():
        if e.get("ph") == "X":
            span_s.setdefault(e["name"], []).append(e["dur"] / 1e6)
    spans.disable()
    waits = sum(span_s.get("data_wait", []))
    (e0, _), = stamps["before_epoch"]
    (e1, ev1), = stamps["after_epoch"]
    bi, ai = stamps["before_iter"], stamps["after_iter"]
    parts = {
        "setup_s": e0 - t0,
        "to_first_batch_s": bi[0][0] - e0,
        "host_interval_ms": [1e3 * (b[0] - a[0]) for a, b in zip(bi, bi[1:])]
        + [1e3 * (ai[-1][0] - bi[-1][0])],
        "dispatch_ms": [1e3 * (b[0] - a[0]) for a, b in zip(bi, ai)],
        "data_wait_ms": [1e3 * x for x in span_s.get("data_wait", [])],
        "device_step_ms": [a[1].elapsed_time(b[1])
                           for a, b in zip(bi, bi[1:])]
        + [bi[-1][1].elapsed_time(ev1)],
        "drain_s": e1 - ai[-1][0],
        "after_epoch_s": t_end - e1,
        "metrics_flush_s": sum(span_s.get("metrics_flush", [])),
    }
    with open(qlog.path) as f:
        rows = [json.loads(line) for line in f]
    log(f"folder: one Swin-T Trainer epoch of {len(sizes)} steps from the "
        f"folder in {wall:.3f}s ({len(sizes) * TRAIN_BATCH / wall:.1f} "
        f"images/s), data-wait share {waits / wall:.4f}, batch sizes "
        f"{sizes}, K2 launches {launches}; quarantine rows "
        f"{[(r['index'], r['error'][:40]) for r in rows]}; classes "
        f"{len(classes)}, val batches {len(val)}")
    log(f"folder epoch split: {json.dumps(parts)}")
    check(sizes == [TRAIN_BATCH] * n, "every batch stays full")
    check(qlog.quarantined == 2 and {r["index"] for r in rows} == {first},
          "exactly one sample quarantined a pass, the corrupt one")
    check(launches == SWIN_BLOCKS * n, "K2 runs every step of the epoch")
    del trainer, state
    torch.cuda.empty_cache()

    native = native_decode.available()
    log(f"native decode: g++ {shutil.which('g++')}, jpeglib.h "
        f"{os.path.exists('/usr/include/jpeglib.h')}, built {native}")
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None or not native:
        log("JPEG: the native-against-PIL comparison did not run ("
            + ("PIL does not import" if Image is None else
               "the native decode did not build; single JPEGs decode "
               "through PIL") + ")")
    else:
        worst, decoded = 0, 0
        for path in split["val_paths"][:JPEG_IMAGES]:
            buf = io.BytesIO()
            Image.fromarray(np.load(path)).save(buf, format="JPEG",
                                                quality=95)
            blob = buf.getvalue()
            ref = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
            got = native_decode.decode_jpeg(blob)
            if got is None:
                continue
            check(got.shape == ref.shape, "native and PIL decode one shape")
            decoded += 1
            worst = max(worst, int(np.abs(got.astype(np.int16)
                                          - ref.astype(np.int16)).max()))
        log(f"JPEG: {decoded}/{JPEG_IMAGES} decoded natively, largest "
            f"|native - PIL| {worst} (uint8 levels)")
    shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ------------------ phases 27-31: detection training + COCO eval
DET_TRAIN_N = 64            # synthetic training images; evaluated in one call
YOLOX_TRAIN = ["data.n_train=64", "train.steps=24", "train.no_aug_steps=4",
               "train.multiscale_every=4"]
RETINA = "retinanet_resnet50_fpn"
# Adam at 1e-4: at the CLI's 1e-3 the first steps move every weight by
# ~1e-3 whatever its gradient, and both terms swing between batches (the
# total 2.0 -> 9-16 on the card). The JAX CLI does the same: R50-FPN at
# 256², batch 8, 20 classes, 12 steps on the CPU, its total goes 2.02 ->
# 9.07 -> ... -> 14.97 at 1e-3 and falls to 1.00 at 1e-4.
_R50_TRAIN = ["model.num_classes=20", "data.max_gt=50", "data.batch=8",
              f"data.n_train={DET_TRAIN_N}", "train.steps=12",
              "train.lr=1e-4"]
RETINA_TRAIN = [f"model.name={RETINA}", "model.image_size=512"] + _R50_TRAIN
FRCNN = "fasterrcnn_resnet50_fpn"
FRCNN_TRAIN = [f"model.name={FRCNN}", "model.image_size=800",
               "model.rcnn_post_nms_top_n=256",
               "model.rcnn_roi_batch=128"] + _R50_TRAIN
FRCNN_CANDIDATES = 4 * 1000 + 13 * 13 * 3   # p2-p5's top 1 000 + p6 at 800²
FCOS = "fcos_resnet50_fpn"
# 36 steps: its GIoU term barely moves in 12 (0.9999 -> 0.9996 on the
# card: the ltrb head starts at exp(~0), a pixel or two, against 102-256
# px boxes), and no score-0 box then matches a ground truth; by step 36 it
# is 0.97 and some do
FCOS_TRAIN = ([f"model.name={FCOS}", "model.image_size=512"] + _R50_TRAIN
              + ["train.steps=36"])
YOLOV5 = "yolov5s"
# hyp.scratch.yaml's geometric augmentation inside every mosaic. 48 steps,
# the last 16 on the raw arrays: the mosaics differ from run to run (the
# loader's threads draw them), and after 16 steps (the last 4 raw) or 32
# (8 raw) the score-0 boxes of a raw batch matched no ground truth in some
# runs on the card (AR100 0-0.13); after 48 / 16, 0.13-0.38 in 4 of 4
YOLOV5_TRAIN = [f"model.name={YOLOV5}", "model.num_classes=80",
                "model.image_size=640", "data.max_gt=50", "data.batch=8",
                f"data.n_train={DET_TRAIN_N}", "train.steps=48",
                "train.lr=1e-3", "data.mosaic=true",
                "data.random_perspective=true", "data.degrees=0",
                "data.translate=0.1", "data.scale=0.5", "data.shear=0",
                "train.no_aug_steps=16"]
STEADY_STEPS = 4            # steps of a resident batch under the sync guard


def _train_mode_forward(model, x):
    """The train-mode forward (batch statistics, as the loss sees it) with
    the running statistics restored after it."""
    import torch
    saved = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    with torch.no_grad():
        out = model(x)
        for k, v in model.named_buffers():
            v.copy_(saved[k])
    model.eval()
    return out


def _close_rel(got, want, tol=1e-5) -> bool:
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    return float((got.float() - want.float()).abs().max()) <= tol * scale


def _family_loss(name, out, b, num_classes):
    """(assignment tensors, loss terms) of one batch ``b`` from the raw
    output ``out`` on ``b``'s device: the terms every family's step sums,
    Faster R-CNN's RPN over every candidate anchor (no random draw)."""
    import torch
    from deeplearning_tpu_torch.models.detection import (faster_rcnn, fcos,
                                                         retinanet, yolov5,
                                                         yolox)
    from deeplearning_tpu_torch.ops import boxes as box_ops, matcher
    dev = b["image"].device
    hw = tuple(b["image"].shape[1:3])
    up = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    if name.startswith("yolox"):
        c, s = (up(a) for a in yolox.yolox_grid(hw))
        assign = yolox.simota_assign(yolox.decode_outputs(out, c, s), c, s,
                                     b["boxes"], b["labels"], b["valid"],
                                     num_classes)
        return assign, yolox.yolox_loss(out, c, s, b["boxes"], b["labels"],
                                        b["valid"], num_classes, use_l1=True)
    if name.startswith("retinanet"):
        a = up(retinanet.retinanet_anchors(hw))
        assign = {"matches": matcher.match_anchors(
            box_ops.box_iou(b["boxes"], a), b["valid"], 0.5, 0.4)}
        return assign, retinanet.retinanet_loss(out, a, b["boxes"],
                                                 b["labels"], b["valid"])
    if name.startswith("fcos"):
        locs, lvl = (up(a) for a in fcos.fcos_locations(hw))
        tgt = fcos.fcos_targets(locs, lvl, b["boxes"], b["labels"],
                                b["valid"])
        return tgt, fcos.fcos_loss(out, tgt)
    if name.startswith("yolov5"):
        grid = {k: up(v) for k, v in yolov5.yolov5_grid(hw).items()}
        return (yolov5.build_targets(grid, b["boxes"], b["labels"],
                                     b["valid"]),
                yolov5.yolov5_loss(out, grid, b["boxes"], b["labels"],
                                   b["valid"], num_classes))
    a = up(faster_rcnn.fasterrcnn_anchors(hw))
    assign = {"matches": matcher.match_anchors(
        box_ops.box_iou(b["boxes"], a), b["valid"], 0.7, 0.3)}
    gen = torch.Generator(device=dev).manual_seed(0)
    return assign, faster_rcnn.rpn_loss(
        out, a, b["boxes"], b["valid"], gen, batch_per_image=2 * len(a))


def _loss_card_vs_cpu(name, model, batch, num_classes) -> dict:
    """The family's assignment and loss of one batch from one raw output,
    on the card and on the CPU: integer assignments equal, float ones and
    every term within 1e-5."""
    import torch
    hw = tuple(batch["image"].shape[1:3])
    model.eval()
    with torch.no_grad():
        out = model(batch["image"])
    sides = {}
    for dev in (batch["image"].device, torch.device("cpu")):
        b = {k: v.to(dev) for k, v in batch.items()}
        o = (out.to(dev) if isinstance(out, torch.Tensor) else
             {k: v.to(dev) for k, v in out.items()
              if isinstance(v, torch.Tensor)})
        if name.startswith("fasterrcnn"):
            o["level_counts"] = out["level_counts"]
        with torch.no_grad():
            assign, terms = _family_loss(name, o, b, num_classes)
        sides[dev.type] = ({k: v.cpu() for k, v in assign.items()},
                           {k: float(v) for k, v in terms.items()})
    (ga, gt), (ca, ct) = sides["cuda"], sides["cpu"]
    same = all(torch.equal(ga[k], ca[k]) for k in ga
               if not ga[k].is_floating_point())
    floats_close = all(_close_rel(ga[k], ca[k]) for k in ga
                       if ga[k].is_floating_point())
    rel = {k: abs(gt[k] - ct[k]) / max(abs(ct[k]), 1e-12) for k in ct}
    log(f"{name} first batch at {hw[0]}², card vs CPU from one raw output: "
        f"assignment equal {same} (float targets within 1e-5: "
        f"{floats_close}), loss terms "
        f"{json.dumps({k: round(v, 5) for k, v in gt.items()})}, relative "
        f"difference {max(rel.values()):.2e}")
    check(same and floats_close, f"{name}: assignment on the card == CPU")
    check(max(rel.values()) <= 1e-5, f"{name}: loss on the card == CPU")
    return gt


def _steady_step_ms(sizes, step_ms) -> dict:
    """Median device-stream ms of the steps each bucket ran after its
    first (the first at a new size builds its grid and cuDNN plans)."""
    by = {}
    for i, (size, ms) in enumerate(zip(sizes, step_ms)):
        if i and sizes[i - 1] == size:
            by.setdefault(size, []).append(ms)
    return {size: statistics.median(v) for size, v in sorted(by.items())}


def _profile_steps(r, batch, iters=3) -> dict:
    """Device ms a step (the profiler's kernels and copies) and, inside
    it, of ``simota_assign`` (the profiler range ``yolox_loss`` opens
    around it; 0 for the other families) and of K3's kernel (Faster
    R-CNN's proposals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning_tpu_torch.serve.profile import (_device_total_us,
                                                      _device_us)
    r.state, _ = r.step(r.state, batch, r.key)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            r.state, _ = r.step(r.state, batch, r.key)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"device": sum(_device_us(e) for e in cuda
                         if e.key != "simota_assign"),
           "simota": sum(_device_total_us(e) for e in events
                         if e.device_type == torch.autograd.DeviceType.CPU
                         and e.key == "simota_assign"),
           "k3": sum(_device_us(e) for e in cuda
                     if "nms_greedy_sweep" in e.key)}
    out = {k: v / 1e3 / iters for k, v in out.items()}
    check(out["device"] > 0, "the profiler recorded device time")
    return out


def _roi_align_backward_ms(model, batch, cfg) -> float:
    """RoIAlign's backward at one step's RoIs (the proposals and gts of
    the batch, every image, as ``FasterRCNN.roi_heads`` aligns them): CUDA
    events around forward + backward less the forward alone."""
    import torch
    from deeplearning_tpu_torch.models.detection import faster_rcnn
    from deeplearning_tpu_torch.ops.roi_align import multiscale_roi_align
    x = batch["image"]
    hw = tuple(x.shape[1:3])
    out = _train_mode_forward(model, x)
    anchors = torch.from_numpy(faster_rcnn.fasterrcnn_anchors(hw)).to(
        x.device)
    props, _ = faster_rcnn.generate_proposals(
        out, anchors, hw, post_nms_top_n=cfg.model.rcnn_post_nms_top_n)
    rois = torch.cat([props, batch["boxes"]], dim=1)
    levels = sorted(out["pyramid"], key=lambda k: int(k[1:]))[:-1]
    feats = {k: out["pyramid"][k].detach().requires_grad_()
             for k in levels}

    def align():
        return torch.cat([multiscale_roi_align(
            {k: feats[k][i].permute(1, 2, 0) for k in levels}, rois[i],
            model.roi_output_size, strides={k: 2 ** int(k[1:])
                                            for k in levels},
            impl=model.roi_align_impl) for i in range(len(rois))])

    def forward():
        with torch.no_grad():
            align()

    def both():
        torch.autograd.grad(align().sum(), list(feats.values()))
    return _time_ms(both, iters=5, warmup=2) - _time_ms(forward, iters=5,
                                                         warmup=2)


def _rcnn_step_checks(r, batch, cfg) -> None:
    """Phase 29 on one step's batch: the RPN's candidate count, its
    proposals through K3 == through the plain sweep, ``generate_proposals``
    and ``sample_rois`` under sync debug mode "error", and
    ``balanced_sample``'s counts on the card."""
    import torch
    from deeplearning_tpu_torch.models.detection import faster_rcnn
    from deeplearning_tpu_torch.ops import boxes as box_ops, matcher
    x = batch["image"]
    hw = tuple(x.shape[1:3])
    out = _train_mode_forward(r.model, x)
    n_cand = sum(min(1000, c) for c in out["level_counts"])
    log(f"{FRCNN} RPN candidates an image at {hw[0]}²: {n_cand} "
        f"(levels {out['level_counts']}), batch {len(x)}")
    check(n_cand == FRCNN_CANDIDATES and len(x) == 8,
          f"{FRCNN}: K3 sees 8 x {FRCNN_CANDIDATES} candidates in the step")
    anchors = torch.from_numpy(faster_rcnn.fasterrcnn_anchors(hw)).to(
        x.device)
    post = cfg.model.rcnn_post_nms_top_n
    labels1 = torch.where(batch["valid"], batch["labels"] + 1, 0)
    gen = torch.Generator(device=x.device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        props, pvalid = faster_rcnn.generate_proposals(
            out, anchors, hw, post_nms_top_n=post, nms_impl="auto")
        samples = faster_rcnn.sample_rois(
            props, pvalid, batch["boxes"], labels1, batch["valid"], gen,
            batch_per_image=cfg.model.rcnn_roi_batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    plain, plain_valid = faster_rcnn.generate_proposals(
        out, anchors, hw, post_nms_top_n=post, nms_impl="blocked")
    check(torch.equal(props, plain) and torch.equal(pvalid, plain_valid),
          f"{FRCNN}: the step's proposals through K3 == the plain sweep's")
    matches = matcher.match_anchors(box_ops.box_iou(batch["boxes"], anchors),
                                    batch["valid"], 0.7, 0.3)
    pos, neg = matcher.balanced_sample(matches, gen, 256, 0.5)
    cand = (matches >= 0) | (matches == matcher.BELOW_LOW)
    rpn_n, rpn_pos = (pos | neg).sum(-1), pos.sum(-1)
    roi_n, roi_pos = samples["sample"].sum(-1), samples["pos"].sum(-1)
    all_valid = torch.cat([pvalid, batch["valid"]], dim=1)
    log(f"{FRCNN} in one step: proposals through K3 == plain sweep "
        f"({int(pvalid.sum())} valid of {pvalid.numel()}); "
        "generate_proposals and sample_rois raised nothing under sync debug "
        f"mode 'error'; RPN samples an image {rpn_n.tolist()} "
        f"(positives {rpn_pos.tolist()}), RoIs {roi_n.tolist()} "
        f"(positives {roi_pos.tolist()})")
    check(torch.equal(rpn_n, cand.sum(-1).clamp(max=256))
          and bool((rpn_pos <= 128).all())
          and torch.equal(rpn_pos, (matches >= 0).sum(-1).clamp(max=128)),
          f"{FRCNN}: balanced_sample on the card keeps its RPN counts")
    check(bool((roi_n <= 128).all()) and bool((roi_pos <= 32).all())
          and not bool((samples["sample"] & ~all_valid).any()),
          f"{FRCNN}: at most 128 RoIs, 32 positive, no padded proposal")


def _postprocess_at_zero(name, model, x, cfg):
    """One eval batch through the family's postprocess at score threshold
    0 over every candidate (YOLOX / YOLOv5: every anchor; RetinaNet /
    FCOS: their 1 000 top candidates an image; Faster R-CNN: every
    (proposal, class) pair), with K3 and with the plain sweep on one
    forward: equal detections. Returns (alive, kept, {"auto": K3's
    detections, "blocked": the plain sweep's}), labels 0-based. The
    forward normalises with the batch's statistics, as the loss saw it
    (the running statistics, a few steps from their start, put every
    YOLOX-S box of a 24-step network apart: nothing to suppress)."""
    import torch
    from deeplearning_tpu_torch.models.detection import (faster_rcnn, fcos,
                                                         retinanet, yolov5,
                                                         yolox)
    hw = tuple(x.shape[1:3])
    out = _train_mode_forward(model, x)
    up = lambda a: torch.from_numpy(a).to(x.device)      # noqa: E731
    impls = ("auto", "blocked")
    if name.startswith("yolox"):
        c, s = (up(a) for a in yolox.yolox_grid(hw))
        dets = {impl: yolox.yolox_postprocess(
            out, c, s, score_thresh=0.0, max_det=out.shape[1],
            nms_impl=impl) for impl in impls}
        dec = yolox.decode_outputs(out, c, s)
        score = (torch.sigmoid(dec[..., 4:5]) * torch.sigmoid(dec[..., 5:])
                 ).amax(dim=-1)
    elif name.startswith("yolov5"):
        grid = {k: up(v) for k, v in yolov5.yolov5_grid(hw).items()}
        dets = {impl: yolov5.yolov5_postprocess(
            out, grid, score_thresh=0.0, max_det=out.shape[1],
            nms_impl=impl) for impl in impls}
        score = (torch.sigmoid(out[..., 4:5]) * torch.sigmoid(out[..., 5:])
                 ).amax(dim=-1)
    elif name.startswith("retinanet"):
        anchors = up(retinanet.retinanet_anchors(hw))
        dets = {impl: retinanet.retinanet_postprocess(
            out, anchors, hw, score_thresh=0.0, max_det=1000, nms_impl=impl)
            for impl in impls}
        score = torch.sigmoid(out["cls_logits"]).reshape(
            x.shape[0], -1).topk(1000).values
    elif name.startswith("fcos"):
        locs = up(fcos.fcos_locations(hw)[0])
        dets = {impl: fcos.fcos_postprocess(
            out, locs, hw, score_thresh=0.0, max_det=1000, nms_impl=impl)
            for impl in impls}
        score = torch.sqrt(torch.sigmoid(out["cls_logits"]) * torch.sigmoid(
            out["centerness"])[..., None]).reshape(x.shape[0], -1).topk(
                1000).values
    else:
        anchors = up(faster_rcnn.fasterrcnn_anchors(hw))
        props, pvalid = faster_rcnn.generate_proposals(
            out, anchors, hw, post_nms_top_n=cfg.model.rcnn_post_nms_top_n)
        with torch.no_grad():
            model.eval()
            out2 = model(x, proposals=props, pyramid=out["pyramid"])
        pairs = props.shape[1] * (out2["roi_scores"].shape[-1] - 1)
        dets = {impl: faster_rcnn.fasterrcnn_postprocess(
            out2["roi_scores"], out2["roi_deltas"], props, hw,
            prop_valid=pvalid, score_thresh=0.0, max_det=pairs,
            nms_impl=impl) for impl in impls}
        for d in dets.values():            # 1-based model classes -> 0-based
            d["labels"] = torch.where(d["valid"], d["labels"] - 1,
                                      d["labels"])
        score = torch.where(pvalid[..., None], torch.softmax(
            out2["roi_scores"], dim=-1)[..., 1:], 0.0)
    torch.cuda.synchronize()
    check(all(torch.equal(dets["auto"][k], dets["blocked"][k])
              for k in dets["auto"]),
          f"{name} detections through K3 == through the plain sweep "
          f"(every candidate)")
    return int((score > 0).sum()), int(dets["auto"]["valid"].sum()), dets


def _score_at_zero(name, dets, gt, num_classes) -> None:
    """The score-0 detections of one batch through the COCO evaluator:
    K3's with the C++ matcher and with numpy, the plain sweep's with the
    C++ matcher. Some detections match a ground truth (AR100 > 0) and the
    three summaries are equal; the host seconds of ``summarize`` on each
    matching path, in turns (C++, numpy, numpy, C++)."""
    from deeplearning_tpu_torch.evaluation.coco_eval import CocoEvaluator
    from deeplearning_tpu_torch.native.build import load
    check(load("cocoeval") is not None,
          "the C++ COCO matcher builds and loads")
    ids = np.arange(len(gt["boxes"]))
    k3 = CocoEvaluator(num_classes)
    k3.add_batch(ids, dets["auto"], gt=gt)
    plain = CocoEvaluator(num_classes)
    plain.add_batch(ids, dets["blocked"], gt=gt)
    summaries, secs = {}, {}
    for use_cpp in (True, False, False, True):
        k3.use_cpp = use_cpp
        t0 = time.perf_counter()
        summaries[use_cpp] = k3.summarize()
        secs.setdefault(use_cpp, []).append(time.perf_counter() - t0)
    n_dets = sum(len(d["scores"]) for d in k3._dts.values())
    log(f"{name} at score 0, {len(ids)} images, {n_dets} detections: COCO "
        f"summary {json.dumps(summaries[True])}; evaluator host seconds "
        f"C++ matcher {min(secs[True]):.4f}s, numpy {min(secs[False]):.4f}s")
    check(summaries[True]["AR100"] > 0,
          f"{name}: some score-0 detections match a ground truth")
    check(summaries[True] == summaries[False],
          f"{name}: C++ and numpy summaries equal at score 0")
    check(plain.summarize() == summaries[True],
          f"{name}: the plain sweep's COCO summary == K3's at score 0")


def _feed_images_per_s(cfg, dev, batches=6) -> float:
    """Images a second of the mosaic feed alone: the CLI's source and
    loader (``data.num_workers`` threads, prefetch ``data.prefetch``),
    timed over ``batches`` batches after its first."""
    import torch
    from deeplearning_tpu_torch.data.device_prefetch import DevicePrefetcher
    from deeplearning_tpu_torch.data.loader import DataLoader
    from deeplearning_tpu_torch.data.mixup import mosaic_array_source
    from deeplearning_tpu_torch.train import detection as det
    arrays = det.synthetic_boxes(cfg.data.n_train, cfg.model.image_size,
                                 cfg.model.num_classes, cfg.data.max_gt,
                                 cfg.train.seed)
    src = mosaic_array_source(
        *arrays, out_size=cfg.model.image_size, max_boxes=cfg.data.max_gt,
        seed=cfg.train.seed, fill=float(np.median(arrays[0][0])),
        perspective=dict(degrees=cfg.data.degrees,
                         translate=cfg.data.translate, scale=cfg.data.scale,
                         shear=cfg.data.shear))
    loader = DataLoader(src, cfg.data.batch, shuffle=True, seed=0,
                        infinite=True, device=dev,
                        num_workers=cfg.data.num_workers)
    feed = DevicePrefetcher(loader, depth=cfg.data.prefetch)
    it = iter(feed)
    try:
        next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        torch.cuda.synchronize()
        return batches * cfg.data.batch / (time.perf_counter() - t0)
    finally:
        getattr(it, "close", lambda: None)()


def _train_and_score(nms_ops, dev, seed, name, overrides) -> int:
    """Phases 27-31: ``train.detection`` at full width on the card
    (``build``, ``train_steps``, ``evaluate``, as ``run`` calls them), its
    checks and timings. Returns K3's launches in the run: Faster R-CNN's
    once a train step, every family's once a predict call (Faster
    R-CNN's twice)."""
    import contextlib
    import io
    import torch
    from deeplearning_tpu_torch.core.config import load_config
    from deeplearning_tpu_torch.models.detection.predict import (
        build_predict_fn)
    from deeplearning_tpu_torch.train import detection as det
    cfg = load_config(det.DetConfig(), None,
                      overrides + [f"train.seed={seed}"])
    rcnn = name.startswith("fasterrcnn")
    every = max(cfg.train.steps // 5, 1)
    torch.cuda.synchronize()
    nms_ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = det.build(cfg)
    # a step's device-stream interval runs from the previous step's end:
    # its batch's copy and resize are in it
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    sizes, logged, batch, printed = [], {}, None, io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            for it, b, metrics in det.train_steps(r):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                sizes.append(int(b["image"].shape[1]))
                batch = b if it == 0 else batch
                if it % every == 0:
                    logged[it] = {k: float(v) for k, v in metrics.items()}
    finally:
        r.close()
    train_k3 = nms_ops.launch_counts()["nms_greedy_sweep"]
    summary, ev, calls = det.evaluate(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = nms_ops.launch_counts()["nms_greedy_sweep"]
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    terms = {k: {t: round(v, 4) for t, v in m.items()}
             for k, m in logged.items()}
    if printed.getvalue():
        log(printed.getvalue().rstrip())
    log(f"{name} trained {cfg.train.steps} steps at {cfg.model.image_size}² "
        f"(batch {cfg.data.batch}, Adam lr {cfg.train.lr}, buckets "
        f"{sorted(set(sizes))}) and evaluated in {wall:.1f}s; logged "
        f"{json.dumps(terms)}; K3 launches {train_k3} in training, "
        f"{launched - train_k3} over {len(calls)} predict calls")
    check(all(np.isfinite(v) for m in logged.values() for v in m.values()),
          f"{name}: every logged loss is finite")
    # the last logged step before the closing steps (mosaic ends, YOLOX
    # adds its L1 term to the total)
    close_at = cfg.train.steps - cfg.train.no_aug_steps
    last = max(k for k in logged if k < close_at)
    check(logged[last]["loss"] < logged[0]["loss"],
          f"{name}: the loss at step {last} is below step 0's")
    if cfg.train.no_aug_steps:
        check(f"step {close_at}: closing mosaic/perspective"
              in printed.getvalue(), f"{name}: the closing line printed")
    check(train_k3 == (cfg.train.steps if rcnn else 0),
          f"{name}: K3 launches once a train step (Faster R-CNN) or never")
    check(len(calls) > 0
          and launched - train_k3 == len(calls) * (2 if rcnn else 1),
          f"{name}: K3 launches {2 if rcnn else 1} a predict call")
    check(len(summary) == 12 and all(np.isfinite(v)
                                     for v in summary.values()),
          f"{name}: the 12-metric summary is finite")
    log(f"{name} COCO summary after {cfg.train.steps} steps (random weights "
        f"from the seed, logged only): {json.dumps(summary)}")

    # the evaluation again through the plain sweep (before any other step
    # moves the weights): the same detections and summary
    plain = build_predict_fn(r.model, name, cfg.model.num_classes,
                             score_thresh=cfg.train.eval_score_thresh,
                             max_det=det.EVAL_MAX_DET,
                             post_nms_top_n=cfg.model.rcnn_post_nms_top_n,
                             nms_impl="blocked")
    plain_summary, _, again = det.evaluate(r, plain)
    k3, again = calls[0], again[0]
    torch.cuda.synchronize()
    check(all(torch.equal(k3[k], again[k]) for k in ("valid", "labels"))
          and float((k3["scores"] - again["scores"]).abs().max()) <= 1e-6
          and float((k3["boxes"] - again["boxes"]).abs().max()) <= 1e-3,
          f"{name}: eval detections through K3 == the plain sweep's")
    check(plain_summary == summary,
          f"{name}: the plain sweep's COCO summary == K3's")
    ev.use_cpp = False
    check(ev.summarize() == summary,
          f"{name}: C++ and numpy summaries equal")
    valid = int(k3["valid"].sum())
    images = torch.from_numpy(r.arrays[0]).to(dev)
    x = images[:cfg.data.batch]
    t_pred = _time_ms(lambda: r.predict_fn(images), iters=3, warmup=1)
    t_batch = _time_ms(lambda: r.predict_fn(x), iters=5, warmup=1)
    log(f"{name} eval: {valid} detections pass score "
        f"{cfg.train.eval_score_thresh} (== plain sweep); predict "
        f"{t_pred:.2f} ms for the {len(images)}-image call, {t_batch:.2f} "
        f"ms a batch of {len(x)}")
    # few or no scores pass 0.3 this early: the comparisons above may hold
    # nothing, so one batch again at score 0 with every candidate kept
    alive, kept, dets = _postprocess_at_zero(name, r.model, x, cfg)
    log(f"{name} at score 0 over every candidate: K3 == plain, alive "
        f"{alive}, kept {kept}, suppressed {alive - kept}")
    check(alive > 0 and alive - kept > 0,
          f"{name}: candidates alive and suppressed at score 0")
    _score_at_zero(name, dets, {k: a[:len(x)] for k, a in zip(
        ("boxes", "labels", "valid"), r.arrays[1:])},
        cfg.model.num_classes)
    if rcnn:
        _rcnn_step_checks(r, batch, cfg)

    log(f"{name} step ms (CUDA events) by step: " + ", ".join(
        f"{size}²: {ms:.1f}" for size, ms in zip(sizes, step_ms)))
    steady = _steady_step_ms(sizes, step_ms)
    log(f"{name} steady train step by bucket (CUDA events, median of the "
        f"steps after a bucket's first): " + ", ".join(
            f"{s}²: {ms:.2f} ms ({cfg.data.batch / ms * 1e3:.1f} img/s)"
            for s, ms in steady.items()))
    size = batch["image"].shape[1]
    prof = _profile_steps(r, batch)
    device_ms = prof["device"]
    steady_ms = steady.get(size, statistics.median(step_ms))
    shares = (f"simota_assign {prof['simota']:.2f} ms "
              f"({prof['simota'] / device_ms:.1%})"
              if name.startswith("yolox") else
              f"K3 {prof['k3']:.4f} ms ({prof['k3'] / device_ms:.2%})")
    if rcnn:
        roi_bwd = _roi_align_backward_ms(r.model, batch, cfg)
        shares += (f"; RoIAlign backward at the step's RoIs {roi_bwd:.2f} "
                   f"ms ({roi_bwd / device_ms:.1%}, CUDA events)")
    log(f"{name} at {size}²: {device_ms:.2f} ms device time a step "
        f"(profiler, 3 steps), idle {1 - device_ms / steady_ms:.3f} of the "
        f"steady step; {shares}")
    if cfg.data.mosaic:
        rate = _feed_images_per_s(cfg, dev)
        log(f"{name} mosaic + perspective feed alone: {rate:.1f} images/s "
            f"({cfg.data.num_workers} threads, prefetch {cfg.data.prefetch})"
            f" beside the steady step's "
            f"{cfg.data.batch / steady_ms * 1e3:.1f}")
    # steady steps with the batch resident under the sync guard
    r.state, _ = r.step(r.state, batch, r.key)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEADY_STEPS):
            r.state, metrics = r.step(r.state, batch, r.key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(metrics["loss"])),
          f"{name}: guarded steps finite")
    log(f"{name}: {STEADY_STEPS} steady steps under sync debug mode 'error' "
        f"raised nothing")
    _loss_card_vs_cpu(name, r.model, batch, cfg.model.num_classes)
    return launched


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
