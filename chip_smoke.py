#!/usr/bin/env python
"""Card smoke test of the PyTorch/CUDA port: build, check, serve, train, measure.

    python chip_smoke.py            # one NVIDIA Hopper card (sm_90)

Phases (any failure raises and exits non-zero; nothing is skipped):

1. build the CUDA kernels from ``deeplearning_tpu_torch/csrc`` (nvcc,
   first use) and print the build seconds and the ptxas register report
   (phase 60's g++ builds start with the script, in a thread joined at
   60);
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
   exactly on the invalid ones, and equals ``engine.run`` of the batch it
   went out in, at its row (an image's bits depend on its row in the
   batch, so ``engine.infer`` in index order is no reference; against
   bucket 1 the top-20 overlap is logged only, since the calibrated random
   network amplifies bf16 rounding differences between cuDNN's per-shape
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
   class -1 exactly on the invalid ones and equal to ``engine.run`` of
   the batch it went out in, at its row; on one batch of the
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
   off, in turns, 2 runs each: the seconds the loop blocks in ``save``,
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

32. int8 residency: ViT-B/16 (flash_hb, buckets 1/8) and YOLOX-S (640²,
   BatchNorm statistics calibrated as in phase 13, score 0) built by
   ``InferenceEngine`` with ``weight_quant`` "fp32" and "int8": resident
   bytes by ``variables_nbytes()`` and by the ``memory_allocated`` delta
   of each build (ViT-B/16's int8 at least 3.5x denser by both); the
   card's dequantized weights bit-equal to a CPU int8 engine's from the
   same weights; int8 against float32 on seeded images (ViT top-1
   agreement, YOLOX kept-set sizes); bucket-1 and bucket-8 latency of
   both, in turns; the dequantize alone (CUDA events);
33. the zoo: ViT-B/16 float32 and int8, Swin-T (the fused K2) and
   YOLOX-S in one ``ModelZoo`` built by the serve CLI's ``build_zoo``
   (preloaded on their ``zoo-load-*`` threads: K1 and K2 launched there),
   behind ``serve_http`` on a thread of this process: 64 requests from 8
   threads over HTTP, mixed across the four tenants, each answer equal to
   a solo engine's (the same weights) at one of its buckets; ``/metrics``
   parsed: four warm tenants, ``trace_count`` == 2 each; ``POST
   /admin/brownout/vit/2`` demotes ViT to int8 and its next request
   reloads it int8-resident, answering as the int8 tenant; ``POST
   /admin/evict/swin``, then a request reloads it and answers as before;
   K1, K2 and K3 launched through the zoo. Then ``python -m
   deeplearning_tpu_torch.serve --zoo @spec --http 0`` in a process of its
   own: the ready line, one answer, a SIGTERM drain that exits 0;
34. eviction by the card's own reading: three ViT-B/16 tenants; with two
   resident the alert fraction is set from ``hbm_snapshot``'s reading so
   that the third load projects past it: the least-recently-used tenant
   goes, the reading (recorded, not stubbed) falls by at least 90% of its
   bytes, the third loads; with both residents busy, a load answers 429
   ``hbm_pressure`` over HTTP;
35. phase 19's ViT-B/16 Trainer run (8 steps and an eval) with
   ``metrics_port=0``, ``hbm_sample_s=0.05`` and ``strict=transfers``:
   ``/metrics`` scraped mid-run (train step, loss and the sampler's
   gauge), the sampler's peak at least ``max_memory_allocated``, and every
   loss equal to the same run's without the sampler and the server;
36. checkpoints and new sizes: ViT-B/16 trained 2 steps through the
   Trainer with EMA (phase 19's set-up), its step directory served by
   ``hub.serve`` (buckets 1/8): the weights are the EMA's and every answer
   equals an engine's built from the same EMA weights in memory (bit for
   bit). The checkpoint restored by ``restore_variables`` and loaded by
   ``surgical_load(default_resize_fn)`` into ViT-B/16 at 384² (pos_embed
   resized to 577 tokens: K1 at N = 577, its last key tile one row), served
   at buckets 1 and 8 against a naive-attention engine on the same weights
   (log-probabilities within 0.05); a Swin-T window-7 224² state loaded
   into Swin-T at 384² with window 12 (the 12 bias tables resized 13² ->
   23²: K2 at N = 144, d = 32), served at bucket 8 against the unfused
   engine. K1 (B = 8 and 1) and K2 (Swin-T 384²'s four stages at batch 8)
   against their plain versions at those shapes (bf16, 2e-2), and timed by
   graph replay beside their bounds; restore and surgical-load seconds;
37. classification flip-TTA: the checkpoint served with ``tta=True``
   (buckets 1/8): K1 24 launches a TTA forward, trace and compile counts at
   2, answers the mean of the plain engine's softmax over the images and
   their mirror images (1e-6); latency at buckets 1 and 8 against the
   plain engine, in turns;
38. YOLOX-S at 640² through ``train.detection`` (4 steps on 32 images)
   scored with ``train.eval_tta`` at score 0.01: the plain evaluation and
   the TTA one (views 640, 544 flipped and 416), K3 once a predict call;
   the TTA call's 32 x 18 018 candidates through K3 and through the plain
   sweep, equal keep sets; K3 there by graph replay beside its bound; the
   two predict calls in turns (CUDA events);
39. the supervised serve CLI: ``python -m deeplearning_tpu_torch.serve
   --ckpt <step> --http 0`` in a process of its own under
   ``DLTPU_HEARTBEAT``, ``DLTPU_STANDBY=1``, ``DLTPU_TRACE=1`` and
   ``DLTPU_FAULTS=preempt_replica:0@step:3``: 503 until ``/admin/promote``,
   then three answers with the heartbeat's step following the dispatches,
   exit 75 with ``trace.json`` holding the three dispatch spans; again
   with ``crash_replica:0@step:1``: an exit code neither 0 nor 75; then the
   CLI in stdin mode in this process: a seeded PNG answers as the ``.npy``
   preprocessed from it;
40. the mesh step: a world-size-1 NCCL group started in this process
   (127.0.0.1, a free port), the ``data=-1`` mesh, and ViT-B/16 at full
   width (batch 128, flash_hb, phase 6's AdamW, schedule and loss) placed
   by ``shard_state`` and trained through ``make_train_step(mesh=...)`` in
   four modes, 3 steps each: replicated float32, ZeRO-1, int8 and
   ZeRO-1 + int8. K1's and the collectives' counters are zeroed just
   before each run and read just after: 12 forward, 12 dQ and 12 dK/dV
   launches a step, one packed all-reduce of the gradients and one of the
   metrics a float32 step, two ``all_to_all`` and two ``all_gather`` an
   int8 step.
   After one step the replicated and ZeRO-1 states hold params and Adam
   moments bit-equal to the step without a mesh on the same weights and
   batch; the int8 steps' first loss equals it and their ``grad_norm`` is
   within 2/127 relative; every metric is finite; 8 int8 steps at
   constant lr 1e-4 on the fixed batch lower the loss;
41. measure, in turns: the step time and images/s of the step without a
   mesh and of the float32, ZeRO-1, int8 and ZeRO-1 + int8 mesh steps
   (median of 6 runs of 3 steps); the int8 block quantize and dequantize
   of ViT-B/16's 86 M float32 gradients by CUDA-graph replay beside their
   bytes bound; the one-rank NCCL all-reduce of the same 344 MB and the
   packed int8 reduction of them (CUDA events);
42. the Trainer on the mesh: the train CLI's ``build`` with
   ``train.weight_update=zero1`` over the running group: 2 steps and one
   evaluation, K1 launches counted, a checkpoint whose ``topology.json``
   records ``weight_update: zero1``; ``elastic_restore`` of it into a
   replicated state (params and moments bit-equal to the Trainer's,
   ``topology_changed`` true: the weight-update mode changed);
   ``make_eval_step(mesh)`` equal to the step without a mesh on a batch;
   ``agree_preempt_step`` at one rank returns its own step. The process
   group is destroyed after it;
43. two ranks on the one card: NCCL refuses two ranks on one device, so
   two processes of this script (``--mesh-rank``) join a gloo group
   (which moves CUDA tensors) on ``cuda:0`` and train ViT-B/16 at full
   width with ZeRO-1 and the int8 collectives, 64 images a rank (the
   global batch of 128 split), 2 steps: in each, K1's counters read 12 +
   12 + 12 a step, both report the same averaged losses, the first within
   1e-3 of phase 40's step without a mesh on the whole batch, and a rank
   holds half of AdamW's moment bytes plus the leaves no even dim splits.
   Their launches are checked in the processes, not added to the kernels
   line. This shows the layout and the collectives on the card, not a
   speed: gloo stages every collective through the host;
44. the ring and Ulysses over one NCCL rank (the world-size-1 group
   started again, a ``seq = 1`` mesh) at ViT-B/16's training shape (B =
   128, H = 12, N = 197, D = 64, bf16): ``make_ring_attention`` and
   ``make_ulysses_attention`` on K1, forward + backward through autograd,
   each counted from zero just before its call: one K1 forward, one dQ
   and one dK/dV launch and no collective; the forward bit-equal to K1's
   ``flash_attention``, dq/dk/dv within phase 5's bf16 tolerance of K1's
   backward; then the ring's forward + backward and K1's, in turns, by
   CUDA-graph replay (at one rank the ring issues no collective, so the
   whole call captures);
45. two processes of this script on ``cuda:0`` over gloo, a data 1 x seq
   2 mesh: ViT-B/16 at full width at 240² (N = 226, 113 a rank; 6 heads
   a rank for Ulysses), batch 16 (each rank the whole batch), phase 6's
   AdamW and loss through ``make_train_step(mesh=...)``: 2 steps with
   ``make_ring_attn_fn(use_flash=True)`` (24 K1 forward, 24 dQ and 24
   dK/dV launches a step on each rank), then 2 with
   ``make_ulysses_attn_fn(use_flash=True)`` (12 + 12 + 12); both ranks
   report one loss, the first within 5e-3 relative and its ``grad_norm``
   within 5e-2 of the step without sequence parallelism on the same
   weights and batch (run here first);
46. two processes on ``cuda:0`` over gloo, ``model = 2``: ViT-B/16 at
   224², its 12 blocks as 2 GPipe stages of 6 (flash_hb) over 4
   microbatches of a batch of 32, two steps of
   ``parallel.pipeline_train.make_pipeline_train_step``: (2 + 4 - 1) x 6
   = 30 launches of each K1 kernel a step on each rank, both stages report
   the same metrics, the first loss within 5e-3 of the sequential step's;
   then the train CLI's Trainer with ``train.pipeline_stages=2
   train.microbatches=4`` over the same group: 2 steps and an evaluation,
   its checkpoint holding the whole stacked state;
47. first, here, K1's forward and both backward kernels against their
   plain versions at the head counts only tensor parallelism gives them
   (batch 8: 6 heads x 197 tokens at model 2, 2 heads a CTA and 1; 3
   heads at model 4, 1 a CTA; 6 heads x 113 tokens, the ring's chunks,
   with the chunk gradients), bf16 and float32, at phases 2 and 5's
   tolerances; then two processes on ``cuda:0`` over gloo, ``model =
   2``: ViT-B/16 at 224² (flash_hb) placed under ``TRANSFORMER_TP_RULES``, its blocks
   Megatron's column- and row-parallel layers on 6 heads a rank, batch 8
   (each rank the whole batch), phase 6's AdamW and loss, two steps of
   ``make_train_step(mesh=...)`` in float32, then two in bf16: 12 K1
   forward, 12 dQ and 12 dK/dV launches a step on each rank, 4 x 12 + 3
   all-reduces a step (proj's and fc2's partial sums, the gradients of
   the qkv and fc1 inputs, then the packed gradients, the metrics and the
   norm's sum); against the steps without a mesh on the same weights and
   batch (run here first) the float32 first loss within 1e-5 and its
   ``grad_norm`` within 1e-4, relative, bf16 within 1e-3 (a row-parallel
   split sums in another order, which flips a few bf16 roundings in a
   thousand: on an H100 it moved the first loss by 2.3e-4 with float32
   partials, 3.5e-5 with the bf16 partials summed here); the leaves the
   layout does not split bit-equal on both ranks after the steps; the bf16
   state's bytes beside the replicated state's; ``make_eval_step(mesh)``
   on it; a checkpoint holding the whole ViT in the plain state's layout,
   which cuts back to each rank's slices; then the train CLI with
   ``train.mesh_model_axis=2`` over the same group (a model axis,
   replicated as ``tools/train.py`` places it): 2 steps and an
   evaluation;
48. four processes on ``cuda:0`` over gloo, a model 2 x seq 2 mesh:
   ViT-B/16 at 240² under the TP rules with ``make_ring_attn_fn(
   use_flash=True)`` on 6 heads of 113-token chunks, batch 8, two steps
   in float32 and two in bf16: 24 K1 forward, 24 dQ and 24 dK/dV launches
   a step on each rank, one set of metrics on the four ranks, held as
   phase 47's. Phases 45-48 check their launches in the processes
   (not in the kernels line) and log their times as gloo's: layout and
   parity, not speed;
49. Swin-MoE-T (full width and depth, 224², 8 experts in every second
   block: 6 MoE layers, 88.77 M parameters) from
   ``configs/swin_moe_tiny.yaml`` (batch 128, bf16, AdamW, EMA,
   ``model.attn`` flash_hb: the fused K2) through the train CLI's
   Trainer under ``train.strict=transfers``: one epoch of 4 steps and an
   eval, K2 counted from zero just before ``train()``: 12 launches a
   forward; one strict section a step and no sync outside the lagged
   fetches (no routing op syncs); every logged loss finite,
   ``moe/drop_rate`` in [0, 1], ``moe/capacity_util`` in (0, 1],
   ``moe/max_expert_load`` >= 1. Then 6 steps of a fixed batch at
   constant lr 1e-4 (the loss with its aux terms falls; 12 K2 launches a
   step), the step timed (CUDA events, and the profiler's device time)
   and its 6 MoE layers alone on their captured inputs, forward and
   forward + backward (CUDA events). Then the CLI's checkpoint served by
   ``hub.serve`` (buckets 1/32) through ``MicroBatcher``: 40 requests from
   8 threads, K2 12 a batch, every answer equal to ``engine.run`` of the
   batch it went out in, at its row; the walls at buckets 1 and 32;
50. two processes on ``cuda:0`` over gloo, ``expert = 2``: Swin-MoE-T at
   224² (drop path off) placed under ``MOE_RULES``, 4 experts a rank,
   batch 8 (each rank the whole batch), two steps of
   ``make_train_step(mesh=...)`` in float32 and two in bf16: 12 K2
   launches a step on each rank, one set of metrics on both, the
   replicated leaves bit-equal across them, the first loss and
   ``grad_norm`` within ``EP_TOL`` of the unsplit steps on the same
   weights and batch (run here first), a rank's expert bytes half the
   unsplit model's, ``make_eval_step(mesh)`` equal on both;
51. the CNN zoo: ``mnist_cnn`` trained from ``configs/mnist_smoke.yaml``
   through the train CLI (its default model, on the card) and served
   through the serve CLI's stdin mode (``--size 28``); then VGG-11/13/16/19,
   GoogLeNet, ShuffleNet-V2, MobileNet-V2, EfficientNet-B0 … B7,
   ConvNeXt-T/S/B, CoAtNet-0, RepVGG-A0/A1/A2/B0/B1 and TransFG-small built
   at full width on the card: one bf16 eval forward at 224² (finite (2,
   1000) logits; RepVGG's ``reparameterize`` deploy form against the train
   form's eval forward, float32 and bf16, within ``REPVGG_TOL``), and but
   for TransFG (a dict output no loss trains) one train step of batch 8
   with a finite loss; the seconds each;
52. MAE ViT-B/16 pretraining on K1. First K1 at MAE's attention shapes
   against its plain version: (B, H, N, D) = (64, 12, 49, 64) (the
   encoder's 49 kept tokens of 196), (64, 16, 196, 32) (the decoder), and
   the task CLI's default (2, 6, 1, 64) and (2, 8, 4, 32); forward (and
   LSE), dQ and dK/dV, bf16 and float32, one head a CTA and the flash_hb
   block, q/k/v strided slices of one fused qkv (the tolerances of phases
   2 and 5). Then ``mae_vit_base_patch16`` at 224², bf16, full depth (12
   encoder, 8 decoder blocks), ``attn_fn`` flash_hb, weights from the
   seed, a seeded batch of 64: its first loss against the same weights on
   the naive attention with the same mask noise (``MAE_LOSS_TOL``
   relative); 4 AdamW steps with ``mae_pretrain``'s settings (lr 1.5e-4,
   weight decay 0.05 under ``decay_mask``) and 2 LARS steps
   (``build_optimizer("lars", ...)``), each counted from zero: 20
   forward, 20 dQ and 20 dK/dV launches, a finite loss; ``reconstruct``
   once (finite, the visible patches the input's); the step profiled
   (device ms, wall ms, images/s, K1's share) and K1 at the two
   MAE-B/16 shapes timed by graph replay beside the plain version, SDPA
   and the bound;
53. the task CLI on the card: ``python -m deeplearning_tpu_torch.train.task``
   's ``main`` for all seven tasks at the sizes of
   tests/test_train_task_cli.py (3 steps each, ``train.device`` cuda,
   ``model.attn`` flash_hb): exit 0 and a ``task_metric`` line each, and
   the MAE task's K1 launches (6 heads at N = 1 in the encoder, 8 at N = 4
   in the decoder) above 0;
54. the 16 new factories at their sources' input sizes (U-Net, FCN,
   DeepLabV3 and V3+ at 512², batch 4; HRNet-W18/W48 segmentation at
   512x1024, batch 2; SSPNet one-shot at 321², batch 4; BDB at 384x128,
   batch 32; ArcFace at 112², batch 64; SupCon-18/50 at 32², batch 256;
   HRNet-W18/W48 keypoints at 256x192, batch 32; MADNet at 320x1216,
   batch 1; ``mae_vit_small_patch16`` at 224², batch 64 through K1), each
   built on the card in bf16 in train mode: one forward and one backward,
   finite outputs and gradients, the device ms of the pair (CUDA events,
   after one warm-up pair);
55. the seven Happy-Whale backbones (``xception``, ``inception_v4``,
   ``dpn68``, ``dpn92``, ``nasnet_a_mobile``, ``polynet``, ``senet154``)
   at full width and depth, built on the card in bf16: one eval forward
   at 224², batch 2 (finite (2, 1000) logits), and one train step at
   batch 8 (a finite loss), with the seconds and the peak device memory
   of each; the six ``configs/{dpn92,inception_v4,nasnet_a_mobile,
   polynet,senet154,xception}.yaml`` through the train CLI's ``build`` at
   their 64², two steps each and the eval; and the mask crop end to end:
   a seeded U-Net writes masks for 8 seeded 320x256 images at 256²,
   ``mask_crop_source`` crops them to 112², ``arcface_resnet18`` embeds
   the crops (finite embeddings);
56. configs/vit_b16_imagenet.yaml (ViT-B/16 at full width, batch 32, 8
   steps an epoch, one epoch) through the train CLI's ``build``: one step
   in this process, K1 counted from zero just before and read just after
   (12 forward, 12 dQ, 12 dK/dV of flash_hb); then ``python -m
   deeplearning_tpu_torch.supervise`` around ``python -m
   deeplearning_tpu_torch.train`` on that config in a process of its own,
   with ``DLTPU_FAULTS`` preempting attempt 0 at step 3 and wedging
   attempt 1 at step 5: exit 0; the supervisor's decision log
   (``flightrec_supervisor.json``) shows preempted, wedged, completed;
   every resume starts from a checkpoint its CRCs verify; the wedge kill
   comes within the deadline and a few polls of the heartbeat's last
   movement; the supervisor's pid never appears among nvidia-smi's
   compute apps, each child's does. The wall split per attempt (child
   start, steps, wedge detection or exit) and the backoff are printed;
57. ViT-B/16 at full width (flash_hb, batch 32, 6 steps an epoch) through
   the ``Trainer`` with the prefetcher, a heartbeat file and async
   checkpoints, four runs on one state in turns: ``strict="transfers,
   threads"`` (the thread sanitizer armed before the run's objects build
   their locks), ``"transfers"``, ``"transfers"``, ``"transfers,threads"``.
   Every threads run ends with no ``LockOrderError``; its ``status()``
   shows patched modules, instrumented locks and acquires above 0, and
   the static lock graph's edges seeded (the port's static graph, printed
   first, has locks, spawn sites and no cycle). Each run launches 12 of
   each flash_hb K1 kernel a step, counted from zero just before it. The
   step wall (median gap between the host's ``after_iter`` of steps 2-6)
   of each run is printed beside the others;
58. the zoo under ``DLTPU_STRICT=threads`` (JAX's
   tests/test_zoo_serving.py:425): a ViT-B/16 tenant on K1 (flash_hb) and
   a Swin-T tenant on K2, buckets 1 and 8, behind the batcher; 8 client
   threads submit, alternating tenants (8 requests each at least, and on
   until the admin thread is done), while an admin thread evicts Swin-T
   (retried while a batch of it is in flight) and reloads it, twice. No
   lock violation, every answer finite, and, counted from zero once both
   tenants are warm, K1's
   forward launches 12 × the ViT's forwards and K2 12 × Swin-T's (the
   batches dispatched and the reloads' warm-ups, each model's forward hook
   counting);
59. the audit and the export. ``analysis/audit``'s fake-mode walk on the
   card's device, nothing launched: ViT-B/16's train step at batch 128
   (flash_hb, AdamW) shows 12 ``dltpu.flash_fwd``, 12 ``flash_bwd_dq``
   and 12 ``flash_bwd_dkv`` nodes and 0 transfers, with its peak
   intermediate; Swin-T's eval forward 12 ``dltpu.window_attn`` nodes;
   YOLOX-S's predict at 640² one ``dltpu.nms_sweep`` node; then every row
   of ``run_audits()`` is ok. The custom ops' fake results have the real
   ones' shapes, strides and dtypes on the card. The host cost of the
   custom-op dispatch: one K1 forward at (1, 12, 197, 64) bf16 through
   ``attention_bnhd``, through the launch wrapper and as the bare ctypes
   call of the C entry point, 2 000 calls each ending in a synchronise, in
   turns. ViT-B/16 on flash_hb at batch 8 exported (``torch.export``),
   saved as ``.pt2``, loaded and run: 12 K1 forward launches a call,
   logits within ``EXPORT_LOGIT_TOL`` of eager's (bit-equality printed);
   the export, save and load seconds and both forwards' ms (CUDA events,
   in turns). ``fuse_conv_bn`` on ResNet-50 (float32, 224², batch 8,
   BatchNorm statistics drawn from the seed): the fused logits within
   ``FUSE_REL_TOL`` of the largest unfused one.
60. the serving artifact. The op library (``native/dltpu_ops.cpp``:
   ``dltpu::flash_fwd``, ``window_attn`` and ``nms_sweep`` registered
   from C++, their CUDA impls launching the kernels built in phase 1) and
   the AOTInductor runner (``native/aoti_runner.cc``) are built by g++ in
   a thread started with the script and joined here. ViT-B/16 on
   flash_hb at batch 8 (bf16) is packaged by ``export_savedmodel``
   (``torch.export``, then AOTInductor for the card) and run by the
   runner, a process with no Python, on the JAX runner's ramp: its output
   shape, first 16 logits and all 8 x 1000 (the file it writes) against
   eager's within ``AOTI_LOGIT_TOL``, its log-probabilities against a
   naive-attention copy of the same weights within ``LOGP_TOL``, and 12
   ``flash_fwd`` kernel launches through the C++ registration in its
   checked run. Beside the packaging, a process of this script that
   imports torch only calls the C++ ``dltpu::flash_fwd`` on the card at
   ViT-B/16's (8, 12, 197, 64), on views of a fused qkv (``bnhd``) and on
   contiguous copies, against the plain version (phase 2's bf16
   tolerance; the Python op's output strides). The package and build
   seconds, and the forward ms at
   batch 8 of the runner, the ``.pt2`` program and eager (host clock over
   ``AOTI_ITERS`` runs ending in a synchronise, in turns);
61. the user CLIs in this process, each on the card by default:
   ``predict`` on ViT-B/16 with ``--tta`` over an ``.npz`` of 8 images (its
   top-5 lines equal an engine's TTA probabilities on the same weights;
   K1 3 x 2 x 12), ``demo`` on YOLOX-S at 640² (one K3 launch, the
   annotated image written) and ``evaluate`` on ViT-B/16 over 64 images
   (its top-1 / top-5 / per-class equal a loop over the same batches;
   K1 2 x 12).

The kernels line's K3 entry is timed on YOLOX-S's served batch (phase
14); its launches are the sum over the five served detection paths
(phases 13 and 16), the trained detectors' evaluations (phases 27-31),
Faster R-CNN's train steps (phase 29) and the zoo phases (32-33), each
counted from zero just before its run. The
flash_hb K1 entries add phase 19's launches to phase 3's (forward) and
phase 6's (dQ, dK/dV), and those of phases 32-35 (the zoo's loads and
traffic, the Trainer of phase 35). The K2 entry adds the launches of
phases 22-26 and 33 to phase 9's, each counted from zero just before its
run, and phase 49's (the Trainer's and the served batches'). Phases 36-39 add theirs (the Trainer's, the served forwards' at 224²
and 384², TTA's, the stdin CLI's; K2 at 384²; K3 in the two evaluations of
phase 38); the subprocesses' launches are not counted. Phases 40 and 42
add the mesh runs' K1 launches, phase 44 the one-rank ring's and
Ulysses' (the one-head-a-CTA forward, dQ and dK/dV entries). Phases
52-54 add MAE's (the flash_hb entries), and phase 56 its in-process CLI
step's (the supervised children's launches are not counted). Phase 57
adds its four Trainer runs' (the flash_hb entries), phase 58 the zoo's
(flash_hb forward and K2, from both tenants warm), and phase 59 the
exported program's call (the flash_hb forward; the dispatch-cost loop
and the fake-stride checks are comparisons, not counted). Phase 60 adds
the runner's K1 forward launches in its checked run (read from the op
library's counter in that process; its timed runs are not counted), and
phase 61 the CLIs' (the flash_hb forward; K3).

The last three lines: the card's name and power limit (nvidia-smi), one
``{"kernels": [...]}`` JSON object, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
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
    # phase 43 runs two processes of this script, one a rank
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    # phases 45-48 run two or four processes of this script, one a rank
    ap.add_argument("--par-phase", type=int, default=None,
                    help=argparse.SUPPRESS)
    # phase 60 runs the C++ op library in a process of this script that
    # imports torch only (the library and the Python ops both define
    # dltpu::*)
    ap.add_argument("--cpp-ops", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpp_ops is not None:
        return _cpp_ops_child(*args.cpp_ops)
    if args.par_phase is not None:
        return PAR_RANKS[args.par_phase](args.mesh_rank, args.mesh_dir,
                                         args.seed)
    if args.mesh_rank is not None:
        return _mesh_rank(args.mesh_rank, args.mesh_dir, args.seed)

    started = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 3
    from deeplearning_tpu_torch.native import build as native_build
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    from deeplearning_tpu_torch.ops.kernels import build

    # phase 60's g++ builds (the op library and the AOTInductor runner)
    # need no card: they run beside phases 1-59 and are joined at 60
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build_dir, "inductor"))
    serving_pool = ThreadPoolExecutor(1)
    serving = serving_pool.submit(native_build.build_serving)
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
    log(f"chip_smoke: phases 29-31 in {time.perf_counter() - t29:.1f}s")

    # ------------------- 32. int8 residency: ViT-B/16 and YOLOX-S, fp32 beside
    phase(32, started)
    t32 = time.perf_counter()
    torch.cuda.empty_cache()
    k1, k2 = by_name["flash_attn_fwd_hb"], by_name[wa.KERNEL_NAME]
    yolox_state = _calibrated_yolox(dev, args.seed)
    _add_launches(kernels, _int8_residency(fa, nms_ops, dev, args.seed,
                                           yolox_state))

    # --------- 33. four tenants in one process, behind serve_http's zoo
    phase(33, started)
    _add_launches(kernels, _zoo_http(fa, wa, nms_ops, dev, args.seed,
                                     yolox_state))
    del yolox_state
    _zoo_subprocess(dev, args.seed)

    # -------------------- 34. eviction by the card's own memory reading
    phase(34, started)
    _add_launches(kernels, _zoo_real_eviction(fa, dev, args.seed))

    # ----- 35. ViT-B/16 Trainer: /metrics and the memory sampler beside it
    phase(35, started)
    _add_launches(kernels, _trainer_metrics(fa))
    log(f"chip_smoke: phases 32-35 in {time.perf_counter() - t32:.1f}s")

    # ------ 36. a Trainer checkpoint served; ViT-B/16 and Swin-T at 384²
    phase(36, started)
    t36 = time.perf_counter()
    torch.cuda.empty_cache()
    serve_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke_serve")
    restored = _restore_and_resize(fa, wa, nms_ops, dev, g, args.seed,
                                   os.path.join(serve_dir, "train"))
    _add_launches(kernels, restored["launches"])
    k1["max_abs_err"] = max(k1["max_abs_err"], restored["k1_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], restored["k2_err"])

    # ---------------------------------- 37. classification flip-TTA
    phase(37, started)
    _add_launches(kernels, _classify_tta(fa, wa, nms_ops, dev, args.seed,
                                         restored["step_dir"],
                                         restored.pop("served")))
    torch.cuda.empty_cache()

    # ------------ 38. YOLOX-S scored with train.eval_tta (K3 at 18 018)
    phase(38, started)
    launched, mismatches = _yolox_eval_tta(nms_ops, dev, args.seed)
    k3["launches"] += launched
    k3["max_abs_err"] += mismatches

    # ------------------------------- 39. the supervised serve CLI
    phase(39, started)
    _add_launches(kernels, _supervised_cli(
        fa, wa, nms_ops, dev, args.seed, restored["step_dir"],
        os.path.join(serve_dir, "cli")))
    shutil.rmtree(serve_dir, ignore_errors=True)
    log(f"chip_smoke: phases 36-39 in {time.perf_counter() - t36:.1f}s")

    # --------------------- 40. the mesh step: replicated, ZeRO-1, int8
    phase(40, started)
    t40 = time.perf_counter()
    torch.cuda.empty_cache()
    import torch.distributed as dist
    mesh = _mesh_start()
    try:
        launched, ref_loss = _mesh_steps(fa, dev, args.seed, mesh)
        _add_launches(kernels, launched)

        # ---------------------------------------------------- 41. measure
        phase(41, started)
        torch.cuda.empty_cache()
        _measure_mesh(dev, args.seed, mesh)

        # ----------------------- 42. the Trainer on the mesh with ZeRO-1
        phase(42, started)
        torch.cuda.empty_cache()
        _add_launches(kernels, _mesh_trainer(
            fa, dev, args.seed, mesh,
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "smoke_mesh")))
    finally:
        dist.destroy_process_group()

    # ------------------ 43. two ranks on the one card, over gloo
    phase(43, started)
    torch.cuda.empty_cache()
    _two_ranks_on_one_card(args.seed, ref_loss, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "smoke_ranks"))
    log(f"chip_smoke: phases 40-43 in {time.perf_counter() - t40:.1f}s")

    # -------------- 44. the ring and Ulysses over one NCCL rank, on K1
    phase(44, started)
    t44 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = _mesh_start()
    try:
        _add_launches(kernels, _seq_one_rank(fa, dev, g, mesh))
    finally:
        dist.destroy_process_group()

    # ------------ 45. two ranks on the one card: seq = 2, ring, Ulysses
    phase(45, started)
    torch.cuda.empty_cache()
    # phase 46's ranks start now: their start-up overlaps phase 45
    pipe_ranks = _par_start(46, args.seed, os.path.join(build_dir,
                                                        "smoke_pipe"))
    _seq_two_ranks(args.seed, dev, os.path.join(build_dir, "smoke_seq"))

    # ---------- 46. two ranks on the one card: the GPipe pipeline, S = 2
    phase(46, started)
    torch.cuda.empty_cache()
    _pipeline_two_ranks(args.seed, dev, os.path.join(build_dir,
                                                     "smoke_pipe"),
                        started=pipe_ranks)
    log(f"chip_smoke: phases 44-46 in {time.perf_counter() - t44:.1f}s")

    # ---------- 47. two ranks on the one card: tensor parallel, model = 2
    phase(47, started)
    t47 = time.perf_counter()
    torch.cuda.empty_cache()
    # phase 48's ranks start now: their start-up overlaps phase 47
    tp_seq_ranks = _par_start(48, args.seed, os.path.join(
        build_dir, "smoke_tp_seq"), TP_SEQ_RANKS)
    _tp_two_ranks(args.seed, dev, os.path.join(build_dir, "smoke_tp"))

    # ------------ 48. four ranks on the one card: model 2 x seq 2, ring
    phase(48, started)
    torch.cuda.empty_cache()
    _tp_seq_four_ranks(args.seed, dev, os.path.join(build_dir,
                                                    "smoke_tp_seq"),
                       started=tp_seq_ranks)
    log(f"chip_smoke: phases 47-48 in {time.perf_counter() - t47:.1f}s")

    # ---- 49. Swin-MoE-T trained through the train CLI, then served (K2)
    phase(49, started)
    t49 = time.perf_counter()
    torch.cuda.empty_cache()
    k2["launches"] += _swin_moe(wa, dev, args.seed,
                                os.path.join(build_dir, "smoke_moe"))

    # ----------- 50. two ranks on the one card: expert parallel, expert = 2
    phase(50, started)
    torch.cuda.empty_cache()
    _ep_two_ranks(args.seed, dev, os.path.join(build_dir, "smoke_ep"))

    # ------------------------------------------------ 51. the CNN zoo
    phase(51, started)
    torch.cuda.empty_cache()
    _cnn_zoo(dev, args.seed, os.path.join(build_dir, "smoke_zoo"))
    log(f"chip_smoke: phases 49-51 in {time.perf_counter() - t49:.1f}s")

    # ------------- 52. MAE ViT-B/16 pretraining, every attention on K1
    phase(52, started)
    t52 = time.perf_counter()
    torch.cuda.empty_cache()
    _add_launches(kernels, _mae_pretrain(fa, dev, g, args.seed))

    # ---------------------------------- 53. the task CLI's seven tasks
    phase(53, started)
    torch.cuda.empty_cache()
    _add_launches(kernels, _task_cli(fa))

    # ------------------ 54. the new factories at their sources' sizes
    phase(54, started)
    torch.cuda.empty_cache()
    _add_launches(kernels, _task_factories(fa, dev, args.seed))
    log(f"chip_smoke: phases 52-54 in {time.perf_counter() - t52:.1f}s")

    # ---------- 55. the Happy-Whale backbones, their configs, the mask crop
    phase(55, started)
    t55 = time.perf_counter()
    torch.cuda.empty_cache()
    _zoo_extra(dev, args.seed, os.path.join(build_dir, "smoke_zoo_extra"))

    # -------- 56. the supervise CLI around the train CLI's ViT-B/16 on K1
    phase(56, started)
    t56 = time.perf_counter()
    torch.cuda.empty_cache()
    _add_launches(kernels, _supervised_vit(
        fa, dev, args.seed, os.path.join(build_dir, "smoke_supervise")))
    log(f"chip_smoke: phase 55 in {t56 - t55:.1f}s, phase 56 in "
        f"{time.perf_counter() - t56:.1f}s")

    # ---- 57. ViT-B/16 through the Trainer under the thread sanitizer
    phase(57, started)
    t57 = time.perf_counter()
    torch.cuda.empty_cache()
    _add_launches(kernels, _threads_vit(
        fa, dev, args.seed, os.path.join(build_dir, "smoke_threads")))

    # --------- 58. the zoo (K1 and K2 tenants) under DLTPU_STRICT=threads
    phase(58, started)
    torch.cuda.empty_cache()
    _add_launches(kernels, _threads_zoo(fa, wa, dev, args.seed))

    # ----------------------------- 59. the audit and the export on K1
    phase(59, started)
    torch.cuda.empty_cache()
    counts, exported = _audit_export(
        fa, wa, nms_ops, dev, args.seed, os.path.join(build_dir,
                                                      "smoke_export"))
    _add_launches(kernels, counts)
    log(f"chip_smoke: phases 57-59 in {time.perf_counter() - t57:.1f}s")

    # ------ 60. the serving artifact: ViT-B/16 packaged, run by the runner
    phase(60, started)
    t60 = time.perf_counter()
    torch.cuda.empty_cache()
    runner_launches, cpp_err = _aoti_runner(
        fa, dev, args.seed, os.path.join(build_dir, "smoke_aoti"), serving,
        exported)
    del exported
    _add_launches(kernels, runner_launches)
    k1["max_abs_err"] = max(k1["max_abs_err"], cpp_err)
    serving_pool.shutdown()

    # --------------------- 61. predict, demo and evaluate, in this process
    phase(61, started)
    _add_launches(kernels, _user_clis(
        fa, wa, nms_ops, dev, args.seed, os.path.join(build_dir,
                                                      "smoke_clis")))
    check(k1["launches"] > 0 and k2["launches"] > 0
          and k3["launches"] > 0, "K1, K2 and K3 launched")
    log(f"chip_smoke: phases 60-61 in {time.perf_counter() - t60:.1f}s; "
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


def _train_state(attn, seed, dev, lr=None, name=MODEL, **model_kw):
    """``name`` (ViT-B/16 or Swin-T) at full width from ``seed`` with the
    bench's optimizer: AdamW wd 0.05 under warmup-cosine (base 1e-3,
    10 000 steps, 100 warmup), or at a constant ``lr``. ``attn`` as the
    CLIs take it: for Swin, "naive" is the unfused window attention and a
    flash name the fused kernel. ``model_kw`` go to the factory (an
    ``attn_fn`` there wins over ``attn``'s)."""
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.train import TrainState
    model, _ = hub.load(name, num_classes=1000, seed=seed, device=dev,
                        **{**hub.model_kwargs(name, attn), **model_kw})
    return TrainState.create(model=model, tx=_adamw(model, lr))


def _adamw(model, lr=None):
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.schedules import build_schedule
    sched = (build_schedule("constant", base_lr=lr) if lr is not None else
             build_schedule("warmup_cosine", base_lr=1e-3,
                            total_steps=10_000, warmup_steps=100))
    return build_optimizer("adamw", sched, weight_decay=0.05,
                           params=dict(model.named_parameters()))


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


@contextlib.contextmanager
def _recorded_runs(engine):
    """Inside the block, every ``engine.run(bucket, batch)`` (the batcher's
    dispatch) is recorded as (bucket, batch) in dispatch order."""
    runs, inner = [], engine.run

    def recording(bucket, images):
        runs.append((bucket, images))
        return inner(bucket, images)
    engine.run = recording
    try:
        yield runs
    finally:
        del engine.run


def _hold_served_rows(name, engine, images, rows, runs, batches) -> None:
    """Every served answer against ``engine.run`` of the batch it went out
    in, at its row of that batch: bit-equal, each request in exactly one
    batch. The reference is the dispatched batch itself, not
    ``engine.infer`` in index order: on the card an image's bits depend on
    its row in the batch (the Faster R-CNN pyramid differs by up to 0.09 in
    bf16 when an image moves from row 7 to row 0 of the same batch, and
    greedy NMS turns that into other boxes), so the batcher, which fills a
    batch in arrival order, is held to the batch it really ran. A
    classifier's probabilities are held as one output, "probs"."""
    def outputs(out):
        return out if isinstance(out, dict) else {"probs": out}
    check(len(runs) == batches, f"{name}: one engine.run a batch dispatched")
    where = {}
    for r, (_, batch) in enumerate(runs):
        for j in range(batch.shape[0]):
            where.setdefault(batch[j, 0, :8].tobytes(), []).append((r, j))
    refs = [{k: v.cpu().numpy()
             for k, v in outputs(engine.run(b, batch)).items()}
            for b, batch in runs]
    moved = 0
    for i, row in enumerate(rows):
        at = [(r, j) for r, j in where.get(images[i, 0, :8].tobytes(), [])
              if np.array_equal(runs[r][1][j], images[i])]
        check(len(at) == 1, f"{name}: request {i} went out in one batch")
        r, j = at[0]
        row = outputs(row)
        moved += int(j != i % runs[r][0])
        check(all(np.array_equal(row[k], refs[r][k][j]) for k in row),
              f"{name}: every served answer == engine.run of its batch, "
              f"at its row")
    sizes = {}
    for b, _ in runs:
        sizes[b] = sizes.get(b, 0) + 1
    log(f"{name} served vs engine.run of the batch it went out in, at its "
        f"row: equal {len(rows)}/{len(rows)}; batches by bucket "
        f"{json.dumps({str(b): n for b, n in sorted(sizes.items())})}, "
        f"requests off their index-order row {moved}")


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
    with _recorded_runs(engine) as runs, \
            MicroBatcher(engine, max_wait_ms=5.0) as mb:
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
    # served vs engine.run of the batch each answer went out in, exact.
    # Across buckets the answers differ: the calibrated random network
    # amplifies the bf16 rounding differences of cuDNN's per-shape
    # algorithms through its ~70 layers (a 1e-3 input change moves its raw
    # outputs by up to ~3 on the CPU), so the top-20 overlap with bucket 1
    # is logged, not gated.
    _hold_served_rows(YOLOX, engine, images, rows, runs, batches)
    ref1 = [engine.infer(img) for img in images]
    matched = total = 0
    for i, row in enumerate(rows):
        one = {k: v[0] for k, v in ref1[i].items()}
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
    invalid ones and equal to ``engine.run`` of the batch it went out in,
    at its row; on one batch of the largest bucket, the
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
    with _recorded_runs(engine) as runs, \
            MicroBatcher(engine, max_wait_ms=5.0) as mb:
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
    _hold_served_rows(name, engine, images, rows, runs, batches)
    valid = sum(int(r["valid"].sum()) for r in rows)
    log(f"{name}: valid rows {valid}/{DET_REQUESTS * DET_MAX}")
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
    (0, 2, 2, 0) on one state. The step is the steady one: CUDA
    events on the loop's stream before step ``STEADY_FROM`` and after the
    last step, so the feed's start-up and the epoch-end drain stay out;
    the epoch's wall less its steps is reported apart as the epoch
    overhead. Per route: the steady step (median over the two runs),
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
    for name in ("prefetch=0", "prefetch=2", "prefetch=2", "prefetch=0"):
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
ASYNC_RUNS = (True, False, False, True)   # in turns, 2 each


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
    each epoch's end) with ``async_checkpoint`` on and off, in turns, 2
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


# ------------------------------------------ phases 32-35: the serving zoo
ZOO_BUCKETS = (1, 8)
ZOO_REQUESTS = 64                 # mixed requests of phase 33, 8 threads
ZOO_TENANTS = ("vit", "vit8", "swin", "yolox")
VIT_SIZE = 224                    # ViT-B/16 and Swin-T inputs


def _add_launches(kernels, counts) -> None:
    """Adds a phase's launches (counted from zero just before its run) to
    the kernels line's entries of the same names."""
    for k in kernels:
        k["launches"] += counts.get(k["name"], 0)


def _counters(fa, wa, nms_ops):
    def reset():
        import torch
        torch.cuda.synchronize()
        for mod in (fa, wa, nms_ops):
            mod.reset_launch_counts()

    def read():
        import torch
        torch.cuda.synchronize()
        out = {}
        for mod in (fa, wa, nms_ops):
            out.update({k: v for k, v in mod.launch_counts().items() if v})
        return out
    return reset, read


def _calibrated_yolox(dev, seed):
    """YOLOX-S at 640² from the seed, its BatchNorm statistics calibrated
    on seeded images (phase 13's weights), as a CPU state dict: what a
    zoo tenant's ``weights`` reloads from."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.models.detection.yolox import \
        calibrate_batchnorm
    model, _ = hub.load(YOLOX, num_classes=YOLOX_CLASSES, seed=seed,
                        device=dev)
    rng = np.random.default_rng(seed + 2)
    calibrate_batchnorm(model, torch.from_numpy(rng.normal(size=(
        8, YOLOX_SIZE, YOLOX_SIZE, 3)).astype(np.float32)).to(dev))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    return state


def _tenant_kwargs(alias, seed, yolox_state):
    """One zoo tenant's engine keywords (phase 33's spec)."""
    if alias == "yolox":
        return dict(num_classes=YOLOX_CLASSES, image_size=YOLOX_SIZE,
                    weights=yolox_state, score_thresh=0.0,
                    max_det=YOLOX_MAX_DET, seed=seed)
    return dict(num_classes=1000, attn="flash_hb", seed=seed,
                image_size=VIT_SIZE)


def _int8_residency(fa, nms_ops, dev, seed, yolox_state) -> dict:
    """Phase 32: ViT-B/16 and YOLOX-S, float32 and int8-resident side by
    side: resident bytes by ``variables_nbytes()`` and by the
    ``memory_allocated`` delta of each build (ViT-B/16 int8 at least 3.5×
    denser by both), the card's dequantized weights against the CPU's,
    int8 against float32 (ViT top-1 agreement, YOLOX kept-set sizes),
    bucket-1 and bucket-8 latency in turns and the dequantize alone."""
    import copy
    import gc
    import torch
    from deeplearning_tpu_torch.ops import window_attention as wa
    from deeplearning_tpu_torch.serve import InferenceEngine
    reset, read = _counters(fa, wa, nms_ops)
    engines, nbytes, delta = {}, {}, {}
    for name, key in ((MODEL, "vit"), (YOLOX, "yolox")):
        for quant in ("fp32", "int8"):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            m0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = InferenceEngine(
                name, batch_buckets=ZOO_BUCKETS, device=dev,
                weight_quant=quant, **_tenant_kwargs(key, seed, yolox_state))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            engines[key, quant] = eng
            nbytes[key, quant] = eng.variables_nbytes()
            delta[key, quant] = torch.cuda.memory_allocated() - m0
            log(f"int8 residency: {name} {quant} built and warmed in "
                f"{secs:.2f}s; variables_nbytes {nbytes[key, quant]}, "
                f"memory_allocated delta {delta[key, quant]}")
        by_vars = nbytes[key, "fp32"] / nbytes[key, "int8"]
        by_alloc = delta[key, "fp32"] / delta[key, "int8"]
        log(f"int8 residency: {name} float32 / int8 resident bytes "
            f"{by_vars:.3f} (variables_nbytes), {by_alloc:.3f} "
            f"(memory_allocated)")
        if key == "vit":
            check(by_vars >= 3.5 and by_alloc >= 3.5,
                  "ViT-B/16 int8 residency at least 3.5x denser")

    # the card's dequantized weights == the CPU's, bit for bit
    cpu = InferenceEngine(MODEL, model=copy.deepcopy(
        engines["vit", "fp32"].model).to("cpu"), device="cpu",
        batch_buckets=(1,), precompile=False, weight_quant="int8")
    want = cpu.dequantized_state_dict()
    got = engines["vit", "int8"].dequantized_state_dict()
    same = sum(torch.equal(got[k].cpu(), want[k]) for k in want)
    log(f"int8 residency: card vs CPU dequantized weights: {same}/"
        f"{len(want)} tensors bit-equal")
    check(same == len(want) and set(got) == set(want),
          "the card's dequantized weights equal the CPU's")
    del cpu, want, got

    reset()
    rng = np.random.default_rng(seed + 32)
    x = rng.normal(size=(32, VIT_SIZE, VIT_SIZE, 3)).astype(np.float32)
    p32, p8 = (engines["vit", q].infer(x) for q in ("fp32", "int8"))
    agree = int((p32.argmax(1) == p8.argmax(1)).sum())
    dlogp = float(np.abs(np.log(p32) - np.log(p8)).max())
    log(f"int8 residency: {MODEL} int8 vs float32 on 32 seeded images: "
        f"top-1 agree {agree}/32, max |dlogp| {dlogp:.3e}")
    xd = rng.normal(size=(8, YOLOX_SIZE, YOLOX_SIZE, 3)).astype(np.float32)
    d32, d8 = (engines["yolox", q].infer(xd) for q in ("fp32", "int8"))
    log(f"int8 residency: {YOLOX} kept boxes an image at score 0, float32 "
        f"{d32['valid'].sum(1).tolist()}, int8 {d8['valid'].sum(1).tolist()}")
    check(np.isfinite(p8).all() and np.isfinite(d8["boxes"]).all(),
          "int8 answers are finite")
    _bucket_latency({q: engines["vit", q] for q in ("fp32", "int8")},
                    ("fp32", "int8"), MODEL, size=VIT_SIZE)
    _bucket_latency({q: engines["yolox", q] for q in ("fp32", "int8")},
                    ("fp32", "int8"), YOLOX, size=YOLOX_SIZE)
    counts = read()
    for key in ("vit", "yolox"):
        weights = engines[key, "int8"]._int8
        ms = _time_ms(weights.dequantize, iters=20, warmup=3)
        log(f"int8 residency: {key} dequantize alone (one launch into a "
            f"{4 * weights.q.numel() / 1e6:.1f} MB float32 transient): "
            f"{ms:.4f} ms")
    log(f"int8 residency launches {json.dumps(counts)}")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _post(url, body=b"", timeout=120.0):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _npy(arr) -> bytes:
    import io
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _answer_matches(answer, refs, i, fmt) -> bool:
    """A served answer equals the solo engine's formatted answer for the
    same image at one of the buckets (no op mixes images: exact)."""
    return any(answer == fmt({k: v[i] for k, v in ref.items()}
                             if isinstance(ref, dict) else ref[i])
               for ref in refs.values())


def _solo_refs(engine, images):
    """``engine.infer`` of ``images`` at each bucket (phase 13's refs)."""
    refs = {}
    for bucket in engine.buckets:
        parts = [engine.infer(images[i:i + bucket])
                 for i in range(0, len(images), bucket)]
        refs[bucket] = ({k: np.concatenate([p[k] for p in parts])
                         for k in parts[0]} if isinstance(parts[0], dict)
                        else np.concatenate(parts))
    return refs


def _zoo_http(fa, wa, nms_ops, dev, seed, yolox_state) -> dict:
    """Phase 33: ViT-B/16 (float32 and int8), Swin-T and YOLOX-S in one
    ``ModelZoo`` built by the serve CLI's ``build_zoo``, loaded on their
    ``zoo-load-*`` threads, behind ``serve_http`` on a thread of this
    process: 64 mixed requests from 8 threads, each answer equal to a solo
    engine's at one bucket; ``/metrics`` parsed; brownout step 2 demotes
    ViT to int8 and an evicted Swin-T reloads on its next request."""
    import gc
    import re
    import threading
    import urllib.request
    import torch
    from deeplearning_tpu_torch.obs import metrics as obs_metrics
    from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    reset, read = _counters(fa, wa, nms_ops)
    spec = {alias: {"model": name, "preload": True, **extra, **{
        k: v for k, v in _tenant_kwargs(alias, seed, yolox_state).items()
        if k != "seed"}} for alias, name, extra in (
            ("vit", MODEL, {}), ("vit8", MODEL, {"weight_quant": "int8"}),
            ("swin", SWIN, {}), ("yolox", YOLOX, {}))}
    args = serve_cli.build_parser().parse_args(
        ["--zoo", "{}", "--http", "0", "--buckets", "1,8", "--seed",
         str(seed), "--score-thresh", "0", "--device", str(dev)])
    reset()
    t0 = time.perf_counter()
    zoo = serve_cli.build_zoo(spec, args)
    load_launches = read()
    stats = zoo.stats()
    log(f"zoo: {len(spec)} tenants loaded in {time.perf_counter() - t0:.2f}s"
        f" on their load threads: "
        + json.dumps({a: {k: r.get(k) for k in (
            "state", "weight_quant", "bytes", "load_seconds", "trace_count",
            "load_error")} for a, r in stats["models"].items()})
        + f"; launches {json.dumps(load_launches)}")
    check(all(r["warm"] and r["trace_count"] == len(ZOO_BUCKETS)
              for r in stats["models"].values()), "four warm tenants")
    for name in ("flash_attn_fwd_hb", wa.KERNEL_NAME):
        check(load_launches.get(name, 0) > 0,
              f"{name} launched from the zoo's load threads")
    rng = np.random.default_rng(seed + 33)
    images = {a: rng.normal(size=(ZOO_REQUESTS // 4, s, s, 3)).astype(
        np.float32) for a, s in (("vit", VIT_SIZE), ("vit8", VIT_SIZE),
                                 ("swin", VIT_SIZE), ("yolox", YOLOX_SIZE))}
    fmt = functools.partial(serve_cli.format_answer, names={}, topk=5)
    with MicroBatcher(zoo=zoo, max_wait_ms=5.0,
                      default_timeout_s=args.timeout_s) as mb:
        server = serve_cli.serve_http(mb, {}, 5, args.timeout_s, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_port}"
        try:
            jobs = [(ZOO_TENANTS[i % 4], i // 4)
                    for i in range(ZOO_REQUESTS)]

            def client(part):
                return [(a, i, _post(f"{url}/predict/{a}",
                                     _npy(images[a][i])))
                        for a, i in part]
            reset()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                answers = [r for part in pool.map(
                    client, [jobs[k::8] for k in range(8)]) for r in part]
            wall = time.perf_counter() - t0
            counts = read()
            log(f"zoo: {len(answers)} mixed requests from 8 threads over "
                f"HTTP in {wall:.2f}s, {mb.dispatched} batches, launches "
                f"{json.dumps(counts)}")
            for name in ("flash_attn_fwd_hb", wa.KERNEL_NAME,
                         "nms_greedy_sweep"):
                check(counts.get(name, 0) > 0,
                      f"{name} launched through the zoo")
            bad = [(a, i, code, body) for a, i, (code, body) in answers
                   if code != 200]
            check(not bad, f"every request answered 200 (not: {bad[:3]})")
            solo = {a: InferenceEngine(
                spec[a]["model"], batch_buckets=ZOO_BUCKETS, device=dev,
                weight_quant=spec[a].get("weight_quant", "fp32"),
                **_tenant_kwargs(a, seed, yolox_state)) for a in ZOO_TENANTS}
            refs = {a: _solo_refs(solo[a], images[a]) for a in ZOO_TENANTS}
            equal = {a: 0 for a in ZOO_TENANTS}
            for a, i, (_, body) in answers:
                equal[a] += _answer_matches(body["results"][0], refs[a], i,
                                            fmt)
            log(f"zoo: answers equal to a solo engine's at one bucket "
                f"{json.dumps(equal)} of {ZOO_REQUESTS // 4} each")
            check(all(n == ZOO_REQUESTS // 4 for n in equal.values()),
                  "every zoo answer equals its solo engine's")

            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            gauge = {(name, a): float(v) for name, a, v in re.findall(
                r'^(dltpu_zoo_model_\w+)\{model="(\w+)"\} (\S+)$', text,
                re.M)}
            log("zoo /metrics: " + json.dumps(
                {a: {n[len("dltpu_zoo_model_"):]: gauge.get((n, a))
                     for n in ("dltpu_zoo_model_warm",
                               "dltpu_zoo_model_trace_count",
                               "dltpu_zoo_model_bytes")}
                 for a in ZOO_TENANTS}))
            check(all(gauge.get(("dltpu_zoo_model_warm", a)) == 1.0
                      and gauge.get(("dltpu_zoo_model_trace_count", a))
                      == len(ZOO_BUCKETS) for a in ZOO_TENANTS),
                  "/metrics: four warm tenants, trace_count == buckets")

            reset()                 # the solo engines' launches aside
            code, body = _post(f"{url}/admin/brownout/vit/2")
            log(f"zoo: POST /admin/brownout/vit/2 -> {code} "
                f"{json.dumps(body)}")
            check(body.get("demoted") is True, "brownout step 2 demotes")
            t0 = time.perf_counter()
            code, body = _post(f"{url}/predict/vit", _npy(images["vit"][0]))
            reload_s = time.perf_counter() - t0
            counts2 = read()
            eng = zoo.engine("vit")
            log(f"zoo: vit reloaded int8-resident on its next request in "
                f"{reload_s:.2f}s ({eng.variables_nbytes()} bytes)")
            demoted = _solo_refs(solo["vit8"], images["vit"][:8])
            check(code == 200 and eng.weight_quant == "int8"
                  and _answer_matches(body["results"][0], demoted, 0, fmt),
                  "the demoted vit answers as the int8 tenant")
            reset()                 # the solo engine's launches aside
            _post(f"{url}/admin/brownout/vit/0")
            code, body = _post(f"{url}/admin/evict/swin")
            t0 = time.perf_counter()
            code2, body2 = _post(f"{url}/predict/swin",
                                 _npy(images["swin"][1]))
            log(f"zoo: POST /admin/evict/swin -> {json.dumps(body)}; its "
                f"next request reloaded it and answered in "
                f"{time.perf_counter() - t0:.2f}s; loads {zoo.loads}, "
                f"evictions {zoo.evictions}")
            check(body.get("evicted") is True and code2 == 200
                  and _answer_matches(body2["results"][0], refs["swin"], 1,
                                      fmt),
                  "an evicted swin reloads and answers as before")
            for name, n in read().items():
                counts2[name] = counts2.get(name, 0) + n
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            # serve_http's collector holds the batcher and its zoo in the
            # process-wide registry: let them go with the server
            obs_metrics.disable()
    for name, n in load_launches.items():
        counts[name] = counts.get(name, 0) + n
    for name, n in counts2.items():
        counts[name] = counts.get(name, 0) + n
    del zoo, solo, refs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _zoo_subprocess(dev, seed) -> None:
    """Phase 33's last part: ``python -m deeplearning_tpu_torch.serve --zoo
    @spec --http 0`` in a process of its own: the ready line, one answer,
    and a SIGTERM drain that exits 0."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "smoke_zoo.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"vit": {"model": MODEL, "buckets": [1],
                           "image_size": VIT_SIZE, "preload": True}}, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning_tpu_torch.serve", "--zoo",
         f"@{path}", "--http", "0", "--seed", str(seed), "--device",
         str(dev)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        serving = json.loads(proc.stdout.readline())
        code, body = _post(serving["serving"] + "/predict/vit",
                           _npy(np.zeros((VIT_SIZE, VIT_SIZE, 3), np.float32)))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ready = [line for line in err.splitlines() if line.startswith(
        '{"ready"')]
    log(f"zoo CLI subprocess: ready line {bool(ready)}, serving "
        f"{serving['serving']}, POST /predict/vit -> {code}, SIGTERM -> "
        f"exit {proc.returncode} after {time.perf_counter() - t0:.2f}s")
    check(ready and json.loads(ready[0])["ready"]["models"]["vit"]["warm"]
          and code == 200 and len(body["results"]) == 1
          and proc.returncode == 0,
          "the zoo CLI answers and drains to exit 0 on SIGTERM")


def _zoo_real_eviction(fa, dev, seed) -> dict:
    """Phase 34: three ViT-B/16 tenants (seeds s, s+1, s+2) and the card's
    own reading (``obs/xla.hbm_snapshot``, recorded, not stubbed). With a
    and b resident the alert fraction is set from the reading so that c's
    load projects past it: a (the LRU) goes, the reading falls by its
    bytes, c loads; with b and c busy, a's load answers 429
    ``hbm_pressure`` over HTTP."""
    import gc
    import threading
    import weakref
    import torch
    from deeplearning_tpu_torch.obs import metrics as obs_metrics
    from deeplearning_tpu_torch.obs.xla import hbm_snapshot
    from deeplearning_tpu_torch.ops import nms as nms_ops
    from deeplearning_tpu_torch.ops import window_attention as wa
    from deeplearning_tpu_torch.serve import MicroBatcher, ModelZoo
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    reset, read = _counters(fa, wa, nms_ops)
    readings = []

    def reading():
        snap = hbm_snapshot()
        readings.append(snap["devices"][0]["bytes_in_use"])
        return snap
    zoo = ModelZoo(hbm_snapshot_fn=reading)
    for i, alias in enumerate("abc"):
        zoo.register(alias, MODEL, attn="flash_hb", batch_buckets=(1,),
                     image_size=VIT_SIZE, device=dev, seed=seed + i)
    gc.collect()
    torch.cuda.empty_cache()
    reset()
    for alias in "ab":
        check(zoo.load(alias, wait=True) == "warm", f"{alias} loads")
    p0 = zoo.hbm_pressure()
    est = zoo.stats()["models"]["a"]["bytes"]
    zoo.spec("c").est_bytes = est
    zoo._alert_frac = p0["usage_frac"] + 0.5 * est / p0["bytes_limit"]
    log(f"zoo eviction: a, b resident; reading {p0['bytes_in_use']} of "
        f"{p0['bytes_limit']} bytes (usage {p0['usage_frac']:.5f}); alert "
        f"set to {zoo._alert_frac:.5f}: c ({est} bytes) projects "
        f"{p0['usage_frac'] + est / p0['bytes_limit']:.5f}")
    del readings[:]
    victim = weakref.ref(zoo.engine("a"))
    state = zoo.load("c", wait=True)
    fell = readings[0] - readings[1] if len(readings) > 1 else 0
    if victim() is not None:
        log("zoo eviction: the evicted engine is still referenced by "
            + ", ".join(type(r).__name__ for r in gc.get_referrers(
                victim())))
    log(f"zoo eviction: load c -> {state}; states "
        f"{json.dumps({a: zoo.state(a) for a in 'abc'})}; the reading "
        f"{readings[:2]} fell {fell} bytes as a went (its variables "
        f"{est}); evictions {zoo.evictions}")
    check(state == "warm" and zoo.state("a") == "evicted"
          and zoo.evictions == 1, "the LRU tenant goes, c loads")
    check(fell >= 0.9 * est, "the reading falls by the evicted bytes")
    with MicroBatcher(zoo=zoo, max_wait_ms=1.0) as mb:
        server = serve_cli.serve_http(mb, {}, 5, 30.0, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            zoo.mark_dispatch("b", +1)
            zoo.mark_dispatch("c", +1)
            code, body = _post(
                f"http://127.0.0.1:{server.server_port}/predict/a",
                _npy(np.zeros((VIT_SIZE, VIT_SIZE, 3), np.float32)))
            zoo.mark_dispatch("b", -1)
            zoo.mark_dispatch("c", -1)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            obs_metrics.disable()
    log(f"zoo eviction: b and c busy, POST /predict/a -> {code} "
        f"{json.dumps(body)}; rejected loads {zoo.rejected_loads}")
    check(code == 429 and body["reason"] == "hbm_pressure"
          and body["model"] == "a", "nothing evictable: 429 hbm_pressure")
    counts = read()
    del zoo
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _trainer_metrics(fa) -> dict:
    """Phase 35: phases 19's ViT-B/16 Trainer run (2 epochs of 4 steps,
    one eval) with ``metrics_port=0``, ``hbm_sample_s=0.05`` and
    ``strict=transfers``: ``/metrics`` scraped mid-run, the sampler's peak
    at least ``max_memory_allocated``, and the losses equal the same run's
    without the sampler and the server."""
    import dataclasses
    import gc
    import torch
    import urllib.request
    cli = _cli()
    cfg = _smoke_cfg(None)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, strict="transfers"))
    losses, counts = {}, {}
    for run in ("served", "plain"):
        kw = (dict(obs=True, metrics_port=0, hbm_sample_s=0.05)
              if run == "served" else dict(obs=False))
        trainer = cli.build(cfg, eval_every_epochs=2, preemptible=False,
                            heartbeat=None, **kw)
        logged, scraped = [], {}
        consume = trainer._consume

        def record(entries, consume=consume, logged=logged):
            logged += [host["loss"] for _, host in entries]
            return consume(entries)
        trainer._consume = record

        def scrape(t, scraped=scraped, **kw):
            if t._metrics_server is not None and t.epoch == 1 \
                    and not scraped:
                with urllib.request.urlopen(
                        t._metrics_server.url + "/metrics", timeout=30) as r:
                    scraped["text"] = r.read().decode()
        trainer.callbacks.register("before_iter", scrape)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses[run] = logged
        if run == "served":
            counts = {k: v for k, v in fa.launch_counts().items() if v}
            wm = trainer.hbm_watermark
            lines = [ln for ln in scraped.get("text", "").splitlines()
                     if ln.startswith(("dltpu_train_step ",
                                       "dltpu_train_loss ",
                                       "dltpu_hbm_peak_bytes_in_use "))]
            log(f"Trainer with /metrics and the sampler: {wall:.2f}s, "
                f"{trainer.strict_sections} strict sections; mid-run "
                f"scrape {lines}; sampler {json.dumps(wm)}; "
                f"max_memory_allocated {peak}; launches {json.dumps(counts)}")
            check(len(lines) == 3, "/metrics scraped mid-run")
            check(wm["hbm_samples"] >= 2 and wm["peak_bytes_in_use"] >= peak,
                  "the sampler's peak >= max_memory_allocated")
        else:
            log(f"Trainer without them: {wall:.2f}s")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(losses["served"], losses["plain"]))
    log(f"Trainer losses with vs without the sampler and server: "
        f"{len(losses['served'])} steps, max |dloss| {diff:.3e} (tol "
        f"{TRAINER_LOSS_TOL})")
    check(len(losses["served"]) == len(losses["plain"]) == 2 * TRAINER_STEPS
          and diff <= TRAINER_LOSS_TOL, "the losses equal the plain run's")
    return counts


# -------- phases 36-39: checkpoints, new sizes, TTA and the supervised CLI
SERVE_BUCKETS = (1, 8)
BIG_SIZE = 384                    # ViT-B/16 and Swin-T reloaded at 384²
BIG_TOKENS = (BIG_SIZE // 16) ** 2 + 1                # 577: K1's N
BIG_WINDOW = 12                   # Swin-T at 384²: K2's N = 144
# Swin-T's window attention at 384², window 12: windows an image, heads,
# mask windows (stage 4 is one unshifted window)
BIG_SWIN_STAGES = [(64, 3, 64), (16, 6, 16), (4, 12, 4), (1, 24, 0)]
TTA_VIEWS = (640, 544, 416)       # yolox_tta's views of 640² (rounded)
TTA_CANDIDATES = sum((s // 8) ** 2 + (s // 16) ** 2 + (s // 32) ** 2
                     for s in TTA_VIEWS)                 # 18 018
TTA_BATCH = 32                    # the TTA evaluation's one predict call
PREEMPT_AT = 3                    # dispatches before the injected preempt


def _add(total, counts) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _ckpt_trainer(fa, seed, workdir):
    """Phase 36a: ViT-B/16 trained 2 steps through the Trainer (phase 19's
    set-up, one epoch, EMA on, no eval), its step directory written.
    Returns the step directory, the EMA and trained parameters (CPU) and
    the K1 launches (counted from zero just before ``train()``)."""
    import dataclasses
    import shutil
    import torch
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = _smoke_cfg(workdir, steps=2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1, ema=True))
    trainer = cli.build(cfg, eval_every_epochs=2)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    counts = {k: v for k, v in fa.launch_counts().items() if v}
    step = trainer.ckpt.latest_step()
    ema = {k: v.detach().cpu().clone()
           for k, v in trainer.state.ema_params.items()}
    params = {k: v.detach().cpu().clone()
              for k, v in trainer.state.params.items()}
    log(f"Trainer with EMA: 2 steps and a checkpoint in "
        f"{time.perf_counter() - t0:.2f}s, step {step}, launches "
        f"{json.dumps(counts)}")
    want = {fa.KERNEL_NAMES[4]: 2 * DEPTH,
            fa.BWD_KERNEL_NAMES["dq"][4]: 2 * DEPTH,
            fa.BWD_KERNEL_NAMES["dkv"][4]: 2 * DEPTH}
    check(counts == want, f"the Trainer's K1 launches == {want}")
    del trainer
    torch.cuda.empty_cache()
    return os.path.join(workdir, "ckpt", str(step)), ema, params, counts


def _check_k1_at(fa, dev, g, b, n) -> float:
    """K1 (both heads-per-CTA) against its plain version at (b, 12, n,
    64), bf16, q/k/v strided slices of one qkv: the largest error."""
    import torch
    qkv = torch.randn(b, n, 3, HEADS, HEAD_DIM, device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    worst = 0.0
    for name, hpc in HPC_FOR.items():
        out, lse = fa._attention(q, k, v, sm_scale=None, causal=False,
                                 heads_per_cta=hpc)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"kernel-vs-plain {name} bf16 B={b} H={HEADS} N={n} "
            f"D={HEAD_DIM}: max_abs_err {err:.3e} (tol 2e-2) lse "
            f"{lse_err:.3e}")
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"{name} disagrees with the plain version at N={n}")
        worst = max(worst, err)
    return worst


def _time_k1_at(fa, dev, g, b, n) -> None:
    """K1 (flash_hb's instantiation) at (b, 12, n, 64) bf16 by CUDA-graph
    replay beside the plain version, SDPA and the bound."""
    import torch
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    qkv = torch.randn(b, n, 3, HEADS, HEAD_DIM, device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = graph_ms(lambda: fa.attention_bnhd(q, k, v, heads_per_cta=4))
    plain_ms = _time_ms(lambda: fa.flash_attention_reference(qt, kt, vt),
                        iters=20, warmup=3)
    sdpa_ms = graph_ms(lambda: torch.nn.functional.
                       scaled_dot_product_attention(qt, kt, vt))
    nbytes = fa.min_bytes(b, HEADS, n, HEAD_DIM, 2)
    flops = fa.flops(b, HEADS, n, HEAD_DIM)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"timing flash_attn_fwd_hb B={b} H={HEADS} N={n} D={HEAD_DIM} "
        f"bf16: kernel {ms:.4f} ms (graph replay), plain {plain_ms:.4f} "
        f"ms, sdpa {sdpa_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")


def _check_and_time_k2_at(wa, dev, g, batch) -> float:
    """K2 against its plain version at Swin-T 384²'s four stages (window
    12: N = 144, d = 32) at ``batch`` images, bf16 (2e-2), masks as the
    shifted blocks have them; each also by CUDA-graph replay beside the
    plain version, masked SDPA and the bound. Returns the largest
    error."""
    import torch
    import torch.nn.functional as F
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    n, d, worst = BIG_WINDOW * BIG_WINDOW, WIN_HEAD_DIM, 0.0
    for stage, (wins, heads, nw) in enumerate(BIG_SWIN_STAGES, 1):
        bw = batch * wins
        qkv, bias, mask = _window_inputs(dev, g, bw, n, heads, d,
                                         torch.bfloat16, nw)
        out = wa.window_attention(qkv, bias, mask)
        ref = wa.window_attention_plain(qkv, bias, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= 2e-2, f"window_attn_fwd disagrees at N={n} stage "
                           f"{stage}")
        worst = max(worst, err)
        ms = graph_ms(lambda: wa.window_attention(qkv, bias, mask))
        plain_ms = graph_ms(lambda: wa.window_attention_plain(qkv, bias,
                                                              mask),
                            calls=5, replays=3)
        q, k, v = (x.transpose(1, 2).unflatten(0, (batch, wins))
                   for x in qkv.unbind(2))
        comb = (bias[None] if mask is None
                else bias[None] + mask[:, None]).to(torch.bfloat16)
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=comb))
        nbytes = wa.min_bytes(bw, n, heads, d, 2, nw)
        flops = wa.flops(bw, n, heads, d)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        log(f"kernel-vs-plain window_attn_fwd bf16 BW={bw} N={n} "
            f"heads={heads} d={d} nW={nw}: max_abs_err {err:.3e} (tol "
            f"2e-2); timing: kernel {ms:.4f} ms (graph replay), plain "
            f"{plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return worst


def _restore_and_resize(fa, wa, nms_ops, dev, g, seed, workdir) -> dict:
    """Phase 36: a Trainer checkpoint restored and served, and weights
    loaded at another image size. ViT-B/16 trained 2 steps with EMA, its
    step directory served by ``hub.serve`` (buckets 1/8, flash_hb): the
    weights are the EMA's and the answers equal an engine built from the
    same EMA weights in memory. The checkpoint restored by
    ``restore_variables`` and loaded by ``surgical_load(default_resize_fn)``
    into ViT-B/16 at 384² (K1 at N = 577), served at buckets 1 and 8
    against a naive-attention engine on the same weights; a Swin-T window-7
    224² state loaded into Swin-T at 384² with window 12 (K2 at N = 144,
    d = 32), served at bucket 8 against the unfused engine. K1 and K2 held
    against their plain versions at these shapes and timed. Returns the
    launches (the Trainer's and the served forwards'), the step directory
    and the restored engine for phases 37 and 39."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.core.checkpoint import (default_resize_fn,
                                                         restore_variables,
                                                         surgical_load)
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.serve import InferenceEngine
    reset, read = _counters(fa, wa, nms_ops)
    step_dir, ema, params, launches = _ckpt_trainer(fa, seed, workdir)
    moved = sum(not torch.equal(ema[k], params[k]) for k in ema)
    check(moved > 0, "the EMA differs from the trained parameters")
    x = np.random.default_rng(seed + 36).normal(
        size=(8, BIG_SIZE, BIG_SIZE, 3)).astype(np.float32)
    x224 = np.ascontiguousarray(x[:, :224, :224])

    # the checkpoint served, beside an engine on the same EMA in memory
    reset()
    t0 = time.perf_counter()
    served = hub.serve(MODEL, ckpt=step_dir, image_size=224,
                       batch_buckets=SERVE_BUCKETS, attn="flash_hb",
                       device=dev)
    serve_s = time.perf_counter() - t0
    mem_model, _ = hub.load(MODEL, attn_fn=get_attn_fn("flash_hb"),
                            device="cpu")
    state = mem_model.state_dict()
    state.update(ema)
    mem_model.load_state_dict(state)
    mem = InferenceEngine(MODEL, model=mem_model,
                          batch_buckets=SERVE_BUCKETS, device=dev)
    got = [served.infer(x224), served.infer(x224[:1])]
    want = [mem.infer(x224), mem.infer(x224[:1])]
    counts = read()
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    state = served.model.state_dict()
    ema_served = all(torch.equal(state[k].cpu(), v) for k, v in ema.items())
    log(f"hub.serve of the step directory: built, restored and warmed in "
        f"{serve_s:.2f}s; weights == EMA {ema_served} ({moved} of "
        f"{len(ema)} tensors differ from the trained parameters); answers "
        f"vs the in-memory EMA engine max |dp| {diff:.3e} at buckets 8 "
        f"and 1; {json.dumps(served.stats())}; launches "
        f"{json.dumps(counts)}")
    check(ema_served and diff == 0.0,
          "the restored engine serves the EMA weights, bit-equal answers")
    check(served.trace_count == served.compile_count == 2,
          "trace_count == compile_count == len(buckets)")
    check(counts == {fa.KERNEL_NAMES[4]: DEPTH * 8},
          "K1 launches == 12 x 8 forwards (4 warmups, 4 requests)")
    _add(launches, counts)
    del mem, mem_model, state
    torch.cuda.empty_cache()

    # ViT-B/16 at 384²: restore + surgical load, served at buckets 1 and 8
    init, _ = hub.load(MODEL, device="cpu")
    t0 = time.perf_counter()
    restored = restore_variables(step_dir, init.state_dict())
    restore_s = time.perf_counter() - t0
    big, _ = hub.load(MODEL, img_size=BIG_SIZE,
                      attn_fn=get_attn_fn("flash_hb"), device="cpu")
    t0 = time.perf_counter()
    loaded = surgical_load(big.state_dict(), restored,
                           resize_fn=default_resize_fn)
    big.load_state_dict(loaded)
    surgical_s = time.perf_counter() - t0
    check(tuple(loaded["pos_embed"].shape) == (1, BIG_TOKENS, 768)
          and all(torch.equal(loaded[k], v) for k, v in restored.items()
                  if k != "pos_embed"),
          "every tensor loaded, pos_embed resized to 577 tokens")
    naive, _ = hub.load(MODEL, img_size=BIG_SIZE,
                        attn_fn=get_attn_fn("naive"), device="cpu")
    naive.load_state_dict(loaded)
    reset()
    eng = InferenceEngine(MODEL, model=big, image_size=BIG_SIZE,
                          batch_buckets=SERVE_BUCKETS, device=dev)
    p8, p1 = eng.infer(x), eng.infer(x[:1])
    counts = read()
    ref = InferenceEngine(MODEL, model=naive, image_size=BIG_SIZE,
                          batch_buckets=(8,), device=dev)
    size_gb = os.path.getsize(os.path.join(step_dir, "state.pt")) / 1e9
    log(f"ViT-B/16 at {BIG_SIZE}²: restore_variables {restore_s:.3f}s (a "
        f"{size_gb:.3f} GB step file, warm), surgical_load + "
        f"load_state_dict {surgical_s:.3f}s; launches {json.dumps(counts)}")
    check(counts == {fa.KERNEL_NAMES[4]: DEPTH * 4},
          "K1 launches == 12 x 4 forwards at N = 577")
    _compare(p8, ref.infer(x), f"ViT-B/16 {BIG_SIZE}² flash_hb vs naive, "
                               f"bucket 8")
    _compare(p1, ref.infer(x[:1]), f"ViT-B/16 {BIG_SIZE}² bucket 1 vs "
                                   f"naive")
    _add(launches, counts)
    k1_err = max(_check_k1_at(fa, dev, g, 8, BIG_TOKENS),
                 _check_k1_at(fa, dev, g, 1, BIG_TOKENS))
    _time_k1_at(fa, dev, g, 8, BIG_TOKENS)
    del eng, ref, big, naive, init, restored, loaded
    torch.cuda.empty_cache()

    # Swin-T window 7 at 224² into Swin-T window 12 at 384²
    t0 = time.perf_counter()
    small, _ = hub.load(SWIN, seed=seed, device="cpu")
    engines, loaded, counts = {}, None, {}
    for name, fused in (("fused", True), ("unfused", False)):
        model, _ = hub.load(SWIN, img_size=BIG_SIZE, window=BIG_WINDOW,
                            use_pallas=fused, seed=seed + 1, device="cpu")
        if loaded is None:
            loaded = surgical_load(model.state_dict(), small.state_dict(),
                                   resize_fn=default_resize_fn)
        model.load_state_dict(loaded)
        if fused:
            reset()
        engines[name] = InferenceEngine(SWIN, model=model,
                                        image_size=BIG_SIZE,
                                        batch_buckets=(8,), device=dev)
        if fused:
            probs = engines[name].infer(x)
            counts = read()
    swin_s = time.perf_counter() - t0
    tables = [k for k in loaded
              if k.endswith("relative_position_bias_table")]
    check(len(tables) == SWIN_BLOCKS and all(
        loaded[k].shape[0] == (2 * BIG_WINDOW - 1) ** 2 for k in tables)
        and all(torch.equal(loaded[k], v)
                for k, v in small.state_dict().items() if k not in tables),
        "Swin-T: 12 bias tables resized to 23², every other tensor copied")
    log(f"Swin-T w{BIG_WINDOW} at {BIG_SIZE}² from the w7 224² state: "
        f"loaded and both engines warmed in {swin_s:.2f}s; launches "
        f"{json.dumps(counts)}")
    check(counts == {wa.KERNEL_NAME: SWIN_BLOCKS * 2},
          "K2 launches == 12 x 2 forwards at N = 144")
    _compare(probs, engines["unfused"].infer(x),
             f"Swin-T {BIG_SIZE}² w{BIG_WINDOW} fused vs unfused, bucket 8")
    _add(launches, counts)
    del engines, small
    torch.cuda.empty_cache()
    k2_err = _check_and_time_k2_at(wa, dev, g, 8)
    log(f"phase 36: K1 at N={BIG_TOKENS} max_abs_err {k1_err:.3e}, K2 at "
        f"N={BIG_WINDOW ** 2} {k2_err:.3e}")
    return {"launches": launches, "step_dir": step_dir, "served": served,
            "k1_err": k1_err, "k2_err": k2_err}


def _classify_tta(fa, wa, nms_ops, dev, seed, step_dir, served) -> dict:
    """Phase 37: the checkpoint served with ``tta=True`` (buckets 1/8):
    two forwards a batch (K1 launches 24 a TTA forward); its answers the
    mean of the plain engine's softmax over the images and their mirror
    images (1e-6); latency at buckets 1 and 8 against the plain engine,
    in turns."""
    from deeplearning_tpu_torch import hub
    reset, read = _counters(fa, wa, nms_ops)
    x = np.random.default_rng(seed + 37).normal(
        size=(8, 224, 224, 3)).astype(np.float32)
    reset()
    tta = hub.serve(MODEL, ckpt=step_dir, image_size=224,
                    batch_buckets=SERVE_BUCKETS, attn="flash_hb",
                    device=dev, tta=True)
    got = [tta.infer(x), tta.infer(x[:1])]
    counts = read()
    want = [(served.infer(x) + served.infer(x[:, :, ::-1])) / 2,
            (served.infer(x[:1]) + served.infer(x[:1, :, ::-1])) / 2]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    log(f"TTA engine: {json.dumps(tta.stats())}; vs the plain engine's "
        f"mean over the flip: max |dp| {diff:.3e}; launches "
        f"{json.dumps(counts)}")
    check(diff <= 1e-6, "TTA == the mean of the two views' softmax")
    check(tta.trace_count == tta.compile_count == 2,
          "TTA keeps trace_count == compile_count == len(buckets)")
    check(counts == {fa.KERNEL_NAMES[4]: 2 * DEPTH * 4},
          "K1 launches == 24 x 4 TTA forwards")
    _bucket_latency({"plain": served, "tta": tta}, ("plain", "tta"),
                    MODEL + " TTA")
    return counts


def _yolox_eval_tta(nms_ops, dev, seed) -> tuple:
    """Phase 38: YOLOX-S at 640² through ``train.detection`` (``build``, 4
    steps, ``evaluate``) with ``train.eval_tta`` at score 0.01: the plain
    evaluation, then the TTA one (``tta_predict_fn``: views 640, 544
    flipped and 416, one NMS over 18 018 candidates an image), K3 once a
    predict call. So early no candidate passes 0.01, so the kernel is
    also held at score 0 on one TTA predict of the same images (every
    candidate alive, 100 slots): its candidates through K3 and through the
    plain sweep, equal keep sets, and K3 timed at both thresholds by graph
    replay; the plain and TTA predict calls timed in turns. Returns (K3
    launches of the evaluations, mismatching slots)."""
    import contextlib
    import io
    import torch
    from deeplearning_tpu_torch.core.config import load_config
    from deeplearning_tpu_torch.core.experiment import get_exp
    from deeplearning_tpu_torch.ops.tta import yolox_tta
    from deeplearning_tpu_torch.train import detection as det
    cfg = load_config(det.DetConfig(), None, get_exp(
        exp_name=YOLOX).cli_overrides() + [
        f"data.n_train={TTA_BATCH}", "train.steps=4",
        "train.multiscale=false", "train.eval_tta=true",
        "train.eval_score_thresh=0.01", f"train.seed={seed}"])
    t0 = time.perf_counter()
    r = det.build(cfg)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            losses = [float(m["loss"]) for _, _, m in det.train_steps(r)]
    finally:
        r.close()
    train_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    nms_ops.reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        summary = det.evaluate(r)[0]
        (tta_summary, _, calls), recorded = _record_nms(
            nms_ops, lambda: det.evaluate(r, det.tta_predict_fn(r),
                                          tag="TTA "))
    torch.cuda.synchronize()
    launched = nms_ops.launch_counts()["nms_greedy_sweep"]
    log(printed.getvalue().rstrip())
    shapes = [tuple(c[1].shape) for c in recorded]
    log(f"YOLOX-S trained 4 steps in {train_s:.1f}s (losses "
        f"{[round(v, 3) for v in losses]}); AP {summary['AP']:.4f}, TTA AP "
        f"{tta_summary['AP']:.4f}; TTA NMS candidates {shapes}, K3 "
        f"launches {launched} over 2 predict calls")
    check(all(np.isfinite(losses)) and len(calls) == 1 and launched == 2,
          "K3 once a predict call, plain and TTA")
    check(shapes == [(TTA_BATCH, TTA_CANDIDATES)],
          "one NMS over 32 x 18 018 candidates")
    images = torch.from_numpy(r.arrays[0]).to(dev)
    _, at_zero = _record_nms(nms_ops, lambda: yolox_tta(
        r.model, images, score_thresh=0.0, max_det=YOLOX_MAX_DET))
    bad = 0
    for boxes, scores, th, mo, st in recorded + at_zero:
        got = nms_ops.nms(boxes, scores, th, mo, st, impl="auto")
        ref = nms_ops.nms(boxes, scores, th, mo, st, impl="blocked")
        torch.cuda.synchronize()
        bad += _keep_mismatches(ref, got)
        alive = int((scores > st).sum())
        log(f"K3 vs the plain sweep at {tuple(scores.shape)} (score > {st}, "
            f"{alive} alive, max_out {mo}): {_keep_mismatches(ref, got)} "
            f"mismatching slots, {int(got[1].sum())} kept")
        ms, plain, bound, kept, ious = _time_k3(nms_ops, boxes, scores, st,
                                                th, mo)
        bytes_ms, ops_ms = bound
        log(f"timing nms yolox_s TTA B={scores.shape[0]} "
            f"N={scores.shape[1]} th={th} max_out={mo} score>{st}: "
            f"nms_greedy_sweep {ms['kernel']:.4f} ms (graph replay), whole "
            f"call {ms['call']:.4f} ms; plain sweep {plain['sweep']:.4f} "
            f"ms, plain call {plain['call']:.4f} ms; bound "
            f"{max(bytes_ms, ops_ms):.5f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'}); kept "
            f"{kept}, greedy IoUs {ious}")
    boxes, scores, th, mo, st = at_zero[0]
    kept = nms_ops.nms(boxes, scores, th, mo, st, impl="auto")[1]
    check(bad == 0 and int((scores > st).sum()) == scores.numel()
          and 0 < int(kept.sum()) <= TTA_BATCH * YOLOX_MAX_DET,
          "K3 == the plain sweep over 18 018 candidates an image")
    fns = {"plain": r.predict_fn, "tta": det.tta_predict_fn(r)}
    times = {"plain": [], "tta": []}
    for name in ("plain", "tta", "tta", "plain") * 2:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[name](images)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
    log(f"YOLOX-S predict at batch {TTA_BATCH}, 640² (CUDA events, in "
        f"turns, median of 4): " + json.dumps(
            {k: round(statistics.median(v), 3) for k, v in times.items()}))
    del r, images
    torch.cuda.empty_cache()
    return launched, bad


def _serve_subprocess(argv, env, root):
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning_tpu_torch.serve", *argv],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _supervised_cli(fa, wa, nms_ops, dev, seed, step_dir, workdir) -> dict:
    """Phase 39: the serve CLI under supervision. ``python -m
    deeplearning_tpu_torch.serve --ckpt <step> --http 0`` in a process of
    its own with ``DLTPU_HEARTBEAT``, ``DLTPU_STANDBY=1``,
    ``DLTPU_TRACE=1`` and ``DLTPU_FAULTS=preempt_replica:0@step:3``: 503
    until ``/admin/promote``, then 3 answers, the heartbeat's step
    following the dispatches, exit 75 and ``trace.json`` written. A second
    run with ``crash_replica:0@step:1`` exits with neither 0 nor 75. Then
    the CLI in stdin mode in this process: a seeded PNG and the ``.npy``
    preprocessed from it get the same answer (K1 counted: 12 x 3
    forwards)."""
    import contextlib
    import io
    from deeplearning_tpu_torch.elastic.heartbeat import read_heartbeat
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(workdir, exist_ok=True)
    beat = os.path.join(workdir, "heartbeat.json")
    trace = os.path.join(workdir, "trace.json")
    for path in (beat, trace):
        if os.path.exists(path):
            os.remove(path)
    argv = ["--model", MODEL, "--ckpt", step_dir, "--buckets", "1",
            "--seed", str(seed), "--device", str(dev)]
    env = dict(os.environ, DLTPU_HEARTBEAT=beat, DLTPU_STANDBY="1",
               DLTPU_TRACE="1", DLTPU_TRACE_FILE=trace, DLTPU_REPLICA="0",
               DLTPU_FAULTS=f"preempt_replica:0@step:{PREEMPT_AT}")
    img = np.random.default_rng(seed + 39).normal(
        size=(224, 224, 3)).astype(np.float32)
    t0 = time.perf_counter()
    proc = _serve_subprocess(argv + ["--http", "0"], env, root)
    try:
        url = json.loads(proc.stdout.readline())["serving"]
        standby, _ = _post(url + "/predict", _npy(img))
        promoted = _post(url + "/admin/promote")
        steps, codes = [], []
        for _ in range(PREEMPT_AT):
            codes.append(_post(url + "/predict", _npy(img))[0])
            deadline = time.monotonic() + 5.0
            doc = read_heartbeat(beat)
            while (doc is None or doc["step"] < len(codes)) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
                doc = read_heartbeat(beat)
            steps.append(None if doc is None else doc["step"])
        proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    final = read_heartbeat(beat)
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "serve/dispatch"]
    log(f"supervised serve CLI: standby -> {standby}, promote -> "
        f"{promoted}, predicts {codes}, heartbeat steps {steps} (final "
        f"{final['step']}, phase {final['phase']!r}), exit "
        f"{proc.returncode}, trace.json {len(spans)} dispatch spans, after "
        f"{time.perf_counter() - t0:.2f}s")
    check(standby == 503 and promoted[0] == 200 and promoted[1]["promoted"]
          and codes == [200] * PREEMPT_AT
          and steps == list(range(1, PREEMPT_AT + 1))
          and final["step"] == PREEMPT_AT and proc.returncode == 75
          and len(spans) == PREEMPT_AT,
          "503 until promoted, answers, heartbeat, exit 75 with trace.json")

    env = dict(os.environ, DLTPU_REPLICA="0",
               DLTPU_FAULTS="crash_replica:0@step:1")
    t0 = time.perf_counter()
    proc = _serve_subprocess(argv + ["--http", "0"], env, root)
    try:
        url = json.loads(proc.stdout.readline())["serving"]
        try:
            code = _post(url + "/predict", _npy(img), timeout=60.0)[0]
        except OSError as exc:        # the process died mid-answer
            code = repr(exc)
        proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"crash_replica: predict -> {code}, exit {proc.returncode} after "
        f"{time.perf_counter() - t0:.2f}s")
    check(proc.returncode not in (0, 75), "a crash exits neither 0 nor 75")

    from PIL import Image
    png = os.path.join(workdir, "request.png")
    npy = os.path.join(workdir, "request.npy")
    pixels = np.random.default_rng(seed + 40).integers(0, 256, (300, 260, 3))
    Image.fromarray(pixels.astype(np.uint8)).save(png)
    np.save(npy, serve_cli.load_request_images(png, 224, "classify")[0])
    reset, read = _counters(fa, wa, nms_ops)
    printed = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(f"{png}\n{npy}\n")
    reset()
    try:
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = serve_cli.main(argv)
    finally:
        sys.stdin = stdin
    counts = read()
    answers = [json.loads(line) for line in
               printed.getvalue().strip().splitlines()]
    log(f"stdin CLI: PNG {answers[0]['top'][:2]}, its .npy "
        f"{answers[1]['top'][:2]}; launches {json.dumps(counts)}")
    check(rc == 0 and len(answers) == 2
          and answers[0]["top"] == answers[1]["top"],
          "a PNG request answers as the .npy preprocessed from it")
    check(counts == {fa.KERNEL_NAMES[4]: DEPTH * 3},
          "K1 launches == 12 x 3 forwards (a warmup, two requests)")
    return counts


# ------------------ phases 40-42: the mesh step (multi-GPU, first half)
MESH_STEPS = 3                    # steps a mode in phase 40
MESH_MODES = (("replicated", "fp32"), ("zero1", "fp32"),
              ("replicated", "int8"), ("zero1", "int8"))
MESH_RUNS = 6                     # phase 41: runs of 3 steps a variant
INT8_NORM_TOL = 2 / 127           # two block quantizations
MESH_TRAIN_STEPS = 2              # phase 42's Trainer: one epoch


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_start():
    """Phase 40's world: one NCCL rank in this process, the data=-1
    mesh over it."""
    from deeplearning_tpu_torch.parallel.mesh import (MeshConfig,
                                                      build_mesh,
                                                      initialize_distributed)
    check(initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device="cuda", local_rank=0),
          "the smoke started its own process group")
    mesh = build_mesh(MeshConfig(data=-1))
    log(f"process group: nccl, world 1; mesh {mesh}, device {mesh.device}")
    return mesh


def _mesh_state(seed, dev, mesh, zero1, lr=None):
    from deeplearning_tpu_torch.train.steps import shard_state
    return shard_state(_train_state("flash_hb", seed, dev, lr=lr), mesh,
                       zero1=zero1)


def _mesh_step(mesh, weight_update, grad_comm):
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    return make_train_step(make_loss_fn(label_smoothing=0.1), mesh=mesh,
                           weight_update=weight_update, grad_comm=grad_comm)


def _moments(state) -> list:
    """Adam's mu and nu (the first transform of AdamW's chain)."""
    adam = state.opt_state[0]
    return list(adam["mu"].values()) + list(adam["nu"].values())


def _mesh_steps(fa, dev, seed, mesh) -> tuple:
    """Phase 40; returns K1's launches over the four counted runs and the
    first loss of the step without a mesh."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    batch, key = _train_batch(seed, dev), root_key(seed)
    names = [fa.KERNEL_NAMES[4], fa.BWD_KERNEL_NAMES["dq"][4],
             fa.BWD_KERNEL_NAMES["dkv"][4]]
    plain = _train_state("flash_hb", seed, dev)
    plain, m = make_train_step(make_loss_fn(label_smoothing=0.1),
                               device=dev)(plain, batch, key)
    ref = _metrics(m)
    launches = {n: 0 for n in names}
    for wu, comm in MESH_MODES:
        state = _mesh_state(seed, dev, mesh, wu == "zero1")
        step = _mesh_step(mesh, wu, comm)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        coll.reset_launch_counts()
        t0 = time.perf_counter()
        metrics, equal = [], None
        for i in range(MESH_STEPS):
            state, mm = step(state, batch, key)
            metrics.append(mm)
            if i == 0 and comm == "fp32":
                equal = (all(torch.equal(a, b) for a, b in zip(
                    state.params.values(), plain.params.values()))
                    and all(torch.equal(a, b) for a, b in zip(
                        _moments(state), _moments(plain))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, ccounts = fa.launch_counts(), coll.launch_counts()
        metrics = [_metrics(x) for x in metrics]
        log(f"mesh step {wu}/{comm}: {MESH_STEPS} steps in {wall:.2f}s, "
            f"losses {[round(x['loss'], 5) for x in metrics]}, grad_norm "
            f"{metrics[0]['grad_norm']:.5f}, K1 {json.dumps(counts)}, "
            f"collectives {json.dumps(ccounts)}, moments sharded "
            f"{state.sharding.any_sharded}")
        for name in names:
            check(counts[name] == DEPTH * MESH_STEPS,
                  f"{wu}/{comm}: {name} launches == {DEPTH} x "
                  f"{MESH_STEPS} steps")
            launches[name] += counts[name]
        check(sum(counts.values()) == 3 * DEPTH * MESH_STEPS,
              f"{wu}/{comm} launched only flash_hb's kernels")
        if comm == "fp32":
            check(equal, f"{wu}: params and moments after one step "
                         f"bit-equal to the step without a mesh")
            check(ccounts["all_reduce"] == 2 * MESH_STEPS
                  and ccounts["all_to_all"] == 0,
                  f"{wu}: one packed all-reduce of the gradients and one "
                  f"of the metrics a step")
        else:
            dn = abs(metrics[0]["grad_norm"] - ref["grad_norm"]) \
                / ref["grad_norm"]
            log(f"  int8 first step vs float32: loss {metrics[0]['loss']!r}"
                f" vs {ref['loss']!r}, grad_norm rel {dn:.3e} (tol "
                f"{INT8_NORM_TOL:.4f})")
            check(metrics[0]["loss"] == ref["loss"] and dn <= INT8_NORM_TOL,
                  f"{wu}/int8: loss equal, grad_norm within 2/127")
            check(ccounts["all_to_all"] == 2 * MESH_STEPS
                  and ccounts["all_gather"] == 2 * MESH_STEPS
                  and ccounts["all_reduce"] == MESH_STEPS,
                  f"{wu}/int8: one packed reduction a step")
        del state
        torch.cuda.empty_cache()
    del plain
    state = _mesh_state(seed, dev, mesh, False, lr=1e-4)
    step = _mesh_step(mesh, "replicated", "int8")
    losses = []
    for _ in range(8):
        state, mm = step(state, batch, key)
        losses.append(mm["loss"])
    losses = [float(x) for x in losses]
    log(f"fixed batch, constant lr 1e-4, int8 mesh step: losses "
        f"{[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "int8 training on a fixed batch lowers the loss")
    del state
    torch.cuda.empty_cache()
    return launches, ref["loss"]


def _measure_mesh(dev, seed, mesh) -> None:
    """Phase 41: step times in turns; the int8 quantizers and the one-rank
    all-reduce of ViT-B/16's gradient bytes."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    batch, key = _train_batch(seed, dev), root_key(seed)
    runs = {"no_mesh": (_train_state("flash_hb", seed, dev),
                        make_train_step(make_loss_fn(label_smoothing=0.1),
                                        device=dev))}
    for wu, comm in MESH_MODES:
        runs[f"{wu}/{comm}"] = (_mesh_state(seed, dev, mesh, wu == "zero1"),
                                _mesh_step(mesh, wu, comm))
    order = list(runs) + list(reversed(runs))
    times = {k: [] for k in runs}
    for name in order * (MESH_RUNS // 2):
        state, step = runs[name]
        state, _ = step(state, batch, key)            # untimed warm step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, batch, key)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 3)
    for name, ts in times.items():
        dt = statistics.median(ts)
        log(f"mesh step time {name} batch {TRAIN_BATCH}: "
            f"{json.dumps({'step_time_ms': round(dt * 1e3, 3), 'images_per_sec': round(TRAIN_BATCH / dt, 1), 'runs_ms': [round(t * 1e3, 2) for t in ts]})}")
    n = sum(p.numel() for p in runs["no_mesh"][0].params.values())
    del runs, state
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pad = -(-n // 256) * 256
    grads = torch.randn(n_pad, device=dev, generator=g) * 1e-3
    blocks = grads.view(-1, 256)
    q, sc = coll._quantize_blocks(blocks)
    q_ms = graph_ms(lambda: coll._quantize_blocks(blocks))
    d_ms = graph_ms(lambda: coll._dequantize_blocks(q, sc))
    scale_bytes = n_pad // 256 * 4
    moved = {"quantize": n_pad * 4 + n_pad + scale_bytes,
             "dequantize": n_pad + scale_bytes + n_pad * 4}
    for what, ms in (("quantize", q_ms), ("dequantize", d_ms)):
        bound = moved[what] / HBM_BYTES_PER_S * 1e3
        log(f"timing int8 {what} of {n} float32 gradients (blocks of 256): "
            f"{ms:.4f} ms (graph replay), bound {bound:.4f} ms "
            f"({moved[what] / 1e9:.3f} GB; {moved[what] / ms / 1e6:.0f} "
            f"GB/s achieved)")
    err = (coll._dequantize_blocks(q, sc) - blocks).abs().amax(dim=-1)
    # |x - q s| <= s / 2 <= max|block| / 127 (s a few ulps off 2^k)
    check(bool((err <= blocks.abs().amax(dim=-1) / 127 * (1 + 1e-5))
               .all()),
          "the int8 blocks hold each value within max|block| / 127")
    group = mesh.group(("data", "fsdp"))

    def events_ms(fn, iters=10):
        for _ in range(2):
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

    flat = grads[:n]
    ar_ms = events_ms(lambda: coll.all_reduce(flat, group))
    qr_ms = events_ms(lambda: coll.quantized_reduce([flat], [False], group))
    log(f"timing one-rank NCCL all-reduce of {n * 4 / 1e6:.1f} MB: "
        f"{ar_ms:.4f} ms; packed int8 reduction of the same: {qr_ms:.4f} ms "
        f"(CUDA events)")
    del grads, blocks, q, sc, flat
    torch.cuda.empty_cache()


def _mesh_trainer(fa, dev, seed, mesh, workdir) -> dict:
    """Phase 42; returns K1's launches over the Trainer's run."""
    import dataclasses
    import shutil
    import torch
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    from deeplearning_tpu_torch.elastic.preempt import agree_preempt_step
    from deeplearning_tpu_torch.elastic.resume import elastic_restore
    from deeplearning_tpu_torch.elastic.topology import (current_topology,
                                                         topology_changed)
    from deeplearning_tpu_torch.train import make_eval_step
    from deeplearning_tpu_torch.train.classification import make_metric_fn
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = _smoke_cfg(workdir, MESH_TRAIN_STEPS)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1, weight_update="zero1"))
    trainer = cli.build(cfg)
    check(trainer.weight_update == "zero1"
          and trainer.state.sharding is not None
          and trainer.state.sharding.mesh.size == 1,
          "the CLI built the Trainer on the running group's mesh")
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    names = [fa.KERNEL_NAMES[4], fa.BWD_KERNEL_NAMES["dq"][4],
             fa.BWD_KERNEL_NAMES["dkv"][4]]
    eval_batches = len(trainer.eval_loader)
    want = {names[0]: DEPTH * (MESH_TRAIN_STEPS + eval_batches),
            names[1]: DEPTH * MESH_TRAIN_STEPS,
            names[2]: DEPTH * MESH_TRAIN_STEPS}
    side = trainer.ckpt.topology(MESH_TRAIN_STEPS)
    log(f"mesh Trainer (zero1): {MESH_TRAIN_STEPS} steps + eval in "
        f"{wall:.2f}s, eval {json.dumps(trainer._last_eval)}, launches "
        f"{json.dumps(counts)}, topology.json {json.dumps(side)}")
    for name, n in want.items():
        check(counts[name] == n, f"{name} launches == {n}")
    check(side is not None and side["weight_update"] == "zero1"
          and side["process_count"] == 1 and side["platform"] == "gpu"
          and side["mesh_shape"]["data"] == 1,
          "topology.json records the one-rank zero1 run")
    saved = trainer.state.state_dict()
    ckpt_dir = trainer.ckpt.directory
    del trainer
    torch.cuda.empty_cache()
    restored, step = elastic_restore(CheckpointManager(ckpt_dir),
                                     _train_state("flash_hb", seed, dev),
                                     mesh, zero1=False)
    same = (all(torch.equal(p, saved["params"][n])
                for n, p in restored.params.items())
            and all(torch.equal(a, b) for a, b in zip(
                _moments(restored), list(saved["opt_state"][0]["mu"].values())
                + list(saved["opt_state"][0]["nu"].values()))))
    current = current_topology(state=restored, weight_update="replicated")
    changed = topology_changed(side, current)
    log(f"elastic_restore into replicated: step {step}, params and moments "
        f"bit-equal {same}, topology_changed {changed} "
        f"({side['weight_update']} -> {current['weight_update']})")
    check(step == MESH_TRAIN_STEPS and same and changed,
          "elastic_restore: bit-equal, and the change reported")
    batch = _train_batch(seed, dev)
    on_mesh = make_eval_step(make_metric_fn(), mesh=mesh)(restored, batch)
    alone = make_eval_step(make_metric_fn(), device=dev)(restored, batch)
    on_mesh = {k: float(v) for k, v in on_mesh.items()}
    alone = {k: float(v) for k, v in alone.items()}
    log(f"eval step on the mesh {json.dumps(on_mesh)}, without "
        f"{json.dumps(alone)}")
    check(on_mesh == alone, "make_eval_step(mesh) equals the plain eval")
    check(agree_preempt_step(7) == 7, "agree_preempt_step at one rank")
    del restored, saved
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return want


MESH_RANKS = 2                    # phase 43: processes on cuda:0
MESH_RANK_STEPS = 2


def _mesh_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 43's ranks: a gloo group on cuda:0 through a file,
    ViT-B/16 with ZeRO-1 and the int8 collectives on this rank's half of
    the global batch; writes what it saw to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import (MeshConfig,
                                                      build_mesh,
                                                      initialize_distributed)
    from deeplearning_tpu_torch.parallel.sharding import (
        tree_bytes_per_device, zero1_partition_spec)
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train.steps import shard_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    initialize_distributed(
        f"file://{os.path.join(workdir, 'store')}", MESH_RANKS, rank,
        device="cuda", local_rank=0, backend="gloo")
    try:
        mesh = build_mesh(MeshConfig(data=-1), device=dev)
        state = shard_state(_train_state("flash_hb", seed, dev), mesh,
                            zero1=True)
        shapes = [p.shape for p in state.params.values()]
        whole = sum(2 * 4 * int(np.prod(sh)) for sh in shapes)
        tail = sum(2 * 4 * int(np.prod(sh)) for sh in shapes
                   if not zero1_partition_spec(tuple(sh), MESH_RANKS))
        step = _mesh_step(mesh, "zero1", "int8")
        per = TRAIN_BATCH // MESH_RANKS
        batch = {k: v[rank * per:(rank + 1) * per]
                 for k, v in _train_batch(seed, dev).items()}
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        coll.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = []
        for _ in range(MESH_RANK_STEPS):
            state, m = step(state, batch, root_key(seed))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        out = {"rank": rank, "metrics": metrics,
               "seconds": time.perf_counter() - t0,
               "launches": fa.launch_counts(),
               "collectives": coll.launch_counts(),
               "moment_bytes": tree_bytes_per_device(state.opt_state),
               "whole_bytes": whole, "tail_bytes": tail,
               "split_leaves": sum(not s.is_fully_replicated for s in
                                   state.sharding.moments.values())}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _two_ranks_on_one_card(seed, ref_loss, workdir) -> None:
    """Phase 43: two processes of this script on cuda:0 over gloo."""
    import shutil
    import torch
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--mesh-rank", str(r), "--mesh-dir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
        check(p.returncode == 0, f"phase 43 rank {r} ran")
    outs = []
    for r in range(MESH_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for o in outs:
        log(f"rank {o['rank']} of {MESH_RANKS} on cuda:0 (gloo), zero1 + "
            f"int8, {TRAIN_BATCH // MESH_RANKS} images: losses "
            f"{[round(m['loss'], 5) for m in o['metrics']]}, grad_norm "
            f"{o['metrics'][0]['grad_norm']:.5f}, {MESH_RANK_STEPS} steps "
            f"in {o['seconds']:.2f}s, launches {json.dumps(o['launches'])},"
            f" collectives {json.dumps(o['collectives'])}, moment bytes "
            f"{o['moment_bytes']} of {o['whole_bytes']} ({o['split_leaves']}"
            f" leaves split, {o['tail_bytes']} bytes whole)")
        for name in ("flash_attn_fwd_hb", "flash_attn_bwd_dq_hb",
                     "flash_attn_bwd_dkv_hb"):
            check(o["launches"][name] == DEPTH * MESH_RANK_STEPS,
                  f"rank {o['rank']}: {name} == {DEPTH} x "
                  f"{MESH_RANK_STEPS}")
        check(o["moment_bytes"] == (o["whole_bytes"] - o["tail_bytes"])
              // MESH_RANKS + o["tail_bytes"] and o["split_leaves"] > 0,
              f"rank {o['rank']} holds 1/{MESH_RANKS} of the split moments")
        check(all(np.isfinite(v) for m in o["metrics"] for v in m.values()),
              "finite metrics")
    losses = [[m["loss"] for m in o["metrics"]] for o in outs]
    rel = abs(losses[0][0] - ref_loss) / abs(ref_loss)
    log(f"phase 43: {wall:.1f}s with the processes' start; first loss "
        f"{losses[0][0]:.6f} vs {ref_loss:.6f} without a mesh (rel "
        f"{rel:.2e}, tol 1e-3)")
    check(losses[0] == losses[1] and rel <= 1e-3,
          "both ranks report the averaged loss of the whole batch")
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()


# ------ phases 44-46: sequence and pipeline parallelism (multi-GPU, 7b)
SP_SIZE, SP_BATCH, SP_STEPS = 240, 16, 2   # phase 45: N = 226, 113 a rank
PP_STAGES, PP_MICRO, PP_BATCH, PP_STEPS = 2, 4, 32, 2     # phase 46
# relative, set from the readings on an H100: the ring's first loss
# 2.09e-07, its grad_norm 8.40e-05 and its second loss 5.97e-05 off the
# steps without sequence parallelism
PAR_LOSS_TOL, PAR_NORM_TOL = 1e-4, 1e-3


def _seq_one_rank(fa, dev, g, mesh) -> dict:
    """Phase 44: the ring and Ulysses on K1 over the one rank of a
    ``seq = 1`` mesh at ViT-B/16's training shape; returns their K1
    launches (the kernels line's flash_attn_fwd / _bwd_dq / _bwd_dkv)."""
    import torch
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attention)
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attention
    b, h, n, d = TRAIN_BATCH, HEADS, TOKENS, HEAD_DIM
    q, k, v, _, _, do = _bwd_inputs(fa, dev, g, b, h, n, d, torch.bfloat16,
                                    False)
    names = ["flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"]
    fns = {"k1": fa.flash_attention,
           "ring": make_ring_attention(mesh, use_flash=True),
           "ulysses": make_ulysses_attention(mesh,
                                             attn_fn=fa.flash_attention)}

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*xs)
        return (out,) + torch.autograd.grad(out, xs, do)

    got, launched = {}, {nm: 0 for nm in names}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        coll.reset_launch_counts()
        got[name] = fwd_bwd(fn)
        torch.cuda.synchronize()
        counts, ccounts = fa.launch_counts(), coll.launch_counts()
        log(f"one rank, {name}: launches {json.dumps(counts)}, collectives "
            f"{json.dumps(ccounts)}")
        check({nm: counts[nm] for nm in names} == dict.fromkeys(names, 1)
              and sum(counts.values()) == 3,
              f"{name}: one K1 forward, one dQ and one dK/dV launch")
        check(not any(ccounts.values()),
              f"{name} over one rank issues no collective")
        if name != "k1":
            for nm in names:
                launched[nm] += counts[nm]
    for name in ("ring", "ulysses"):
        check(torch.equal(got[name][0], got["k1"][0]),
              f"{name}'s forward bit-equal to K1's flash_attention")
        res = [_grad_err(x, w, "bfloat16")
               for x, w in zip(got[name][1:], got["k1"][1:])]
        log(f"one rank, {name} vs K1: forward bit-equal, dq/dk/dv max abs "
            f"{[f'{e:.3e}' for e, _ in res]} (phase 5's bf16 tolerance)")
        check(all(ok for _, ok in res), f"{name}'s gradients within "
              "phase 5's bf16 tolerance of K1's backward")
    del got
    # forward + backward in turns (k1, ring, ring, k1); the ring issues no
    # collective at one rank, so the whole call captures in a CUDA graph
    times = {"k1": [], "ring": []}
    for name in ("k1", "ring", "ring", "k1"):
        times[name].append(graph_ms(lambda: fwd_bwd(fns[name]), calls=5,
                                    replays=4))
    nbytes = fa.min_bytes(b, h, n, d, 2) + fa.bwd_min_bytes(b, h, n, d, 2)
    flops = fa.flops(b, h, n, d) + fa.bwd_flops(b, h, n, d)
    bound = max(nbytes / HBM_BYTES_PER_S,
                flops / PEAK_FLOPS["bfloat16"]) * 1e3
    k1_ms, ring_ms = (statistics.mean(times[x]) for x in ("k1", "ring"))
    log(f"timing one-rank ring vs K1, forward + backward B={b} H={h} N={n} "
        f"D={d} bf16 (CUDA-graph replay, in turns): ring {ring_ms:.4f} ms "
        f"{[round(t, 4) for t in times['ring']]}, K1 {k1_ms:.4f} ms "
        f"{[round(t, 4) for t in times['k1']]} ({ring_ms / k1_ms:.3f}x), "
        f"bound {bound:.4f} ms")
    del q, k, v, do
    torch.cuda.empty_cache()
    return launched


def _par_start(phase_n, seed, workdir, ranks=MESH_RANKS) -> dict:
    """Start ``ranks`` processes of this script on cuda:0, ranks of a gloo
    group (``--par-phase``). A phase may start the next phase's ranks
    beside its own work, so their start-up (imports, CUDA, the model build)
    overlaps it; their results are parity and layout, not timings. Any
    still running when this process exits are killed."""
    import atexit
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--par-phase", str(phase_n), "--mesh-rank", str(r),
         "--mesh-dir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"phase": phase_n, "procs": procs, "workdir": workdir,
            "ranks": ranks, "t0": time.perf_counter()}


def _par_spawn(phase_n, seed, workdir, ranks=MESH_RANKS,
               started=None) -> tuple:
    """The ranks of ``_par_start`` (or those ``started`` earlier), waited
    for; returns (their rank<r>.json, the seconds from their start)."""
    import shutil
    run = started or _par_start(phase_n, seed, workdir, ranks)
    procs, t0 = run["procs"], run["t0"]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
        check(p.returncode == 0, f"phase {phase_n} rank {r} ran")
    outs = []
    for r in range(run["ranks"]):
        with open(os.path.join(run["workdir"], f"rank{r}.json")) as f:
            outs.append(json.load(f))
    shutil.rmtree(run["workdir"], ignore_errors=True)
    return outs, wall


def _par_group(rank: int, workdir: str, ranks: int = MESH_RANKS):
    import torch
    from deeplearning_tpu_torch.parallel.mesh import initialize_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(
        f"file://{os.path.join(workdir, 'store')}", ranks, rank,
        device="cuda", local_rank=0, backend="gloo")


def _par_done(rank: int, workdir: str, out: dict) -> int:
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _sp_batch(seed, dev):
    import torch
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(size=(
                SP_BATCH, SP_SIZE, SP_SIZE, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(0, 1000,
                                                   SP_BATCH)).to(dev)}


def _sp_attention(fa, mesh, rank: int, seed: int, dev) -> dict:
    """The ring (its merge of K1's LSE across chunks) and Ulysses over the
    seq ranks at phase 45's shape (B=16, H=12, N=226, D=64, bf16), this
    rank's chunk against K1 on the whole sequence: (max abs error, within
    phase 5's bf16 tolerance) of the output and of dq / dk / dv."""
    import torch
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attention)
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attention
    n = (SP_SIZE // 16) ** 2 + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, _, _, do = _bwd_inputs(fa, dev, g, SP_BATCH, HEADS, n,
                                    HEAD_DIM, torch.bfloat16, False)

    def fwd_bwd(fn, *xs):
        xs = [x.detach().requires_grad_() for x in xs]
        out = fn(*xs[:3])
        return (out,) + torch.autograd.grad(out, xs[:3], xs[3])

    full = fwd_bwd(fa.flash_attention, q, k, v, do)
    nl = n // MESH_RANKS
    mine = [x[:, :, rank * nl:(rank + 1) * nl] for x in (q, k, v, do)]
    errs = {}
    for name, fn in (("ring", make_ring_attention(mesh, use_flash=True)),
                     ("ulysses", make_ulysses_attention(
                         mesh, attn_fn=fa.flash_attention))):
        got = fwd_bwd(fn, *mine)
        errs[name] = [_grad_err(x, w[:, :, rank * nl:(rank + 1) * nl],
                                "bfloat16") for x, w in zip(got, full)]
    return errs


def _sp_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 45's ranks: ViT-B/16 at 240² on a data 1 x seq 2
    mesh: the attention check, then two steps with the ring on K1 and two
    with Ulysses on K1."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attn_fn)
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attn_fn
    from deeplearning_tpu_torch.train.steps import shard_state
    dev = torch.device("cuda")
    _par_group(rank, workdir)
    mesh = build_mesh(MeshConfig(data=1, seq=MESH_RANKS), device=dev)
    batch = _sp_batch(seed, dev)
    out = {"rank": rank, "attention": _sp_attention(fa, mesh, rank, seed,
                                                    dev)}
    for name, make in (("ring", make_ring_attn_fn),
                       ("ulysses", make_ulysses_attn_fn)):
        state = shard_state(_train_state(
            "flash", seed, dev, img_size=SP_SIZE,
            attn_fn=make(mesh, use_flash=True)), mesh)
        step = _mesh_step(mesh, "replicated", "fp32")
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        coll.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = []
        for _ in range(SP_STEPS):
            state, m = step(state, batch, root_key(seed))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        out[name] = {"metrics": metrics,
                     "seconds": time.perf_counter() - t0,
                     "launches": fa.launch_counts(),
                     "collectives": coll.launch_counts()}
        del state
        torch.cuda.empty_cache()
    return _par_done(rank, workdir, out)


def _seq_two_ranks(seed, dev, workdir) -> None:
    """Phase 45: the steps without sequence parallelism on the same
    weights and batch here, then two processes on cuda:0 over gloo."""
    import torch
    ref = _plain_steps(seed, dev, _sp_batch(seed, dev), SP_STEPS,
                       img_size=SP_SIZE)
    outs, wall = _par_spawn(45, seed, workdir)
    per_step = {"ring": MESH_RANKS * DEPTH, "ulysses": DEPTH}
    for o in outs:
        for name, res in o["attention"].items():
            log(f"rank {o['rank']}, seq = {MESH_RANKS}, {name} on K1 vs K1 "
                f"on the whole sequence (B={SP_BATCH} H={HEADS} N="
                f"{(SP_SIZE // 16) ** 2 + 1} D={HEAD_DIM} bf16): out/dq/dk/"
                f"dv max abs {[f'{e:.3e}' for e, _ in res]} (phase 5's bf16 "
                f"tolerance)")
            check(all(ok for _, ok in res), f"rank {o['rank']} {name}: "
                  "output and gradients within phase 5's bf16 tolerance of "
                  "K1 on the whole sequence")
        for name, want in per_step.items():
            r = o[name]
            log(f"rank {o['rank']} of {MESH_RANKS} on cuda:0 (gloo), seq = "
                f"{MESH_RANKS}, {name} on K1, ViT-B/16 {SP_SIZE}² batch "
                f"{SP_BATCH}: losses {[x['loss'] for x in r['metrics']]}, "
                f"grad_norm {r['metrics'][0]['grad_norm']:.5f}, "
                f"{SP_STEPS} steps in {r['seconds']:.2f}s (gloo through "
                f"the host: layout and parity, not speed), launches "
                f"{json.dumps(r['launches'])}, collectives "
                f"{json.dumps(r['collectives'])}")
            for nm in ("flash_attn_fwd", "flash_attn_bwd_dq",
                       "flash_attn_bwd_dkv"):
                check(r["launches"][nm] == want * SP_STEPS,
                      f"rank {o['rank']} {name}: {nm} == {want} x "
                      f"{SP_STEPS}")
            check(all(np.isfinite(v) for m_ in r["metrics"]
                      for v in m_.values()), "finite metrics")
    for name in per_step:
        losses = [[m_["loss"] for m_ in o[name]["metrics"]] for o in outs]
        check(losses[0] == losses[1], f"{name}: both ranks report one loss")
        _hold_steps(f"phase 45 {name}", outs[0][name]["metrics"], ref,
                    "without sequence parallelism")
    log(f"phase 45: {wall:.1f}s with the processes' start")
    torch.cuda.empty_cache()


def _plain_steps(seed, dev, batch, steps, **model_kw) -> list:
    """The metrics of ``steps`` plain train steps (flash_hb, phase 6's
    AdamW and loss) on ``batch``: what phases 45-46 are held against."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    state = _train_state("flash_hb", seed, dev, **model_kw)
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    ref = []
    for _ in range(steps):
        state, m = step(state, batch, root_key(seed))
        ref.append(_metrics(m))
    del state
    torch.cuda.empty_cache()
    return ref


def _hold_steps(what, got, ref, without) -> None:
    """Every step's loss within PAR_LOSS_TOL and the first step's
    grad_norm (the gradients before any update) within PAR_NORM_TOL,
    relative, of the plain steps'. The loss at initialisation barely sees
    the attention; the gradients and the second loss (after an update
    from them) do."""
    rels = [abs(g["loss"] - r["loss"]) / abs(r["loss"])
            for g, r in zip(got, ref)]
    dn = abs(got[0]["grad_norm"] - ref[0]["grad_norm"]) / ref[0]["grad_norm"]
    log(f"{what}: losses {[g['loss'] for g in got]} vs "
        f"{[r['loss'] for r in ref]} {without} (rel "
        f"{[f'{x:.2e}' for x in rels]}, tol {PAR_LOSS_TOL}), first "
        f"grad_norm {got[0]['grad_norm']!r} vs {ref[0]['grad_norm']!r} "
        f"(rel {dn:.2e}, tol {PAR_NORM_TOL})")
    check(len(got) == len(ref) and max(rels) <= PAR_LOSS_TOL
          and dn <= PAR_NORM_TOL, f"{what}: every step's loss and the first "
          "grad_norm within tolerance of the plain steps")


def _pp_cfg(workdir):
    """The train CLI's Config for phase 46: ViT-B/16 at 224² as phase 6,
    batch 32 in 4 microbatches over 2 stages, one epoch of 2 steps."""
    import dataclasses
    cfg = _smoke_cfg(workdir, PP_STEPS)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, global_batch=PP_BATCH,
                                      n_train=PP_BATCH * PP_STEPS),
        train=dataclasses.replace(cfg.train, epochs=1,
                                  pipeline_stages=PP_STAGES,
                                  microbatches=PP_MICRO))


def _pp_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 46's ranks: ViT-B/16's 12 blocks as 2 GPipe stages of
    6 (flash_hb) on a model = 2 mesh, two pipeline train steps, then the
    train CLI with train.pipeline_stages=2 on the same group."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.core import checkpoint
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.pipeline_train import (
        make_pipeline_train_step, shard_pipeline_state, vit_pipeline_module)
    from deeplearning_tpu_torch.train import TrainState
    dev = torch.device("cuda")
    _par_group(rank, workdir)
    mesh = build_mesh(MeshConfig(data=-1, model=PP_STAGES), device=dev)
    vit, _ = hub.load(MODEL, num_classes=1000, seed=seed, device="cpu",
                      **hub.model_kwargs(MODEL, "flash_hb"))
    vit_bytes = sum(p.numel() * 4 for p in vit.parameters())
    module, k_per = vit_pipeline_module(vit, PP_STAGES)
    vit.to("meta")       # a template only, as the train CLI keeps it
    module.to(dev)
    state = shard_pipeline_state(
        TrainState.create(model=module, tx=_adamw(module)), mesh)
    step, _ = make_pipeline_train_step(vit, mesh, k_per, PP_MICRO,
                                       label_smoothing=0.1)
    batch = {k: v[:PP_BATCH].clone()
             for k, v in _train_batch(seed, dev).items()}
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    coll.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(PP_STEPS):
        state, m = step(state, batch, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    out = {"rank": rank, "metrics": metrics, "k_per": k_per,
           "seconds": time.perf_counter() - t0,
           "launches": fa.launch_counts(),
           "collectives": coll.launch_counts(),
           "stage_bytes": sum(p.numel() * 4 for n, p in state.params.items()
                              if n.startswith("stages.")),
           "vit_bytes": vit_bytes,
           "state_bytes": _state_bytes(state),
           "allocated": torch.cuda.memory_allocated()}
    del state, module, vit
    torch.cuda.empty_cache()
    # the train CLI over the running group
    cli = _cli()
    ckpt_dir = os.path.join(workdir, "cli")
    trainer = cli.build(_pp_cfg(ckpt_dir))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    out["cli_eval"] = trainer.evaluate()
    torch.cuda.synchronize()
    out["cli_seconds"] = time.perf_counter() - t0
    out["cli_launches"] = fa.launch_counts()
    out["cli_state_bytes"] = _state_bytes(trainer.state)
    out["cli_allocated"] = torch.cuda.memory_allocated()
    out["cli_eval_batches"] = len(trainer.eval_loader)
    out["cli_steps"] = trainer.state.step
    trainer.ckpt.wait_until_finished()
    step_dir = trainer.ckpt._step_dir(trainer.ckpt.latest_step())
    tree = torch.load(os.path.join(step_dir, checkpoint._STATE_FILE),
                      map_location="cpu", weights_only=True)
    out["ckpt_qkv"] = list(tree["params"]["stages.sub0.attn.qkv.weight"]
                           .shape)
    del trainer
    return _par_done(rank, workdir, out)


def _pipeline_two_ranks(seed, dev, workdir, started=None) -> None:
    """Phase 46: the sequential steps on the same weights and batch here,
    then two processes on cuda:0 over gloo (``started`` beside phase
    45)."""
    import torch
    batch = {k: v[:PP_BATCH] for k, v in _train_batch(seed, dev).items()}
    ref = _plain_steps(seed, dev, batch, PP_STEPS)
    del batch
    outs, wall = _par_spawn(46, seed, workdir, started=started)
    ticks = PP_STAGES + PP_MICRO - 1
    for o in outs:
        want = ticks * o["k_per"]
        log(f"rank {o['rank']} of {MESH_RANKS} on cuda:0 (gloo), GPipe "
            f"stage {o['rank']} of {PP_STAGES} ({o['k_per']} blocks, "
            f"{PP_MICRO} microbatches), ViT-B/16 224² batch {PP_BATCH}: "
            f"losses {[x['loss'] for x in o['metrics']]}, grad_norm "
            f"{o['metrics'][0]['grad_norm']:.5f}, {PP_STEPS} steps in "
            f"{o['seconds']:.2f}s (gloo through the host: layout and "
            f"parity, not speed), launches {json.dumps(o['launches'])}, "
            f"collectives {json.dumps(o['collectives'])}, stage params "
            f"{o['stage_bytes']} bytes, the rank's state {o['state_bytes']} "
            f"bytes, memory_allocated {o['allocated']} bytes (the whole "
            f"ViT's parameters: {o['vit_bytes']} bytes)")
        for nm in ("flash_attn_fwd_hb", "flash_attn_bwd_dq_hb",
                   "flash_attn_bwd_dkv_hb"):
            check(o["launches"][nm] == want * PP_STEPS,
                  f"rank {o['rank']}: {nm} == ({PP_STAGES} + {PP_MICRO} - 1)"
                  f" x {o['k_per']} x {PP_STEPS}")
        check(all(np.isfinite(v) for m_ in o["metrics"]
                  for v in m_.values()), "finite metrics")
        # the Trainer evaluates at its one epoch's end, and evaluate() once
        # more after train()
        cli_want = {"flash_attn_fwd_hb": want * (o["cli_steps"]
                                                 + 2 * o["cli_eval_batches"]),
                    "flash_attn_bwd_dq_hb": want * o["cli_steps"],
                    "flash_attn_bwd_dkv_hb": want * o["cli_steps"]}
        log(f"rank {o['rank']}: train CLI train.pipeline_stages="
            f"{PP_STAGES}: {o['cli_steps']} steps + eval in "
            f"{o['cli_seconds']:.2f}s, eval {json.dumps(o['cli_eval'])}, "
            f"launches {json.dumps(o['cli_launches'])}, checkpoint's "
            f"stages.sub0.attn.qkv.weight {o['ckpt_qkv']}, state "
            f"{o['cli_state_bytes']} bytes, memory_allocated "
            f"{o['cli_allocated']} bytes")
        for tag in ("", "cli_"):
            extra = o[f"{tag}allocated"] - o[f"{tag}state_bytes"]
            check(extra < o["vit_bytes"] // 2,
                  f"rank {o['rank']} ({tag or 'step'}): the card holds the "
                  f"rank's state and {extra} bytes more, less than half the "
                  "unsplit ViT's parameters (no whole copy on each stage)")
        check(o["cli_steps"] == PP_STEPS and all(
            o["cli_launches"][k] == v for k, v in cli_want.items()),
            f"rank {o['rank']}: the CLI's K1 launches == {cli_want}")
        check(o["ckpt_qkv"] == [PP_STAGES, 3 * 768, 768],
              "the checkpoint holds the whole stacked state")
    check(outs[0]["metrics"] == outs[1]["metrics"],
          "both stages report the same metrics")
    _hold_steps("phase 46 the pipeline", outs[0]["metrics"], ref,
                "sequential")
    log(f"phase 46: {wall:.1f}s with the processes' start")
    torch.cuda.empty_cache()


def _state_bytes(state) -> int:
    """Bytes of the CUDA tensors a TrainState holds: its parameters,
    optimizer state and EMA."""
    import torch

    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size() if t.is_cuda else 0
        if isinstance(t, dict):
            return sum(walk(x) for x in t.values())
        if isinstance(t, (list, tuple)):
            return sum(walk(x) for x in t)
        return 0
    return walk([state.params, state.opt_state, state.ema_params])


# ------------ phases 47-48: tensor parallelism (multi-GPU, the rest, 7c)
TP_BATCH, TP_STEPS = 8, 2            # phases 47-48: each rank the batch
TP_SEQ_RANKS = 4                     # phase 48: model 2 x seq 2
# relative, against the plain steps: float32 holds the split's arithmetic
# (the first loss, its grad_norm); bf16 its own floor. A row-parallel
# product sums its halves in another order than the unsplit GEMM, which
# flips the bf16 rounding of ~0.1% of its outputs, and a bf16 network
# carries such flips everywhere: on an H100, fc2's split alone moved
# ViT-B/16's first loss by 1.20e-04, all four splits by 2.32e-04
# (float32 partials), and no split of qkv, fc1 or the heads moved it
TP_LOSS_TOL, TP_NORM_TOL = 1e-5, 1e-4
TP_BF16_TOL = 1e-3
TP_DTYPES = (("float32", "float32"), ("bf16", "bfloat16"))


def _tp_cli_cfg(workdir):
    """The train CLI's Config for phase 47: phase 6's set-up at batch 8,
    one epoch of 2 steps, a model axis of 2 (replicated, as JAX's CLI)."""
    import dataclasses
    cfg = _smoke_cfg(workdir, TP_STEPS)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, global_batch=TP_BATCH,
                                      n_train=TP_BATCH * TP_STEPS),
        train=dataclasses.replace(cfg.train, epochs=1,
                                  mesh_model_axis=MESH_RANKS))


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _tp_steps(state, mesh, batch, seed) -> dict:
    """TP_STEPS mesh steps, K1's and the collectives' counters zeroed just
    before and read just after; the digests of the leaves the layout does
    not split."""
    import torch
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.parallel import collectives as coll
    step = _mesh_step(mesh, "replicated", "fp32")
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    coll.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TP_STEPS):
        state, m = step(state, batch, root_key(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    sh = state.sharding
    return {"metrics": metrics, "seconds": time.perf_counter() - t0,
            "launches": fa.launch_counts(),
            "collectives": coll.launch_counts(), "native": len(sh.native),
            "replicated": {k: _digest(p) for k, p in state.params.items()
                           if sh.params[k].is_fully_replicated}}


def _tp_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 47's ranks: ViT-B/16 at 224² (flash_hb) under
    TRANSFORMER_TP_RULES on a model = 2 mesh: two steps in float32, two in
    bf16, then on the bf16 state the eval step and a checkpoint; then the
    train CLI with train.mesh_model_axis=2."""
    import torch
    from deeplearning_tpu_torch.core import checkpoint
    from deeplearning_tpu_torch.ops import flash_attention as fa
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, local_slice)
    from deeplearning_tpu_torch.train import make_eval_step
    from deeplearning_tpu_torch.train.classification import make_metric_fn
    from deeplearning_tpu_torch.train.steps import shard_state
    dev = torch.device("cuda")
    _par_group(rank, workdir)
    mesh = build_mesh(MeshConfig(data=1, model=MESH_RANKS), device=dev)
    batch = {k: v[:TP_BATCH].clone()
             for k, v in _train_batch(seed, dev).items()}
    out = {"rank": rank}
    for tag, dtype in TP_DTYPES:
        state = _train_state("flash_hb", seed, dev,
                             dtype=getattr(torch, dtype))
        out["replicated_bytes"] = _state_bytes(state)
        out["shapes"] = {k: list(p.shape) for k, p in state.params.items()}
        state = shard_state(state, mesh, TRANSFORMER_TP_RULES)
        torch.cuda.empty_cache()
        out[tag] = _tp_steps(state, mesh, batch, seed)
        if tag != "bf16":
            del state
            torch.cuda.empty_cache()
    out["state_bytes"] = _state_bytes(state)
    out["allocated"] = torch.cuda.memory_allocated()
    sh = state.sharding
    out["eval"] = {k: float(v) for k, v in make_eval_step(
        make_metric_fn(), mesh=mesh)(state, batch).items()}
    ckpt = checkpoint.CheckpointManager(os.path.join(workdir, "ckpt"))
    ckpt.save(TP_STEPS, state)
    ckpt.wait_until_finished()
    tree = torch.load(os.path.join(ckpt._step_dir(TP_STEPS),
                                   checkpoint._STATE_FILE),
                      map_location="cpu", weights_only=True)
    out["ckpt_shapes"] = {k: list(v.shape)
                          for k, v in tree["params"].items()}
    out["ckpt_slices_equal"] = all(
        torch.equal(local_slice(tree["params"][k].to(dev), sh.params[k]),
                    p.detach()) for k, p in state.params.items())
    out["qkv_slice"] = list(state.params["blocks.0.attn.qkv.weight"].shape)
    del state, tree
    torch.cuda.empty_cache()
    # the train CLI over the running group: a model axis, no rules
    trainer = _cli().build(_tp_cli_cfg(os.path.join(workdir, "cli")))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    out["cli_eval"] = trainer.evaluate()
    torch.cuda.synchronize()
    out.update(cli_seconds=time.perf_counter() - t0,
               cli_launches=fa.launch_counts(),
               cli_steps=trainer.state.step,
               cli_eval_batches=len(trainer.eval_loader),
               cli_native=len(trainer.state.sharding.native),
               cli_mesh=dict(trainer.state.sharding.mesh.shape))
    del trainer
    return _par_done(rank, workdir, out)


def _hold_tp(what, got, ref, loss_tol, norm_tol) -> None:
    """The first step's loss within ``loss_tol`` and its grad_norm within
    ``norm_tol``, relative, of the plain step's; the second loss within
    the larger of ``loss_tol`` and PAR_LOSS_TOL (AdamW's first update is
    about lr x sign(g))."""
    rels = [abs(g["loss"] - r["loss"]) / abs(r["loss"])
            for g, r in zip(got, ref)]
    dn = abs(got[0]["grad_norm"] - ref[0]["grad_norm"]) / ref[0]["grad_norm"]
    later = max(loss_tol, PAR_LOSS_TOL)
    log(f"{what}: losses {[g['loss'] for g in got]} vs "
        f"{[r['loss'] for r in ref]} without a mesh (rel "
        f"{[f'{x:.2e}' for x in rels]}, tol {loss_tol} then {later}), "
        f"first grad_norm {got[0]['grad_norm']!r} vs "
        f"{ref[0]['grad_norm']!r} (rel {dn:.2e}, tol {norm_tol})")
    check(len(got) == len(ref) and rels[0] <= loss_tol
          and max(rels) <= later and dn <= norm_tol,
          f"{what}: the losses and the first grad_norm within tolerance of "
          "the plain steps")


def _tp_refs(seed, dev, batch, **model_kw) -> dict:
    """The plain steps in each of TP_DTYPES on ``batch``."""
    import torch
    return {tag: _plain_steps(seed, dev, batch, TP_STEPS,
                              dtype=getattr(torch, dtype), **model_kw)
            for tag, dtype in TP_DTYPES}


def _hold_tp_runs(what, outs, refs) -> None:
    """Both dtypes' runs: one set of metrics on every rank, the leaves the
    layout does not split bit-equal on every rank, float32 at
    TP_LOSS_TOL / TP_NORM_TOL and bf16 at TP_BF16_TOL of the plain steps."""
    for tag, _ in TP_DTYPES:
        runs = [o[tag] for o in outs]
        check(all(r["metrics"] == runs[0]["metrics"] for r in runs),
              f"{what} {tag}: every rank reports the same metrics")
        check(all(r["replicated"] == runs[0]["replicated"] for r in runs)
              and len(runs[0]["replicated"]) > 0,
              f"{what} {tag}: the {len(runs[0]['replicated'])} leaves the "
              "layout does not split bit-equal on every rank")
        tols = ((TP_LOSS_TOL, TP_NORM_TOL) if tag == "float32"
                else (TP_BF16_TOL, TP_BF16_TOL))
        _hold_tp(f"{what} {tag}", runs[0]["metrics"], refs[tag], *tols)


# K1 at the shapes only tensor parallelism gives it (ViT-B/16's 12 heads
# cut over model): (what, B, H, N, heads-per-CTA instantiations)
TP_K1_CASES = (("model 2", TP_BATCH, 6, TOKENS),
               ("model 4", TP_BATCH, 3, TOKENS),
               ("model 2 x seq 2 ring chunk", TP_BATCH, 6, 113))


def _check_tp_k1(fa, dev, g) -> None:
    """K1's forward and both backward kernels against their plain versions
    at TP_K1_CASES, each heads-per-CTA the adapters pick there (flash: 1,
    flash_hb: _head_block(H, 4)), bf16 and float32, q/k/v strided slices
    of one fused qkv; at the ring's chunk also its chunk gradients (global
    LSE and delta, float32 out). Forward 2e-2 / 1e-4 and LSE 1e-3, the
    gradients at _grad_err's tolerances, as phases 2 and 5."""
    import torch
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        tag = str(dtype)[6:]
        for what, b, h, n in TP_K1_CASES:
            hpcs = sorted({1, fa._head_block(h, 4)})
            q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, b, h, n, HEAD_DIM,
                                              dtype, False)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
            for hpc in hpcs:
                out, got_lse = fa._attention(q, k, v, sm_scale=None,
                                             causal=False, heads_per_cta=hpc)
                got = fa._attention_bwd(q, k, v, o, lse, do, sm_scale=None,
                                        causal=False, heads_per_cta=hpc)
                torch.cuda.synchronize()
                err = (out.float() - o.float()).abs().max().item()
                lse_err = (got_lse - lse).abs().max().item()
                res = [_grad_err(x, w, tag) for x, w in zip(got, want)]
                log(f"kernel-vs-plain {what} hpc={hpc} {tag} B={b} H={h} "
                    f"N={n} D={HEAD_DIM}: fwd max_abs_err {err:.3e} (tol "
                    f"{tol}) lse {lse_err:.3e}; bwd dq {res[0][0]:.3e} dk "
                    f"{res[1][0]:.3e} dv {res[2][0]:.3e}")
                check(err <= tol and lse_err <= 1e-3
                      and all(ok for _, ok in res) and all(
                          torch.isfinite(x).all().item() for x in got),
                      f"K1 hpc={hpc} disagrees with the plain version at "
                      f"{what} ({h} heads, {n} tokens)")
            if n != TOKENS:
                delta = (do.float() * o.float()).sum(-1)
                got = fa.flash_chunk_grads(q, k, v, do, lse, delta)
                want = fa.flash_attention_bwd_reference(
                    q, k, v, None, lse, do, delta=delta,
                    out_dtype=torch.float32)
                torch.cuda.synchronize()
                res = [_grad_err(x, w, tag) for x, w in zip(got, want)]
                log(f"kernel-vs-plain flash_chunk_grads {what} {tag} B={b} "
                    f"H={h} N={n}: max_abs_err "
                    f"{max(e for e, _ in res):.3e}")
                check(all(x.dtype == torch.float32 for x in got)
                      and all(ok for _, ok in res),
                      f"flash_chunk_grads disagrees at {what}")
            del q, k, v, o, lse, do, want, got
    torch.cuda.empty_cache()


def _tp_two_ranks(seed, dev, workdir) -> None:
    """Phase 47: K1 at the tensor-parallel head counts against its plain
    version, the plain steps on the same weights and batch here, then two
    processes on cuda:0 over gloo."""
    import torch
    from deeplearning_tpu_torch.ops import flash_attention as fa
    _check_tp_k1(fa, dev, torch.Generator(device=dev).manual_seed(seed))
    batch = {k: v[:TP_BATCH] for k, v in _train_batch(seed, dev).items()}
    refs = _tp_refs(seed, dev, batch)
    del batch
    outs, wall = _par_spawn(47, seed, workdir)
    # each block: two forward all-reduces (proj, fc2) and two backward
    # (the inputs of qkv and fc1); then the packed gradients, the metrics
    # and the norm's sum over model
    reduces = 4 * DEPTH + 3
    names = ("flash_attn_fwd_hb", "flash_attn_bwd_dq_hb",
             "flash_attn_bwd_dkv_hb")
    for o in outs:
        for tag, _ in TP_DTYPES:
            r = o[tag]
            log(f"rank {o['rank']} of {MESH_RANKS} on cuda:0 (gloo), model "
                f"= {MESH_RANKS}, ViT-B/16 224² batch {TP_BATCH} {tag} "
                f"flash_hb on {HEADS // MESH_RANKS} heads: losses "
                f"{[x['loss'] for x in r['metrics']]}, grad_norm "
                f"{r['metrics'][0]['grad_norm']!r}, {TP_STEPS} steps in "
                f"{r['seconds']:.2f}s (gloo through the host: layout and "
                f"parity, not speed), launches {json.dumps(r['launches'])}, "
                f"collectives {json.dumps(r['collectives'])}, "
                f"{r['native']} leaves on slices")
            for nm in names:
                check(r["launches"][nm] == DEPTH * TP_STEPS,
                      f"rank {o['rank']} {tag}: {nm} == {DEPTH} x "
                      f"{TP_STEPS}")
            check(r["collectives"]["all_reduce"] == reduces * TP_STEPS
                  and r["collectives"]["reduce_scatter"] == 0,
                  f"rank {o['rank']} {tag}: {reduces} all-reduces a step")
            check(r["native"] == 8 * DEPTH and all(
                np.isfinite(v) for m_ in r["metrics"] for v in m_.values()),
                "the blocks on their slices, finite metrics")
        log(f"rank {o['rank']}: bf16 state {o['state_bytes']} bytes against "
            f"{o['replicated_bytes']} replicated "
            f"({o['state_bytes'] / o['replicated_bytes']:.4f}), "
            f"memory_allocated {o['allocated']} bytes, eval "
            f"{json.dumps(o['eval'])}, qkv slice {o['qkv_slice']}")
        check(o["qkv_slice"] == [3 * 768 // MESH_RANKS, 768]
              and o["state_bytes"] < 0.55 * o["replicated_bytes"],
              f"rank {o['rank']}: qkv's heads split, the state about half "
              "the replicated one")
        check(0 <= o["eval"]["top1"] <= TP_BATCH
              and np.isfinite(o["eval"]["loss_sum"]), "a finite eval")
        check(o["ckpt_shapes"] == o["shapes"] and o["ckpt_slices_equal"],
              f"rank {o['rank']}: the checkpoint holds the whole ViT in the "
              "plain state's layout, and cuts back to the rank's slices")
        cli_want = {nm: DEPTH * (o["cli_steps"] + 2 * o["cli_eval_batches"])
                    if "fwd" in nm else DEPTH * o["cli_steps"]
                    for nm in names}
        log(f"rank {o['rank']}: train CLI train.mesh_model_axis="
            f"{MESH_RANKS}: mesh {json.dumps(o['cli_mesh'])}, "
            f"{o['cli_steps']} steps + eval in {o['cli_seconds']:.2f}s, eval "
            f"{json.dumps(o['cli_eval'])}, launches "
            f"{json.dumps(o['cli_launches'])}")
        check(o["cli_steps"] == TP_STEPS and o["cli_native"] == 0
              and o["cli_mesh"]["model"] == MESH_RANKS
              and all(o["cli_launches"][k] == v for k, v in cli_want.items()),
              f"rank {o['rank']}: the CLI's model axis replicates, K1 "
              f"launches == {cli_want}")
    check(outs[0]["cli_eval"] == outs[1]["cli_eval"],
          "both model ranks report the same CLI eval")
    _hold_tp_runs("phase 47 tensor parallel", outs, refs)
    log(f"phase 47: {wall:.1f}s with the processes' start")
    torch.cuda.empty_cache()


def _tp_seq_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 48's ranks: ViT-B/16 at 240² under the TP rules on a
    model 2 x seq 2 mesh, the ring on K1 over its 6 heads' 113-token
    chunks: two steps in float32, two in bf16."""
    import torch
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attn_fn)
    from deeplearning_tpu_torch.parallel.sharding import TRANSFORMER_TP_RULES
    from deeplearning_tpu_torch.train.steps import shard_state
    dev = torch.device("cuda")
    _par_group(rank, workdir, TP_SEQ_RANKS)
    mesh = build_mesh(MeshConfig(data=1, seq=2, model=2), device=dev)
    batch = {k: v[:TP_BATCH] for k, v in _sp_batch(seed, dev).items()}
    out = {"rank": rank, "coords": dict(mesh.coords)}
    for tag, dtype in TP_DTYPES:
        state = shard_state(_train_state(
            "flash", seed, dev, img_size=SP_SIZE, dtype=getattr(torch, dtype),
            attn_fn=make_ring_attn_fn(mesh, use_flash=True)),
            mesh, TRANSFORMER_TP_RULES)
        out[tag] = _tp_steps(state, mesh, batch, seed)
        del state
        torch.cuda.empty_cache()
    return _par_done(rank, workdir, out)


def _tp_seq_four_ranks(seed, dev, workdir, started=None) -> None:
    """Phase 48: the plain steps at 240² here, then four processes
    (``started`` beside phase 47)."""
    import torch
    batch = {k: v[:TP_BATCH] for k, v in _sp_batch(seed, dev).items()}
    refs = _tp_refs(seed, dev, batch, img_size=SP_SIZE)
    del batch
    outs, wall = _par_spawn(48, seed, workdir, TP_SEQ_RANKS,
                            started=started)
    for o in outs:
        for tag, _ in TP_DTYPES:
            r = o[tag]
            log(f"rank {o['rank']} of {TP_SEQ_RANKS} on cuda:0 (gloo), "
                f"{json.dumps(o['coords'])}, {tag} ring on K1 over 6 heads "
                f"x 113 tokens, ViT-B/16 {SP_SIZE}² batch {TP_BATCH}: losses "
                f"{[x['loss'] for x in r['metrics']]}, grad_norm "
                f"{r['metrics'][0]['grad_norm']!r}, {TP_STEPS} steps in "
                f"{r['seconds']:.2f}s (gloo: layout and parity, not speed), "
                f"launches {json.dumps(r['launches'])}, collectives "
                f"{json.dumps(r['collectives'])}")
            for nm in ("flash_attn_fwd", "flash_attn_bwd_dq",
                       "flash_attn_bwd_dkv"):
                check(r["launches"][nm] == 2 * DEPTH * TP_STEPS,
                      f"rank {o['rank']} {tag}: {nm} == 2 x {DEPTH} x "
                      f"{TP_STEPS}")
            check(r["native"] == 8 * DEPTH and all(
                np.isfinite(v) for m_ in r["metrics"] for v in m_.values()),
                "the blocks on their slices, finite metrics")
    _hold_tp_runs("phase 48 model x seq (ring)", outs, refs)
    log(f"phase 48: {wall:.1f}s with the processes' start")
    torch.cuda.empty_cache()


# ------- phases 49-51: the rest of classification (item 8a): the mixture
# of experts with expert parallelism, and the CNN zoo
SWIN_MOE = "swin_moe_tiny_patch4_window7_224"
MOE_CFG = "configs/swin_moe_tiny.yaml"
MOE_LAYERS = 6                   # depths 2/2/6/2: every second block
MOE_STEPS, MOE_HAND_STEPS = 4, 6
MOE_BUCKETS, MOE_REQUESTS = (1, 32), 40
EP_BATCH, EP_STEPS = 8, 2        # phase 50: each rank the whole batch
# the mesh step folds the data index into its key, so its masks are not the
# plain step's: phase 50 turns Swin's drop path off on both sides
EP_MODEL = {"name": SWIN_MOE, "drop_path_rate": 0.0}
# relative, against the unsplit steps: the forward is the unsplit one
# expert for expert, and at top-1 a token's expert gradient comes from one
# rank (the other adds 0), so on an H100 both dtypes' first losses were
# bit-equal and only the norm's summation order moved grad_norm (6.2e-08,
# float32); held at 1e-6, a few times that floor (PERF.md §6)
EP_TOL = 1e-6
ZOO_CNN = ("vgg11", "vgg13", "vgg16", "vgg19", "googlenet",
           "shufflenet_v2_x1_0", "mobilenet_v2",
           *(f"efficientnet_b{i}" for i in range(8)),
           "convnext_tiny", "convnext_small", "convnext_base", "coatnet_0",
           "repvgg_a0", "repvgg_a1", "repvgg_a2", "repvgg_b0", "repvgg_b1",
           "transfg_small")
ZOO_BATCH = 8
# RepVGG's fold against its train form's eval forward: max |d| over the
# largest logit; float32 holds the fold, bf16 its rounding through 22-28
# blocks of three convs against one. On an H100 the five factories
# measured 1.37e-06-1.75e-06 and 4.6e-03-6.0e-03 (PERF.md §6): held a
# few times above
REPVGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _moe_cli_cfg(workdir=None, *overrides):
    """configs/swin_moe_tiny.yaml through the train CLI's config reader
    (Swin-MoE-T, 224², batch 128, bf16, AdamW, EMA, model.attn flash_hb:
    the fused K2), one epoch of MOE_STEPS steps of its synthetic data."""
    from deeplearning_tpu_torch.core.config import config_cli
    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["--cfg", os.path.join(here, MOE_CFG),
            f"data.n_train={TRAIN_BATCH * MOE_STEPS}", "train.epochs=1",
            *overrides]
    if workdir:
        argv.append(f"train.workdir={workdir}")
    return config_cli(_cli().Config(), argv)


def _moe_layer_ms(state, batch) -> dict:
    """The MoE layers' device time in one train step of ``state``: each
    layer's input captured in a forward, then the layer alone on it,
    forward and forward + backward (CUDA events, eager as the step runs
    it, inside ``collect_moe()`` as the loss runs it), summed over the
    layers."""
    import torch
    from deeplearning_tpu_torch.parallel.moe import MoEMlp, collect_moe
    layers = [m for m in state.model.modules() if isinstance(m, MoEMlp)]
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, i=i: seen.setdefault(i, args[0].detach()))
        for i, m in enumerate(layers)]
    with torch.no_grad(), collect_moe():
        state.model.train()
        state.model(batch["image"], rng=torch.Generator(
            device=batch["image"].device).manual_seed(0))
    for h in hooks:
        h.remove()
    fwd = bwd = 0.0
    for i, layer in enumerate(layers):
        x = seen[i].clone().requires_grad_()

        def forward():
            with collect_moe():
                return layer(x)

        def both():
            out, aux = forward()
            (out.float().square().mean() + aux).backward()
        fwd += _time_ms(lambda: forward(), iters=10, warmup=3)
        bwd += _time_ms(both, iters=10, warmup=3)
    layer_params = [p for m in layers for p in m.parameters()]
    for p in layer_params + [t for t in seen.values()]:
        p.grad = None
    return {"layers": len(layers), "tokens": [int(seen[i].shape[0]
                                                 * seen[i].shape[1])
                                             for i in range(len(layers))],
            "forward": fwd, "forward_backward": bwd}


def _device_ms(fn, iters=2) -> float:
    """The profiler's device ms a call of ``fn`` (its kernels and
    copies), after one call outside the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning_tpu_torch.serve.profile import _device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total > 0, "the profiler recorded device time")
    return total / 1e3 / iters


def _swin_moe(wa, dev, seed, workdir) -> int:
    """Phase 49: Swin-MoE-T from configs/swin_moe_tiny.yaml through the
    train CLI's Trainer under strict=transfers, a hand loop whose loss
    falls, the step and its MoE layers timed, then the CLI's checkpoint
    served through ``hub.serve`` and the batcher. Returns K2's launches
    (the Trainer's and the served batches', each counted from zero just
    before its run)."""
    import shutil
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.obs import flight
    from deeplearning_tpu_torch.serve import MicroBatcher
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = _moe_cli_cfg(workdir, "train.strict=transfers")
    check(cfg.model.name == SWIN_MOE and cfg.train.ema
          and cfg.model.precision == "bf16" and cfg.optim.name == "adamw"
          and cfg.data.global_batch == TRAIN_BATCH,
          f"{MOE_CFG}: Swin-MoE-T, bf16, AdamW, EMA, batch {TRAIN_BATCH}")
    trainer = cli.build(cfg, eval_every_epochs=1)
    moes = [m for m in trainer.state.model.modules()
            if type(m).__name__ == "MoEMlp"]
    n_params = sum(p.numel() for p in trainer.state.params.values())
    n_expert = sum(p.numel() for k, p in trainer.state.params.items()
                   if ".experts." in k)
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
    trained = wa.launch_counts()[wa.KERNEL_NAME]
    evals = len(trainer.eval_loader)
    logged = [e["metrics"] for e in flight.get_recorder().events("step")]
    keys = ("loss", "moe/drop_rate", "moe/capacity_util",
            "moe/max_expert_load")
    log(f"Swin-MoE-T ({MOE_CFG}, {len(moes)} MoE layers of 8 experts, "
        f"{n_params / 1e6:.2f} M parameters, {n_expert / 1e6:.2f} M in the "
        f"experts) through the train CLI's Trainer, strict=transfers: "
        f"{MOE_STEPS} steps + {evals} eval batches in {wall:.2f}s, "
        f"{trainer.strict_sections} strict sections, {guard.armed_steps} "
        f"steps under the epoch guard, K2 launches {trained} (want "
        f"{SWIN_BLOCKS} x {MOE_STEPS + evals}), eval "
        f"{json.dumps(trainer._last_eval)}, peak device memory "
        f"{_gib(torch.cuda.max_memory_allocated()):.3f} GiB; logged "
        f"{json.dumps([{k: m[k] for k in keys} for m in logged])}")
    check(len(moes) == MOE_LAYERS, f"{MOE_LAYERS} MoE layers")
    check(trained == SWIN_BLOCKS * (MOE_STEPS + evals),
          f"K2 launches == {SWIN_BLOCKS} x (steps + eval batches)")
    check(trainer.strict_sections == MOE_STEPS
          and guard.armed_steps == MOE_STEPS,
          "every step ran in a strict section: no routing op syncs")
    check(len(logged) == MOE_STEPS and all(
        np.isfinite(m["loss"]) and 0.0 <= m["moe/drop_rate"] <= 1.0
        and 0.0 < m["moe/capacity_util"] <= 1.0
        and m["moe/max_expert_load"] >= 1.0 for m in logged),
        "finite losses, moe/drop_rate in [0, 1], moe/capacity_util in "
        "(0, 1], moe/max_expert_load >= 1 on every logged step")
    step_dir = os.path.join(workdir, "ckpt", str(trainer.ckpt.latest_step()))
    check(os.path.isdir(step_dir), "the CLI wrote its checkpoint")
    del trainer
    torch.cuda.empty_cache()

    # the loss with its aux terms falls: a fixed batch at constant lr 1e-4
    state = _train_state("flash_hb", seed, dev, lr=1e-4, name=SWIN_MOE)
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    batch, key = _train_batch(seed, dev), root_key(seed)
    torch.cuda.synchronize()
    wa.reset_launch_counts()
    hand = []
    for _ in range(MOE_HAND_STEPS):
        state, m = step(state, batch, key)
        hand.append(_metrics(m))
    torch.cuda.synchronize()
    hand_launches = wa.launch_counts()[wa.KERNEL_NAME]
    log(f"Swin-MoE-T hand loop, constant lr 1e-4 on a fixed batch of "
        f"{TRAIN_BATCH}: losses {[round(h['loss'], 5) for h in hand]}, "
        f"moe/* {json.dumps({k: hand[0][k] for k in keys[1:]})}, K2 "
        f"launches {hand_launches}")
    check(hand[-1]["loss"] < hand[0]["loss"], "the loss falls")
    check(hand_launches == SWIN_BLOCKS * MOE_HAND_STEPS,
          f"K2 launches == {SWIN_BLOCKS} a step")

    def one():
        nonlocal state
        state, _ = step(state, batch, key)

    step_ms = _time_ms(one, iters=3, warmup=1)
    busy_ms = _device_ms(one)
    moe_ms = _moe_layer_ms(state, batch)
    log(f"Swin-MoE-T train step, batch {TRAIN_BATCH} bf16 (AdamW, no EMA): "
        f"{step_ms:.2f} ms (CUDA events, 3 steps), device busy "
        f"{busy_ms:.2f} ms (profiler), {TRAIN_BATCH / step_ms * 1e3:.1f} "
        f"img/s; its {moe_ms['layers']} MoE layers alone on their inputs "
        f"(tokens {moe_ms['tokens']}): forward {moe_ms['forward']:.2f} ms "
        f"({moe_ms['forward'] / step_ms * 100:.1f}% of the step), forward "
        f"+ backward {moe_ms['forward_backward']:.2f} ms "
        f"({moe_ms['forward_backward'] / step_ms * 100:.1f}%)")
    del state, step
    torch.cuda.empty_cache()

    # the CLI's checkpoint served: hub.serve and the batcher
    served = hub.serve(SWIN_MOE, ckpt=step_dir, num_classes=1000,
                       image_size=224, batch_buckets=MOE_BUCKETS,
                       attn="flash_hb", device=dev)
    images = np.random.default_rng(seed + 49).normal(
        size=(MOE_REQUESTS, 224, 224, 3)).astype(np.float32)
    with MicroBatcher(served, max_wait_ms=5.0) as mb, \
            _recorded_runs(served) as runs:
        torch.cuda.synchronize()
        wa.reset_launch_counts()

        def client(part):
            handles = [mb.submit(img) for img in part]
            return [h.result(timeout=120.0) for h in handles]

        with ThreadPoolExecutor(8) as pool:
            rows = [r for part in pool.map(client,
                                           np.array_split(images, 8))
                    for r in part]
        torch.cuda.synchronize()
        serve_launches = wa.launch_counts()[wa.KERNEL_NAME]
        batches = mb.dispatched
    log(f"Swin-MoE-T served from the CLI's checkpoint: {len(rows)}/"
        f"{MOE_REQUESTS} answers in {batches} batches, K2 launches "
        f"{serve_launches} (want {SWIN_BLOCKS} x {batches}); "
        f"{json.dumps(served.stats())}")
    check(len(rows) == MOE_REQUESTS and all(
        r.shape == (1000,) and np.isfinite(r).all() for r in rows),
        "every answer arrives, finite (1000,) probabilities")
    check(serve_launches == SWIN_BLOCKS * batches,
          f"K2 launches == {SWIN_BLOCKS} x batches dispatched")
    _hold_served_rows("Swin-MoE-T", served, images, rows, runs, batches)
    walls = {}
    for b in MOE_BUCKETS:
        x = images[:b]
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            served.run(b, x).cpu()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        walls[b] = statistics.median(times)
    log(f"Swin-MoE-T served walls (engine.run + copy back, median of 10): "
        f"{json.dumps({f'bucket_{b}_ms': round(v, 3) for b, v in walls.items()})}")
    del served
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return trained + serve_launches


def _expert_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for k, p in params.items()
               if ".experts." in k)


def _ep_rank(rank: int, workdir: str, seed: int) -> int:
    """One of phase 50's ranks: Swin-MoE-T at 224² (the fused K2) under
    MOE_RULES on an expert = 2 mesh, 4 experts a rank: two steps in
    float32, two in bf16, then the eval step."""
    import torch
    from deeplearning_tpu_torch.ops import window_attention as wa
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.moe import MOE_RULES
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.train import make_eval_step, make_train_step
    from deeplearning_tpu_torch.train.classification import (make_loss_fn,
                                                             make_metric_fn)
    from deeplearning_tpu_torch.train.steps import shard_state
    dev = torch.device("cuda")
    _par_group(rank, workdir)
    mesh = build_mesh(MeshConfig(data=1, expert=MESH_RANKS), device=dev)
    batch = {k: v[:EP_BATCH].clone()
             for k, v in _train_batch(seed, dev).items()}
    out = {"rank": rank, "coords": dict(mesh.coords)}
    for tag, dtype in TP_DTYPES:
        state = _train_state("flash_hb", seed, dev, **EP_MODEL,
                             dtype=getattr(torch, dtype))
        out["expert_bytes_unsplit"] = _expert_bytes(state.params)
        state = shard_state(state, mesh, MOE_RULES)
        out["expert_bytes"] = _expert_bytes(state.params)
        step = make_train_step(make_loss_fn(label_smoothing=0.1), mesh=mesh,
                               rules=MOE_RULES)
        torch.cuda.synchronize()
        wa.reset_launch_counts()
        coll.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = []
        for _ in range(EP_STEPS):
            state, m = step(state, batch, root_key(seed))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        sh = state.sharding
        out[tag] = {"metrics": metrics, "seconds": time.perf_counter() - t0,
                    "launches": wa.launch_counts()[wa.KERNEL_NAME],
                    "collectives": coll.launch_counts(),
                    "native": len(sh.native),
                    "replicated": {k: _digest(p)
                                   for k, p in state.params.items()
                                   if sh.params[k].is_fully_replicated}}
        if tag == "bf16":
            out["eval"] = {k: float(v) for k, v in make_eval_step(
                make_metric_fn(), mesh=mesh)(state, batch).items()}
        del state, step
        torch.cuda.empty_cache()
    return _par_done(rank, workdir, out)


def _ep_two_ranks(seed, dev, workdir) -> None:
    """Phase 50: the unsplit steps on the same weights and batch here,
    then two processes on cuda:0 over gloo at expert = 2."""
    import torch
    batch = {k: v[:EP_BATCH] for k, v in _train_batch(seed, dev).items()}
    refs = {tag: _plain_steps(seed, dev, batch, EP_STEPS, **EP_MODEL,
                              dtype=getattr(torch, dtype))
            for tag, dtype in TP_DTYPES}
    del batch
    outs, wall = _par_spawn(50, seed, workdir)
    for o in outs:
        for tag, _ in TP_DTYPES:
            r = o[tag]
            first = r["metrics"][0]
            rel_loss = abs(first["loss"] - refs[tag][0]["loss"]) \
                / abs(refs[tag][0]["loss"])
            rel_norm = abs(first["grad_norm"] - refs[tag][0]["grad_norm"]) \
                / refs[tag][0]["grad_norm"]
            log(f"rank {o['rank']} of {MESH_RANKS} on cuda:0 (gloo), expert "
                f"= {MESH_RANKS}, Swin-MoE-T 224² batch {EP_BATCH} {tag}: "
                f"first loss rel err {rel_loss:.3e}, grad_norm rel err "
                f"{rel_norm:.3e}; losses {[x['loss'] for x in r['metrics']]}"
                f", moe/* {json.dumps({k: v for k, v in first.items() if k.startswith('moe/')})}"
                f"; {EP_STEPS} steps in {r['seconds']:.2f}s (gloo through "
                f"the host: layout and parity, not speed), K2 launches "
                f"{r['launches']}, collectives {json.dumps(r['collectives'])}"
                f", {r['native']} expert leaves on slices")
            check(r["launches"] == SWIN_BLOCKS * EP_STEPS,
                  f"rank {o['rank']} {tag}: K2 == {SWIN_BLOCKS} x {EP_STEPS}")
            check(r["native"] == 4 * MOE_LAYERS and all(
                np.isfinite(v) for m_ in r["metrics"] for v in m_.values()),
                "the experts on their slices, finite metrics")
        ratio = o["expert_bytes"] / o["expert_bytes_unsplit"]
        log(f"rank {o['rank']}: expert bytes {o['expert_bytes']} against "
            f"{o['expert_bytes_unsplit']} unsplit ({ratio:.4f}); eval "
            f"{json.dumps(o['eval'])}")
        check(ratio == 0.5, "a rank holds half the experts' bytes")
        check(0 <= o["eval"]["top1"] <= EP_BATCH
              and np.isfinite(o["eval"]["loss_sum"]), "a finite eval")
    check(outs[0]["eval"] == outs[1]["eval"],
          "both expert ranks report the same eval")
    for tag, _ in TP_DTYPES:
        runs = [o[tag] for o in outs]
        check(all(r["metrics"] == runs[0]["metrics"] for r in runs),
              f"phase 50 {tag}: every rank reports the same metrics")
        check(all(r["replicated"] == runs[0]["replicated"] for r in runs),
              f"phase 50 {tag}: the leaves the layout does not split "
              "bit-equal on every rank")
        _hold_tp(f"phase 50 expert parallel {tag}", runs[0]["metrics"],
                 refs[tag], EP_TOL, EP_TOL)
    log(f"phase 50: {wall:.1f}s with the processes' start")
    torch.cuda.empty_cache()


def _cnn_zoo(dev, seed, workdir) -> None:
    """Phase 51: mnist_cnn trained from configs/mnist_smoke.yaml through
    the train CLI and served through the serve CLI's stdin mode; every
    other new factory built at full width on the card, one bf16 eval
    forward at 224² (RepVGG also reparameterized), one train step."""
    import io
    import shutil
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.models.classification.repvgg import (
        reparameterize)
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    from deeplearning_tpu_torch.train import TrainState, make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.core.config import config_cli
    cli = _cli()
    shutil.rmtree(workdir, ignore_errors=True)
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config_cli(cli.Config(), [
        "--cfg", os.path.join(here, "configs/mnist_smoke.yaml"),
        "train.epochs=1", f"train.workdir={os.path.join(workdir, 'mnist')}"])
    check(cfg.model.name == "mnist_cnn" and cfg.train.device == "cuda",
          "mnist_smoke.yaml: the CLI's default model, on the card")
    t0 = time.perf_counter()
    trainer = cli.build(cfg)
    trainer.train()
    ev = trainer.evaluate()
    steps = trainer.state.step
    log(f"mnist_cnn ({cfg.data.channels} channel, {cfg.data.image_size}², "
        f"batch {cfg.data.global_batch}) through the train CLI: {steps} "
        f"steps + eval in {time.perf_counter() - t0:.2f}s, eval "
        f"{json.dumps(ev)}")
    check(steps == cfg.data.n_train // cfg.data.global_batch
          and np.isfinite(ev["loss_sum"]) and ev["top1"] >= 0,
          "mnist_cnn trains through the CLI, a finite eval")
    del trainer
    npy = os.path.join(workdir, "digits.npy")
    np.save(npy, np.random.default_rng(seed + 51).normal(
        size=(2, 28, 28, 3)).astype(np.float32))
    printed = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(f"{npy}\n")
    try:
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = serve_cli.main(["--model", "mnist_cnn", "--num-classes",
                                 "10", "--size", "28", "--buckets", "1,4",
                                 "--topk", "3"])
    finally:
        sys.stdin = stdin
    answers = [json.loads(line) for line in
               printed.getvalue().strip().splitlines()]
    log(f"serve CLI (stdin) --model mnist_cnn --size 28: {answers[:2]}")
    check(rc == 0 and [a.get("image") for a in answers[:2]] == [0, 1]
          and all(len(a["top"]) == 3 for a in answers[:2]),
          "the serve CLI answers mnist_cnn")
    shutil.rmtree(workdir, ignore_errors=True)

    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.normal(size=(2, 224, 224, 3)).astype(
        np.float32)).to(dev)
    batch = {"image": torch.from_numpy(g.normal(
        size=(ZOO_BATCH, 224, 224, 3)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(g.integers(0, 1000, ZOO_BATCH)).to(dev)}
    times = {}
    for name in ZOO_CNN:
        t0 = time.perf_counter()
        kw = hub.model_kwargs(name, "flash_hb", 224)

        def build(**extra):
            with torch.device(dev):
                return MODELS.build(
                    name, num_classes=1000, generator=torch.Generator(
                        device=dev).manual_seed(seed), **kw, **extra)
        model = build(dtype=torch.bfloat16).eval()
        with torch.no_grad():
            out = model(x)
        logits = out["logits"] if isinstance(out, dict) else out
        torch.cuda.synchronize()
        check(tuple(logits.shape) == (2, 1000)
              and bool(torch.isfinite(logits).all()),
              f"{name}: a finite (2, 1000) eval forward")
        note = ""
        if name.startswith("repvgg"):
            sd = reparameterize(model.state_dict())
            errs = {}
            for dtype in ("float32", "bfloat16"):
                train_form = build(dtype=getattr(torch, dtype)).eval()
                train_form.load_state_dict(model.state_dict())
                deploy = build(dtype=getattr(torch, dtype), deploy=True)
                deploy.load_state_dict(sd)
                with torch.no_grad():
                    want = train_form(x).float()
                    got = deploy.eval()(x).float()
                errs[dtype] = float((got - want).abs().max()
                                    / want.abs().max())
                del train_form, deploy
            note = f", deploy form vs train form {json.dumps(errs)}"
            check(all(errs[k] <= REPVGG_TOL[k] for k in errs),
                  f"{name}: the reparameterized forward equals the train "
                  f"form's within {REPVGG_TOL}")
        if name != "transfg_small":
            model.train()
            has_bn = any(isinstance(m, torch.nn.BatchNorm2d)
                         for m in model.modules())
            state = TrainState.create(
                model=model, tx=_adamw(model),
                batch_stats=dict(model.named_buffers()) if has_bn else None)
            step = make_train_step(make_loss_fn(has_batch_stats=has_bn),
                                   device=dev)
            _, m = step(state, batch, root_key(seed))
            m = _metrics(m)
            note += f", train step loss {m['loss']:.4f}"
            del state, step
        n = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        log(f"{name}: {n / 1e6:.2f} M parameters, eval forward at 224² "
            f"bf16 finite{note}; {times[name]:.2f}s")
        torch.cuda.empty_cache()
    log(f"phase 51 zoo: {len(times)} factories in "
        f"{sum(times.values()):.1f}s")


# phases 52-54: MAE-B/16 pretraining on K1, the task CLI, the task families
MAE_MODEL, MAE_SIZE, MAE_BATCH = "mae_vit_base_patch16", 224, 64
MAE_BLOCKS = 20                   # 12 encoder + 8 decoder blocks, K1 each
# K1's (B, H, N, D) on MAE's path: MAE-B/16's encoder (49 kept tokens of
# 196) and decoder, and the task CLI default's (mae_vit_small_patch16 at
# 32²: one kept token of 4, 6 heads; the decoder's 4 tokens, 8 heads)
MAE_SHAPES = [(64, 12, 49, 64), (64, 16, 196, 32), (2, 6, 1, 64),
              (2, 8, 4, 32)]
# the first loss through K1 against the naive attention, same weights and
# mask noise: bf16 through 20 blocks, as phase 6's 5e-3 through 12 with
# the decoder's 8 more and a loss over normalised pixels
MAE_LOSS_TOL = 2e-2
MAE_LR, MAE_WD = 1.5e-4, 0.05     # core/experiment.py's mae_pretrain
# tests/test_train_task_cli.py's sizes
TASK_CLI = [
    ("segmentation", ["model.image_size=32", "data.batch=2"]),
    ("mae", ["model.image_size=32", "data.batch=2"]),
    ("supcon", ["model.image_size=32", "data.batch=8"]),
    ("metric", ["model.image_size=32", "data.batch=8",
                "model.num_classes=4"]),
    ("keypoints", ["model.image_size=64", "data.batch=2"]),
    ("stereo", ["model.image_size=64"]),
    ("stereo_online", ["model.image_size=64", "data.batch=1",
                       "train.lr=1e-4"])]
# each new factory at its source's input size (H, W) and batch
TASK_FACTORIES = [
    ("unet", (512, 512), 4), ("fcn_resnet50", (512, 512), 4),
    ("deeplabv3_resnet50", (512, 512), 4),
    ("deeplabv3plus_resnet50", (512, 512), 4),
    ("hrnet_w18_seg", (512, 1024), 2), ("hrnet_w48_seg", (512, 1024), 2),
    ("sspnet_resnet18", (321, 321), 4), ("bdb_resnet50", (384, 128), 32),
    ("arcface_resnet18", (112, 112), 64),
    ("supcon_resnet18", (32, 32), 256), ("supcon_resnet50", (32, 32), 256),
    ("hrnet_w18_keypoints", (256, 192), 32),
    ("hrnet_w48_keypoints", (256, 192), 32),
    ("madnet", (320, 1216), 1), ("mae_vit_small_patch16", (224, 224), 64),
    ("mae_vit_base_patch16", (224, 224), 64)]


def _check_k1_at_mae_shapes(fa, dev, g) -> None:
    """K1's forward (and LSE), dQ and dK/dV at MAE's shapes against the
    plain version, bf16 and float32, one head a CTA and the flash_hb
    block (phases 2 and 5's tolerances)."""
    import torch
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        tag = str(dtype)[6:]
        for b, h, n, d in MAE_SHAPES:
            q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, b, h, n, d, dtype,
                                              False)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
            for hpc in sorted({1, fa._head_block(h, 4)}):
                out, got_lse = fa._attention(q, k, v, sm_scale=None,
                                             causal=False, heads_per_cta=hpc)
                got = fa._attention_bwd(q, k, v, o, lse, do, sm_scale=None,
                                        causal=False, heads_per_cta=hpc)
                torch.cuda.synchronize()
                err = (out.float() - o.float()).abs().max().item()
                lse_err = (got_lse - lse).abs().max().item()
                res = [_grad_err(x, w, tag) for x, w in zip(got, want)]
                log(f"kernel-vs-plain MAE hpc={hpc} {tag} B={b} H={h} N={n} "
                    f"D={d}: fwd {err:.3e} (tol {tol}) lse {lse_err:.3e}, "
                    f"dq {res[0][0]:.3e} dk {res[1][0]:.3e} dv "
                    f"{res[2][0]:.3e}")
                check(err <= tol and lse_err <= 1e-3
                      and all(ok for _, ok in res)
                      and all(torch.isfinite(x).all().item() for x in got),
                      f"K1 hpc={hpc} disagrees with the plain version at "
                      f"MAE's ({b}, {h}, {n}, {d}) {tag}")
            del q, k, v, o, lse, do, want
    torch.cuda.empty_cache()


def _time_k1_mae(fa, dev, g, b, h, n, d) -> None:
    """K1 at one of MAE-B/16's shapes, bf16, fused-qkv strides: the
    forward (both heads-per-CTA) and the dQ + dK/dV pair of the flash_hb
    block by graph replay, beside the plain version, SDPA (forward; the
    backward through autograd) and the bounds."""
    import torch
    from deeplearning_tpu_torch.ops.flash_bench import graph_ms
    q, k, v, o, lse, do = _bwd_inputs(fa, dev, g, b, h, n, d,
                                      torch.bfloat16, False)
    fwd_bytes = fa.min_bytes(b, h, n, d, 2)
    fwd_flops = fa.flops(b, h, n, d)
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S,
                    fwd_flops / PEAK_FLOPS["bfloat16"]) * 1e3
    plain_ms = _time_ms(lambda: fa.flash_attention_reference(q, k, v),
                        iters=20, warmup=3)
    sdpa_ms = graph_ms(lambda: torch.nn.functional.
                       scaled_dot_product_attention(q, k, v))
    qb, kb, vb = (x.transpose(1, 2) for x in (q, k, v))
    by = ("bytes" if fwd_bytes / HBM_BYTES_PER_S
          >= fwd_flops / PEAK_FLOPS["bfloat16"] else "operations")
    for name, hpc in (("flash_attn_fwd_hb", fa._head_block(h, 4)),
                      ("flash_attn_fwd", 1)):
        ms = graph_ms(lambda: fa.attention_bnhd(qb, kb, vb,
                                                heads_per_cta=hpc))
        log(f"timing MAE {name} hpc={hpc} B={b} H={h} N={n} D={d} bf16: "
            f"kernel {ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, "
            f"sdpa {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x), bound "
            f"{fwd_bound:.4f} ms ({by}; {fwd_bytes / 1e6:.2f} MB, "
            f"{fwd_flops / 1e9:.3f} GFLOP)")
    hpc = fa._head_block(h, 4)
    lse2 = lse.reshape(b * h, n).contiguous()
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, n).contiguous()
    grads = [fa._empty_bhnd(q, torch.bfloat16, True) for _ in range(3)]
    pair_ms = graph_ms(lambda: fa._launch_bwd(
        q, k, v, do, lse2, delta, *grads, d ** -0.5, False, hpc,
        kernels=("dq", "dkv"), o=o))
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do), iters=10, warmup=2)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters=20, warmup=3)
    bwd_bytes = fa.bwd_min_bytes(b, h, n, d, 2, kernel=None)
    bwd_flops = fa.bwd_flops(b, h, n, d, kernel=None)
    bound = max(bwd_bytes / HBM_BYTES_PER_S,
                bwd_flops / PEAK_FLOPS["bfloat16"]) * 1e3
    log(f"timing MAE backward pair dq + dkv hpc={hpc} B={b} H={h} N={n} "
        f"D={d} bf16: kernels {pair_ms:.4f} ms (graph replay), plain "
        f"{plain_bwd:.4f} ms, sdpa backward {sdpa_bwd:.4f} ms "
        f"({pair_ms / sdpa_bwd:.2f}x), bound {bound:.4f} ms "
        f"({bwd_bytes / 1e6:.2f} MB, {bwd_flops / 1e9:.3f} GFLOP)")
    del q, k, v, o, lse, do, grads, qs, ks, vs, out
    torch.cuda.empty_cache()


def _mae_pretrain(fa, dev, g, seed) -> dict:
    """Phase 52: K1 at MAE's shapes, then MAE-B/16 at 224² trained on K1
    (module docstring). Returns the K1 launches of its steps."""
    import torch
    from deeplearning_tpu_torch import models  # noqa: F401
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.core.rng import root_key, step_key
    from deeplearning_tpu_torch.ops.attention import flash_hb_adapter
    from deeplearning_tpu_torch.train.optim import (apply_updates,
                                                    build_optimizer)
    from deeplearning_tpu_torch.train.profile import profile_steps
    _check_k1_at_mae_shapes(fa, dev, g)

    def build(attn_fn):
        with torch.device(dev):
            return MODELS.build(MAE_MODEL, attn_fn=attn_fn,
                                generator=torch.Generator(
                                    device=dev).manual_seed(seed))
    t0 = time.perf_counter()
    model = build(flash_hb_adapter).train()
    n_tok = (MAE_SIZE // 16) ** 2
    r = np.random.default_rng(seed + 52)
    x = torch.from_numpy(r.normal(size=(MAE_BATCH, MAE_SIZE, MAE_SIZE, 3))
                         .astype(np.float32)).to(dev)
    noise = torch.from_numpy(r.uniform(size=(MAE_BATCH, n_tok)).astype(
        np.float32)).to(dev)
    plain = build(None).train()
    plain.load_state_dict(model.state_dict())
    fa.reset_launch_counts()
    with torch.no_grad():
        plain_loss = float(plain(x, mask_noise=noise)[0])
    torch.cuda.synchronize()
    check(not any(fa.launch_counts().values()),
          "MAE on the naive attention launches no K1 kernel")
    del plain
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{MAE_MODEL}: {n_params / 1e6:.2f} M parameters, built in "
        f"{time.perf_counter() - t0:.2f}s")
    params = dict(model.named_parameters())
    key = root_key(seed)

    def make_step(tx):
        def step(state, batch, key):
            opt, i = state
            loss, _, _ = model(batch, rng=step_key(key, i, dev),
                               mask_noise=noise if i == 0 else None)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, opt = tx.update(dict(zip(params, grads)), opt, params)
            apply_updates(params, updates)
            return (opt, i + 1), {"loss": loss.detach()}
        return step

    want = {fa.KERNEL_NAMES[4]: MAE_BLOCKS,
            fa.BWD_KERNEL_NAMES["dq"][4]: MAE_BLOCKS,
            fa.BWD_KERNEL_NAMES["dkv"][4]: MAE_BLOCKS}
    total: dict = {}
    losses = []
    i = 0
    for opt_name, steps in (("adamw", 4), ("lars", 2)):
        tx = build_optimizer(opt_name, MAE_LR, params=params,
                             weight_decay=MAE_WD)
        state = (tx.init(params), i)
        step = make_step(tx)
        for _ in range(steps):
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            state, m = step(state, x, key)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            launched = {k: v for k, v in fa.launch_counts().items() if v}
            _add(total, launched)
            losses.append(loss)
            log(f"MAE-B/16 {opt_name} step {i}: loss {loss:.5f}, K1 "
                f"{json.dumps(launched)}")
            check(np.isfinite(loss) and launched == want,
                  f"a MAE step: a finite loss and {MAE_BLOCKS} launches of "
                  f"each K1 kernel")
            i += 1
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"MAE-B/16 first loss on K1 {losses[0]:.6f} vs naive attention "
        f"{plain_loss:.6f}: relative {rel:.3e} (tol {MAE_LOSS_TOL})")
    check(rel <= MAE_LOSS_TOL, "MAE's first loss on K1 equals the plain "
          "route's")

    keep = torch.argsort(noise[:8], dim=1)[:, :n_tok // 4]
    rec = model.reconstruct(x[:8], mask_noise=noise[:8])
    patches = rec.reshape(8, 14, 16, 14, 16, 3).permute(0, 1, 3, 2, 4, 5)
    orig = x[:8].reshape(8, 14, 16, 14, 16, 3).permute(0, 1, 3, 2, 4, 5)
    rows = torch.arange(8, device=dev)[:, None]
    same = bool((patches.reshape(8, n_tok, -1)[rows, keep]
                 == orig.reshape(8, n_tok, -1)[rows, keep]).all())
    log(f"MAE-B/16 reconstruct: {tuple(rec.shape)}, finite "
        f"{bool(torch.isfinite(rec).all())}, visible patches the input's "
        f"{same}")
    check(rec.shape == x[:8].shape and bool(torch.isfinite(rec).all())
          and same, "reconstruct: finite, the visible patches kept")

    tx = build_optimizer("adamw", MAE_LR, params=params, weight_decay=MAE_WD)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    prof = profile_steps(make_step(tx), (tx.init(params), i), x, key,
                         iters=3)
    torch.cuda.synchronize()
    _add(total, {k: v for k, v in fa.launch_counts().items() if v})
    k1_ms = prof["by_kind"].get("flash attention", [0.0, 0.0])
    kinds = {k: round(v[0], 3) for k, v in prof["by_kind"].items()}
    log(f"MAE-B/16 train step, batch {MAE_BATCH} bf16 flash_hb: device "
        f"{prof['device_ms']:.2f} ms, wall {prof['wall_ms']:.2f} ms, "
        f"{MAE_BATCH / prof['wall_ms'] * 1e3:.1f} images/s, idle "
        f"{prof['idle_share']:.3f}; K1 {k1_ms[0]:.3f} ms "
        f"({k1_ms[1]:.3f} of the device time); by kind {json.dumps(kinds)}")
    del model, params, x
    torch.cuda.empty_cache()
    for b, h, n, d in MAE_SHAPES[:2]:
        _time_k1_mae(fa, dev, g, b, h, n, d)
    log(f"phase 52 K1 launches: {json.dumps(total)}")
    return total


def _task_cli(fa) -> dict:
    """Phase 53: the task CLI's ``main`` runs every task on the card;
    MAE's K1 launches counted from zero just before its run."""
    import io
    import torch
    from deeplearning_tpu_torch.train import task as ptask
    total: dict = {}
    for task, overrides in TASK_CLI:
        printed = io.StringIO()
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = ptask.main(["--task", task, "train.steps=3"] + overrides)
        torch.cuda.synchronize()
        launched = {k: v for k, v in fa.launch_counts().items() if v}
        lines = [ln for ln in printed.getvalue().splitlines()
                 if ln.startswith(("task_metric", "loss "))]
        log(f"task CLI --task {task}: rc {rc} in "
            f"{time.perf_counter() - t0:.2f}s, {lines}, K1 "
            f"{json.dumps(launched)}")
        check(rc == 0 and any(ln.startswith("task_metric") for ln in lines),
              f"the task CLI runs {task} on the card")
        if task == "mae":      # 2 encoder + 2 decoder blocks, 3 steps
            check(launched == {fa.KERNEL_NAMES[4]: 12,
                               fa.BWD_KERNEL_NAMES["dq"][4]: 12,
                               fa.BWD_KERNEL_NAMES["dkv"][4]: 12},
                  "the MAE task's attention runs on K1")
            _add(total, launched)
        else:
            check(not launched, f"{task} runs no attention")
    return total


def _task_factories(fa, dev, seed) -> dict:
    """Phase 54: every new factory built on the card in bf16 at its
    source's input size, one train-mode forward and backward (after one
    warm-up pair), finite outputs and gradients, the pair's device ms."""
    import torch
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch import models  # noqa: F401
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.core.rng import step_key
    total: dict = {}
    r = np.random.default_rng(seed + 54)

    def arr(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(
            np.float32)).to(dev)
    for name, (h, w), b in TASK_FACTORIES:
        t0 = time.perf_counter()
        with torch.device(dev):
            model = MODELS.build(name, generator=torch.Generator(
                device=dev).manual_seed(seed), **hub.model_kwargs(
                    name, "flash_hb", h if name.startswith("mae") else None))
        model.train()
        if name == "sspnet_resnet18":
            inputs = (arr(b, 1, h, w, 3),
                      (arr(b, 1, h, w) > 0).float(), arr(b, h, w, 3))
        elif name == "madnet":
            left = arr(b, h, w, 3)
            inputs = (left, torch.roll(left, -3, dims=2))
        else:
            inputs = (arr(b, h, w, 3),)

        def pair(i):
            out = model(*inputs, rng=step_key(seed, i, dev))
            if isinstance(out, dict):
                out = [v for v in out.values() if torch.is_tensor(v)] + \
                    list(out.get("pyramid", []))
            elif not isinstance(out, (tuple, list)):
                out = [out]
            out = [o for o in out if o.is_floating_point()]
            loss = sum(o.float().mean() for o in out)
            model.zero_grad(set_to_none=True)
            loss.backward()
            return out, loss
        pair(0)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, loss = pair(1)
        end.record()
        torch.cuda.synchronize()
        launched = {k: v for k, v in fa.launch_counts().items() if v}
        _add(total, launched)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        finite = (all(bool(torch.isfinite(o).all()) for o in out)
                  and all(bool(torch.isfinite(g_).all()) for g_ in grads))
        n = sum(p.numel() for p in model.parameters())
        log(f"{name} at {h}x{w}, batch {b}, bf16: {n / 1e6:.2f} M "
            f"parameters, outputs {[tuple(o.shape) for o in out[:3]]}, "
            f"forward + backward {start.elapsed_time(end):.2f} ms (CUDA "
            f"events), finite {finite}, K1 {json.dumps(launched)}; "
            f"{time.perf_counter() - t0:.2f}s")
        check(finite and grads and np.isfinite(float(loss.detach())),
              f"{name}: finite outputs and gradients")
        if name.startswith("mae"):
            check(launched.get(fa.KERNEL_NAMES[4], 0) > 0,
                  f"{name} attends on K1")
        del model, inputs, out, loss, grads
        torch.cuda.empty_cache()
    return total


# phase 55: the Happy-Whale backbones (models/classification/zoo_extra.py),
# their configs through the train CLI, and the mask crop
ZOO_EXTRA = ("xception", "inception_v4", "dpn68", "dpn92",
             "nasnet_a_mobile", "polynet", "senet154")
ZOO_EXTRA_CONFIGS = ("dpn92", "inception_v4", "nasnet_a_mobile", "polynet",
                     "senet154", "xception")
# 8 seeded 320x256 images, masks predicted at 256², crops for ArcFace
MASK_IMAGES, MASK_SIZE, CROP_SIZE = 8, 256, 112


def _forward_flops(name) -> int:
    """The FLOPs of one 224² forward of registry model ``name``, counted
    by ``torch.utils.flop_counter`` on the meta device (nothing runs)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from deeplearning_tpu_torch.core.registry import MODELS
    with torch.device("meta"):
        model = MODELS.build(name, num_classes=1000).eval()
        x = torch.zeros(1, 224, 224, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()


def _zoo_extra(dev, seed, workdir) -> None:
    """Phase 55: each zoo_extra factory at full width and depth on the
    card in bf16, one eval forward at 224² (batch 2) and one train step
    (batch 8), the seconds and peak device memory of each; the six configs
    through the train CLI's ``build`` at their 64², two steps each; the
    mask crop end to end (U-Net masks, ``mask_crop_source``'s crops,
    ArcFace embeddings)."""
    import shutil
    import torch
    from PIL import Image
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.core.rng import root_key
    from deeplearning_tpu_torch.models.metric.mask_crop import (
        make_mask_predictor, mask_crop_source, write_masks)
    from deeplearning_tpu_torch.train import TrainState, make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    shutil.rmtree(workdir, ignore_errors=True)
    g = np.random.default_rng(seed + 55)
    x = torch.from_numpy(g.normal(size=(2, 224, 224, 3)).astype(
        np.float32)).to(dev)
    batch = {"image": torch.from_numpy(g.normal(
        size=(ZOO_BATCH, 224, 224, 3)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(g.integers(0, 1000, ZOO_BATCH)).to(dev)}

    def build(name, **kw):
        with torch.device(dev):
            return MODELS.build(name, generator=torch.Generator(
                device=dev).manual_seed(seed), **kw)
    t55 = time.perf_counter()
    for name in ZOO_EXTRA:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build(name, num_classes=1000, dtype=torch.bfloat16).eval()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            logits = model(x)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(tuple(logits.shape) == (2, 1000)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{name}: a finite (2, 1000) eval forward")
        model.train()
        state = TrainState.create(model=model, tx=_adamw(model),
                                  batch_stats=dict(model.named_buffers()))
        step = make_train_step(make_loss_fn(has_batch_stats=True),
                               device=dev)
        _, m = step(state, batch, root_key(seed))
        m = _metrics(m)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n = sum(p.numel() for p in model.parameters())
        flops = _forward_flops(name)
        bound_ms = 3 * ZOO_BATCH * flops / PEAK_FLOPS["bfloat16"] * 1e3
        log(f"{name}: {n / 1e6:.2f} M parameters, {flops / 1e9:.2f} GFLOP "
            f"a 224² forward; built {t1 - t0:.2f}s, eval forward (2 x "
            f"224², bf16) {t2 - t1:.2f}s, first train step (batch "
            f"{ZOO_BATCH}, bound {bound_ms:.3f} ms) "
            f"{t3 - t2:.2f}s, loss {m['loss']:.4f}; peak device memory "
            f"{_gib(torch.cuda.max_memory_allocated()):.2f} GiB")
        del model, state, step, logits
    log(f"phase 55 backbones: {len(ZOO_EXTRA)} in "
        f"{time.perf_counter() - t55:.1f}s")
    torch.cuda.empty_cache()

    cli = _cli()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    for name in ZOO_EXTRA_CONFIGS:
        t1 = time.perf_counter()
        cfg = config_cli(cli.Config(), [
            "--cfg", os.path.join(here, f"configs/{name}.yaml"),
            "data.n_train=128", "train.epochs=1"])
        check(cfg.model.name == name and cfg.train.device == "cuda"
              and cfg.data.image_size == 64,
              f"configs/{name}.yaml: {name} at 64² on the card")
        trainer = cli.build(cfg)
        trainer.train()
        ev = trainer._last_eval
        check(trainer.state.step == 128 // cfg.data.global_batch == 2
              and all(np.isfinite(v) for v in ev.values()),
              f"configs/{name}.yaml trains two steps through the CLI")
        log(f"configs/{name}.yaml through the train CLI: 2 steps (batch "
            f"{cfg.data.global_batch}, 64²) + eval in "
            f"{time.perf_counter() - t1:.2f}s, eval {json.dumps(ev)}")
        del trainer
        torch.cuda.empty_cache()
    log(f"phase 55 configs: {len(ZOO_EXTRA_CONFIGS)} in "
        f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    img_dir = os.path.join(workdir, "images")
    mask_dir = os.path.join(workdir, "masks")
    os.makedirs(img_dir)
    r = np.random.default_rng(seed + 550)
    paths = []
    for i in range(MASK_IMAGES):
        arr = r.integers(0, 255, (MASK_SIZE + 64, MASK_SIZE, 3),
                         dtype=np.uint8)
        arr[80:240, 48:208] = 255          # a bright animal-sized block
        paths.append(os.path.join(img_dir, f"whale{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    seg = build("unet", num_classes=1)
    predict = make_mask_predictor(seg)
    written = write_masks(predict, paths, mask_dir,
                          image_size=(MASK_SIZE, MASK_SIZE),
                          batch=MASK_IMAGES)
    fg = float(np.mean([np.asarray(Image.open(os.path.join(
        mask_dir, f"whale{i}.png"))) > 0 for i in range(MASK_IMAGES)]))
    src = mask_crop_source(paths, np.arange(MASK_IMAGES) % 2, mask_dir,
                           out_hw=(CROP_SIZE, CROP_SIZE))
    crops = np.stack([src[i]["image"] for i in range(MASK_IMAGES)])
    retr = build("arcface_resnet18", num_classes=2).eval()
    with torch.no_grad():
        emb = retr(torch.from_numpy(crops).to(dev))["embedding"]
    torch.cuda.synchronize()
    log(f"mask crop: {written} U-Net masks at {MASK_SIZE}² (foreground "
        f"{fg:.3f}), crops {crops.shape}, ArcFace embeddings "
        f"{tuple(emb.shape)} in {time.perf_counter() - t0:.2f}s")
    check(written == MASK_IMAGES and crops.shape == (
        MASK_IMAGES, CROP_SIZE, CROP_SIZE, 3) and np.isfinite(crops).all()
        and tuple(emb.shape) == (MASK_IMAGES, 512)
        and bool(torch.isfinite(emb).all()),
        "the mask crop: masks written, crops made, finite embeddings")
    del seg, retr, emb
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()


# phase 56: the supervise CLI around the train CLI's ViT-B/16 on K1
SUP_OVERRIDES = ["data.global_batch=32", "data.n_train=256",
                 "train.epochs=1"]                  # 8 steps an epoch
SUP_FAULTS = "sigterm@step:3@attempt:0;wedge@step:5@attempt:1"
# the deadline stays well above the longest gap between a healthy child's
# beats (a resume's checkpoint load and first step: 4.2 s for two steps,
# PERF.md §6, PR 21)
SUP_WEDGE_S, SUP_POLL_S, SUP_TIMEOUT_S = 10.0, 0.25, 400.0


def _gpu_apps() -> list:
    """nvidia-smi's compute apps, one pid each (in the driver's pid
    namespace, which need not be this machine's)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return [s.strip() for s in out.splitlines() if s.strip()]


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has an NVIDIA device open: a CUDA context
    opens ``/dev/nvidia<N>`` (read from ``/proc/<pid>/fd``)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            return True
    return False


def _supervised_vit(fa, dev, seed, workdir) -> dict:
    """Phase 56: one step of configs/vit_b16_imagenet.yaml (batch 32)
    through the train CLI's ``build`` in this process, K1 counted from zero
    (12 forward, 12 dQ, 12 dK/dV); then ``python -m
    deeplearning_tpu_torch.supervise`` around ``python -m
    deeplearning_tpu_torch.train`` on the same config, with
    ``DLTPU_FAULTS`` preempting attempt 0 at step 3 and wedging attempt 1
    at step 5: exit 0, preempted / wedged / completed in the supervisor's
    decision log, every resume from a checkpoint its CRCs verify, the
    wedge kill within the deadline and a few polls of the last heartbeat
    movement, the supervisor never holding the card while each child
    does. nvidia-smi lists compute apps by the driver's pids, which this
    machine's pid namespace need not share, so a process holds the card
    when it has an NVIDIA device open (``/proc/<pid>/fd``), and
    nvidia-smi's list never holds more than this process and one child.
    The heartbeat, the processes and nvidia-smi are sampled every
    ``SUP_POLL_S`` for the wall split."""
    import shutil
    import signal
    import torch
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.elastic.heartbeat import read_heartbeat
    cli = _cli()
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    argv = ["--cfg", os.path.join(here, "configs/vit_b16_imagenet.yaml"),
            *SUP_OVERRIDES]
    cfg = config_cli(cli.Config(), argv)
    check(cfg.model.name == MODEL and cfg.model.attn == "flash_hb"
          and cfg.train.device == "cuda" and cfg.data.image_size == 224,
          "vit_b16_imagenet.yaml: ViT-B/16 at 224² on flash_hb, on the card")
    trainer = cli.build(cfg)
    feed = iter(trainer.train_loader)
    batch = next(feed)
    feed.close()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    trainer.state, m = trainer.train_step(trainer.state, batch, trainer.rng)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fa.launch_counts().items() if v}
    m = _metrics(m)
    want = {fa.KERNEL_NAMES[4]: DEPTH, fa.BWD_KERNEL_NAMES["dq"][4]: DEPTH,
            fa.BWD_KERNEL_NAMES["dkv"][4]: DEPTH}
    log(f"vit_b16_imagenet.yaml (batch 32) one step through the CLI's "
        f"build: loss {m['loss']:.4f}, launches {json.dumps(counts)}")
    check(counts == want, f"one CLI step launches {want}")
    del trainer, batch
    torch.cuda.empty_cache()

    sup_dir = os.path.join(workdir, "sup")
    run_dir = os.path.join(workdir, "run")
    cmd = [sys.executable, "-m", "deeplearning_tpu_torch.supervise",
           "--workdir", sup_dir, "--max-restarts", "3",
           "--wedge-deadline", str(SUP_WEDGE_S), "--startup-deadline", "300",
           "--kill-grace", "1", "--backoff-base", "0.25",
           "--backoff-max", "0.5", "--",
           sys.executable, "-m", "deeplearning_tpu_torch.train", *argv,
           f"train.workdir={run_dir}"]
    out_path = os.path.join(workdir, "supervise.log")
    beat_path = os.path.join(sup_dir, "heartbeat.json")
    moves = []          # (time, pid, step, activity) at each change seen
    on_card, sup_on_card, samples, apps = set(), False, 0, []
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=here, stdout=out,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, DLTPU_FAULTS=SUP_FAULTS),
                                start_new_session=True)
        try:
            while proc.poll() is None:
                check(time.perf_counter() - t0 < SUP_TIMEOUT_S,
                      f"the supervised run ends within {SUP_TIMEOUT_S}s")
                beat = read_heartbeat(beat_path)
                if beat is not None:
                    key = (beat.get("pid"), beat.get("step"),
                           beat.get("activity"))
                    if not moves or moves[-1][1:] != key:
                        moves.append((time.time(), *key))
                    if _holds_card(key[0]):
                        on_card.add(key[0])
                sup_on_card |= _holds_card(proc.pid)
                apps.append(len(_gpu_apps()))
                samples += 1
                time.sleep(SUP_POLL_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        tail = f.read()[-4000:]
    check(proc.returncode == 0, f"the supervise CLI exits 0:\n{tail}")
    with open(os.path.join(sup_dir, "flightrec_supervisor.json")) as f:
        rec = json.load(f)
    events = rec["events"]
    ending = {"child_exit": lambda e: e["outcome"],
              "wedge_kill": lambda e: "wedged"}
    outcomes = [ending[e["kind"]](e) for e in events if e["kind"] in ending]
    launches = [e for e in events if e["kind"] == "launch"]
    kill = [e for e in events if e["kind"] == "wedge_kill"]
    backoff = sum(e["delay_s"] for e in events if e["kind"] == "backoff")
    child_pids = list(dict.fromkeys(mv[1] for mv in moves))
    log(f"supervise CLI: exit {proc.returncode} in {wall:.1f}s, outcomes "
        f"{outcomes}, {len(launches)} launches, backoff {backoff:.2f}s, "
        f"reason {rec['reason']}; {samples} samples: children "
        f"{child_pids} held the card {[p in on_card for p in child_pids]},"
        f" the supervisor ({proc.pid}) {sup_on_card}; nvidia-smi's "
        f"compute apps {min(apps)}-{max(apps)} (this process and a child)")
    check(outcomes == ["preempted", "wedged", "completed"]
          and rec["reason"] == "completed" and len(launches) == 3
          and len(kill) == 1, "preempted, wedged, then completed")
    check([e["returncode"] for e in events if e["kind"] == "child_exit"]
          == [75, 0], "the preempted child exits 75")
    check(len(child_pids) == 3 and all(p in on_card for p in child_pids)
          and not sup_on_card and rec["hbm"] is None and max(apps) == 2,
          "each child holds the card; the supervisor never does")
    # the wall split: child start (launch -> first beat), steps (-> the
    # beat's last movement), then the wedge detection or the exit
    ends = [e["time"] for e in events if e["kind"] in ending]
    for i, (launch, pid) in enumerate(zip(launches, child_pids)):
        mine = [mv for mv in moves if mv[1] == pid]
        log(f"attempt {i} (pid {pid}): child start "
            f"{mine[0][0] - launch['time']:.2f}s, steps to the last beat "
            f"{mine[-1][0] - mine[0][0]:.2f}s (step {mine[-1][2]}), then "
            f"{ends[i] - mine[-1][0]:.2f}s to its end")
    stalled = kill[0]["time"] - [mv for mv in moves
                                 if mv[1] == child_pids[1]][-1][0]
    check(SUP_WEDGE_S - 1.0 <= stalled <= SUP_WEDGE_S + 4 * SUP_POLL_S + 1.0,
          f"the wedge kill {stalled:.2f}s after the last beat movement "
          f"(deadline {SUP_WEDGE_S}s plus a few polls)")
    with open(os.path.join(run_dir, "log_p0.txt")) as f:
        train_log = f.read()
    resumes = [int(s) for s in re.findall(r"auto-resume from step (\d+)",
                                          train_log)]
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    recorded = ckpt._read_checksum_file()
    final = ckpt.latest_step()
    log(f"resumes from steps {resumes}, checkpoints {ckpt.all_steps()} "
        f"(CRCs recorded for {sorted(recorded, key=int)}), final step "
        f"{final}")
    check(resumes == [3, 3] and all(str(s) in recorded for s in resumes)
          and "failed integrity check" not in train_log
          and all(ckpt.verify_step(s) for s in ckpt.all_steps())
          and final == 3 + 256 // 32,
          "every resume from the preempted checkpoint, verified by CRC")
    shutil.rmtree(workdir, ignore_errors=True)
    return counts


# ---------- phases 57-59: the thread sanitizer, the audit and export (8c, 8c2)
THREADS_BATCH, THREADS_STEPS = 32, 6
THREADS_RUNS = (True, False, False, True)       # threads on / off, in turns
ZOO_THREADS_CLIENTS, ZOO_THREADS_REQUESTS = 8, 8      # a client
ZOO_THREADS_CYCLES = 2                                # evict + load of Swin-T
ZOO_THREADS_BUCKETS = (1, 8)
AUDIT_BATCH, EXPORT_BATCH = 128, 8
# the exported ViT-B/16 runs the eager forward's kernels in the same order:
# aimed at equal bits, held at this absolute difference of the logits
EXPORT_LOGIT_TOL = 1e-3
# fused Conv + BatchNorm (float32, no TF32): logits within this share of
# the largest unfused logit
FUSE_REL_TOL = 1e-4
DISPATCH_CALLS = 2000         # K1 forward calls a host-cost measurement


def _threads_vit(fa, dev, seed, workdir) -> dict:
    """Phase 57: ViT-B/16 at full width (flash_hb, batch 32, 6 steps)
    through the Trainer with the prefetcher, a heartbeat file and async
    checkpoints, with ``strict="transfers,threads"`` and with
    ``strict="transfers"``, in turns (threads, plain, plain, threads), on
    one state. Every threads run ends with no ``LockOrderError`` and its
    ``status()`` shows patched modules, instrumented locks, acquires seen
    and the static graph's edges seeded; every run launches 12 of each
    flash_hb K1 kernel a step. The step wall (median gap between the
    steps' ``after_iter`` on the host, steps 2-6; the host dispatches
    ahead of the card, so the gap is the slower of the two) beside the
    plain runs'."""
    import dataclasses
    import shutil
    import torch
    from deeplearning_tpu_torch.analysis import concurrency, threadsan
    from deeplearning_tpu_torch.train.trainer import Trainer
    cli = _cli()
    cfg = _smoke_cfg(None, THREADS_STEPS)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, global_batch=THREADS_BATCH,
        n_train=THREADS_BATCH * THREADS_STEPS))
    base = cli.build(cfg)
    loader = base.train_loader.loader
    static = concurrency.lock_order_graph()
    log(f"static lock graph of the port: {len(static['locks'])} locks, "
        f"{len(static['edges'])} edges, {len(static['spawn_sites'])} "
        f"spawn sites, cycles {static['cycles']}")
    check(static["locks"] and not static["cycles"],
          "the port's static lock graph has locks and no cycle")
    walls = {True: [], False: []}
    counts = {}
    want = {fa.KERNEL_NAMES[4]: DEPTH * THREADS_STEPS,
            fa.BWD_KERNEL_NAMES["dq"][4]: DEPTH * THREADS_STEPS,
            fa.BWD_KERNEL_NAMES["dkv"][4]: DEPTH * THREADS_STEPS}
    for i, threads in enumerate(THREADS_RUNS):
        wd = os.path.join(workdir, str(i))
        shutil.rmtree(wd, ignore_errors=True)
        threadsan.reset()
        stamps = []
        t = Trainer(state=base.state, train_step=base.train_step,
                    train_loader=loader, prefetch=2, seed=seed, epochs=1,
                    log_every=THREADS_STEPS, workdir=wd,
                    async_checkpoint=True, log_backends=("csv",),
                    heartbeat=os.path.join(wd, "heartbeat.json"),
                    strict="transfers,threads" if threads else "transfers")
        t.callbacks.register("after_iter", lambda tr, **_: stamps.append(
            time.perf_counter()))
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        try:
            t.train()
            torch.cuda.synchronize()
            st, acquires = threadsan.status(), threadsan.acquires()
        finally:
            threadsan.disable()
        run = {k: v for k, v in fa.launch_counts().items() if v}
        check(run == want, f"run {i}: launches {run} == {want}")
        for k, v in run.items():
            counts[k] = counts.get(k, 0) + v
        gaps = np.diff(stamps)[1:] * 1e3
        walls[threads].append(float(np.median(gaps)))
        check(os.path.exists(os.path.join(wd, "heartbeat.json")),
              "the heartbeat file was written")
        if threads:
            log(f"threads run {i}: status {json.dumps(st)}, acquires "
                f"{acquires}")
            check(st["enabled"] and st["violations"] == 0
                  and not st["tripped"], "no lock violation")
            check(st["modules_patched"] > 0 and st["locks_instrumented"] > 0
                  and acquires > 0, "patched modules, instrumented locks "
                  "and acquires seen")
            check(st["static_edges"] == len({
                (e["src"], e["dst"]) for e in static["edges"]}),
                "the static graph's edges seeded")
        else:
            check(not st["enabled"], "the plain run arms no sanitizer")
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 57 step wall ms (median of steps 2-{THREADS_STEPS}, batch "
        f"{THREADS_BATCH}): threads {[round(w, 3) for w in walls[True]]}, "
        f"plain {[round(w, 3) for w in walls[False]]}; launches "
        f"{json.dumps(counts)}")
    del base, loader
    torch.cuda.empty_cache()
    return counts


def _threads_zoo(fa, wa, dev, seed) -> dict:
    """Phase 58: the zoo under ``DLTPU_STRICT=threads``, as JAX's
    tests/test_zoo_serving.py:425 drives it: a ViT-B/16 tenant on K1
    (flash_hb) and a Swin-T tenant on K2, buckets 1 and 8, behind the
    batcher; 8 client threads submit (alternating tenants; at least 8
    requests each, and on until the admin is done) while an admin thread
    evicts and reloads Swin-T twice. No ``LockOrderError``, every answer
    arrives, and K1's forward and K2 launch once a block of every
    forward: 12 × (the warm-up forwards + the batches dispatched) of each
    tenant."""
    import threading
    import torch
    from deeplearning_tpu_torch.analysis import strict as strict_mod
    from deeplearning_tpu_torch.analysis import threadsan
    from deeplearning_tpu_torch.serve import (InferenceEngine, MicroBatcher,
                                              ModelZoo)
    os.environ["DLTPU_STRICT"] = "threads"
    threadsan.reset()
    try:
        check(strict_mod.maybe_enable_threads(strict_mod.resolve()),
              "DLTPU_STRICT=threads arms the sanitizer")
        forwards = {"vit": 0, "swin": 0}
        names = {"vit": MODEL, "swin": SWIN}

        def factory(alias):
            def build():
                eng = InferenceEngine(names[alias], num_classes=1000,
                                      batch_buckets=ZOO_THREADS_BUCKETS,
                                      seed=seed,
                                      attn="flash_hb", device=dev,
                                      precompile=False)

                def hook(*_):
                    forwards[alias] += 1
                eng.model.register_forward_hook(hook)
                eng.warmup()
                return eng
            return build

        zoo = ModelZoo()
        check(isinstance(zoo._lock, threadsan.InstrumentedLock),
              "the zoo's lock is instrumented")
        for alias in names:
            zoo.register(alias, engine_factory=factory(alias),
                         batch_buckets=ZOO_THREADS_BUCKETS, image_size=224)
            check(zoo.load(alias, wait=True) == "warm", f"{alias} loads")
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        wa.reset_launch_counts()
        for alias in forwards:
            forwards[alias] = 0
        images = np.random.default_rng(seed).normal(
            size=(4, 224, 224, 3)).astype(np.float32)
        answers, errors, submitted = [], [], []
        admin_done = threading.Event()
        t0 = time.perf_counter()
        with MicroBatcher(zoo=zoo, max_wait_ms=2.0) as mb:
            def client(i):
                """At least ZOO_THREADS_REQUESTS requests, and on until
                the admin thread's cycles are done."""
                try:
                    j = 0
                    while (j < ZOO_THREADS_REQUESTS
                           or not admin_done.is_set()):
                        alias = ("vit", "swin")[(i + j) % 2]
                        submitted.append(alias)     # atomic append
                        answers.append(mb.submit(
                            images[j % 4], model=alias).result(timeout=120))
                        j += 1
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)

            def admin():
                """Evict Swin-T (refused while a batch of it is in
                flight: retried) and reload it, twice."""
                try:
                    for _ in range(ZOO_THREADS_CYCLES):
                        deadline = time.monotonic() + 60
                        while not zoo.evict("swin"):
                            check(time.monotonic() < deadline,
                                  "Swin-T evicts within 60 s")
                            time.sleep(0.01)
                        zoo.load("swin", wait=True)
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)
                finally:
                    admin_done.set()
            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True)
                       for i in range(ZOO_THREADS_CLIENTS)]
            threads.append(threading.Thread(target=admin, daemon=True))
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            check(not any(th.is_alive() for th in threads),
                  "the clients and the admin thread finish")
            torch.cuda.synchronize()
            dispatched = mb.dispatched
        wall = time.perf_counter() - t0
        check(errors == [], f"no error: {errors[:1]}")
        n = len(submitted)
        check(n >= ZOO_THREADS_CLIENTS * ZOO_THREADS_REQUESTS
              and len(answers) == n and all(
                  np.isfinite(np.asarray(a)).all() for a in answers),
              f"every one of the {n} answers arrives, finite")
        st, acquires = threadsan.status(), threadsan.acquires()
        check(st["violations"] == 0 and not st["tripped"],
              "no lock violation")
        counts = {k: v for d in (fa.launch_counts(), wa.launch_counts())
                  for k, v in d.items() if v}
        want = {fa.KERNEL_NAMES[4]: DEPTH * forwards["vit"],
                wa.KERNEL_NAME: SWIN_BLOCKS * forwards["swin"]}
        log(f"phase 58: {n} answers in {wall:.2f}s, {dispatched} batches "
            f"dispatched, forwards {json.dumps(forwards)} (warm-ups of the "
            f"reloads included), zoo loads {zoo.loads} evictions "
            f"{zoo.evictions}, status {json.dumps(st)}, acquires {acquires}, "
            f"launches {json.dumps(counts)}")
        check(zoo.evictions == ZOO_THREADS_CYCLES, "Swin-T evicted twice")
        check(counts == want, f"launches {counts} == 12 x forwards {want}")
        check(forwards["vit"] + forwards["swin"]
              == dispatched + len(ZOO_THREADS_BUCKETS) * ZOO_THREADS_CYCLES,
              "forwards = the batches dispatched + the reloads' warm-ups")
        del zoo
    finally:
        threadsan.disable()
        os.environ.pop("DLTPU_STRICT", None)
    torch.cuda.empty_cache()
    return counts


def _audit_export(fa, wa, nms_ops, dev, seed, workdir) -> tuple:
    """Phase 59: the fake-mode audit and the export. ViT-B/16's train step
    at batch 128 (flash_hb) traced on the card's device: 12 forward, 12 dQ
    and 12 dK/dV kernel nodes, 0 transfers, no launch, its peak
    intermediate; Swin-T's eval forward: 12 K2 nodes; YOLOX-S's predict
    at 640²: one K3 node; every row of ``run_audits()`` ok on the card.
    The custom ops' fake strides equal the real ones on the card. Then
    ViT-B/16 on flash_hb at batch 8 exported (``torch.export``), saved as
    ``.pt2``, loaded and run: 12 K1 forward launches a call and its logits
    against eager's; the export, save and load seconds and both forwards'
    ms. ``fuse_conv_bn`` on ResNet-50 (float32, 224², BatchNorm
    statistics drawn from the seed) against the unfused eval logits. And
    the host cost of the custom-op dispatch: one K1 forward at B = 1
    through ``attention_bnhd`` beside a direct call of the C entry point,
    in turns. Returns the launches, and the ViT-B/16 model and its loaded
    program for phase 60."""
    import io
    import shutil
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.analysis import audit
    from deeplearning_tpu_torch.export.fuse import fuse_conv_bn
    from deeplearning_tpu_torch.models.detection.predict import (
        build_predict_fn)
    from deeplearning_tpu_torch.train import make_train_step
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    fa.reset_launch_counts()
    wa.reset_launch_counts()
    nms_ops.reset_launch_counts()

    # the audit: three graphs, nothing launched
    t0 = time.perf_counter()
    mode = audit.fake_mode()
    state = audit._train_state(MODEL, mode, dev,
                               attn_fn=get_attn_fn("flash_hb"))
    batch = {"image": audit.fake_tensor(mode, (AUDIT_BATCH, 224, 224, 3),
                                        device=dev),
             "label": audit.fake_tensor(mode, (AUDIT_BATCH,), torch.long,
                                        dev)}
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)
    want = {"dltpu.flash_fwd": DEPTH, "dltpu.flash_bwd_dq": DEPTH,
            "dltpu.flash_bwd_dkv": DEPTH}
    row = audit.Audit("train_step_vit_b16_b128", step, (state, batch, 0),
                      max_transfers=0, want_ops=want).run()
    log(f"audit ViT-B/16 train step, batch {AUDIT_BATCH}: "
        f"{json.dumps(row)} ({time.perf_counter() - t0:.2f}s)")
    check(row["ok"], "12 forward, 12 dQ, 12 dK/dV nodes and 0 transfers")
    del state, batch
    model, _ = hub.load(SWIN, num_classes=1000, seed=seed, device="cpu",
                        **hub.model_kwargs(SWIN, "flash_hb"))
    audit.fake_module(model, mode, dev)
    with torch.no_grad():
        events = audit.trace(model, audit.fake_tensor(
            mode, (8, 224, 224, 3), device=dev))
    n_k2 = sum(ev.name == "dltpu.window_attn" for ev in events)
    log(f"audit Swin-T eval forward (batch 8): {n_k2} K2 nodes, "
        f"{sum(ev.transfer for ev in events)} transfers")
    check(n_k2 == SWIN_BLOCKS, "Swin-T's forward: 12 K2 nodes")
    model, _ = hub.load(YOLOX, num_classes=YOLOX_CLASSES, seed=seed,
                        device="cpu")
    audit.fake_module(model, mode, dev)
    predict = build_predict_fn(model, YOLOX, YOLOX_CLASSES,
                               score_thresh=0.0, max_det=YOLOX_MAX_DET)
    with torch.no_grad():
        events = audit.trace(predict, audit.fake_tensor(
            mode, (8, YOLOX_SIZE, YOLOX_SIZE, 3), device=dev))
    n_k3 = sum(ev.name == "dltpu.nms_sweep" for ev in events)
    log(f"audit YOLOX-S predict (batch 8, 640²): {n_k3} K3 nodes, "
        f"{sum(ev.transfer for ev in events)} transfers, peak "
        f"{max(n for ev in events for n in ev.out_elements)} elements")
    check(n_k3 == 1, "YOLOX-S's predict: one K3 node a batch")
    del model, predict, events
    launched = {k: v for d in (fa.launch_counts(), wa.launch_counts(),
                               nms_ops.launch_counts())
                for k, v in d.items() if v}
    check(launched == {}, f"the fake traces launched nothing: {launched}")
    t0 = time.perf_counter()
    rows = audit.run_audits(device=dev)
    for r in rows:
        log(f"  run_audits: {json.dumps(r)}")
    log(f"run_audits() on the card: {len(rows)} rows in "
        f"{time.perf_counter() - t0:.2f}s")
    check(rows and all(r["ok"] for r in rows), "every audit row ok")

    # the ops' fake strides are the real ones on the card
    g = torch.Generator(device=dev).manual_seed(seed)
    qb = torch.randn(2, 197, 12, 64, generator=g, device=dev,
                     dtype=torch.bfloat16)
    q = qb.transpose(1, 2)
    qkv = torch.randn(8, 49, 3, 3, 32, generator=g, device=dev,
                      dtype=torch.bfloat16)
    bias = torch.zeros(3, 49, 49, device=dev)
    sboxes, alive0, _, _ = nms_ops.sort_pad_candidates(
        torch.rand(2, 100, 4, generator=g, device=dev).cumsum(-1),
        torch.rand(2, 100, generator=g, device=dev), float("-inf"),
        nms_ops.WORD)
    calls = [(torch.ops.dltpu.flash_fwd, (q, q, q, 0.125, False, 4, True)),
             (torch.ops.dltpu.window_attn, (qkv, bias, None, 8)),
             (torch.ops.dltpu.nms_sweep, (sboxes, alive0, 0.5, 20))]
    fake = FakeTensorMode()
    for op, args in calls:
        real = op(*args)
        with fake:
            faked = op(*[fake.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args])
        pairs = zip(real if isinstance(real, tuple) else (real,),
                    faked if isinstance(faked, tuple) else (faked,))
        same = all(r.shape == f.shape and r.stride() == f.stride()
                   and r.dtype == f.dtype for r, f in pairs)
        check(same, f"{op}: fake shapes, strides and dtypes are the real ones")
    o, lse = calls[0][0](*calls[0][1])
    do = torch.randn_like(o)
    real = torch.ops.dltpu.flash_bwd_dq(q, q, q, o, lse, do, None, 0.125,
                                        False, 4, False, True)
    real += torch.ops.dltpu.flash_bwd_dkv(q, q, q, lse, do, real[1], 0.125,
                                          False, 4, False, True)
    with fake:
        fargs = [fake.from_tensor(t) for t in (q, o, lse, do)]
        fq, fo, flse, fdo = fargs
        faked = torch.ops.dltpu.flash_bwd_dq(fq, fq, fq, fo, flse, fdo, None,
                                             0.125, False, 4, False, True)
        faked += torch.ops.dltpu.flash_bwd_dkv(
            fq, fq, fq, flse, fdo, faked[1], 0.125, False, 4, False, True)
    check(all(r.stride() == f.stride() and r.shape == f.shape
              for r, f in zip(real, faked)),
          "the backward ops' fake strides are the real ones")
    log("fake strides equal the real ones on the card: flash_fwd, "
        "flash_bwd_dq, flash_bwd_dkv, window_attn, nms_sweep")

    # the host cost of the custom-op dispatch: K1's forward at B = 1
    q1 = torch.randn(1, 197, 12, 64, generator=g, device=dev,
                     dtype=torch.bfloat16)
    out = fa._empty_bhnd(q1.transpose(1, 2), torch.bfloat16, True)
    lse1 = torch.empty(12 * 197, device=dev)
    qt = q1.transpose(1, 2)
    lib = fa._lib()
    raw = (qt.data_ptr(), qt.data_ptr(), qt.data_ptr(), out.data_ptr(),
           lse1.data_ptr(), 1, 12, 197, 64,
           *[st for t in (qt, qt, qt, out) for st in t.stride()[:3]],
           0.125, 0, 4, 1, torch.cuda.current_stream().cuda_stream)
    fns = {"custom op": lambda: fa.attention_bnhd(q1, q1, q1,
                                                  heads_per_cta=4),
           "launch wrapper": lambda: fa._launch(qt, qt, qt, out, 0.125,
                                                False, 4, lse=lse1),
           "C entry point": lambda: lib.flash_attn_fwd(*raw)}
    host = {k: [] for k in fns}
    with torch.no_grad():
        for name in ("custom op", "launch wrapper", "C entry point",
                     "C entry point", "launch wrapper", "custom op"):
            for _ in range(100):
                fns[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fns[name]()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) / DISPATCH_CALLS
                              * 1e6)
    mean = {k: statistics.mean(v) for k, v in host.items()}
    rounded = {k: [round(x, 2) for x in v] for k, v in host.items()}
    log(f"K1 forward at (1, 12, 197, 64) bf16, host us a call (in turns, "
        f"{DISPATCH_CALLS} calls ending in a synchronise): "
        f"{json.dumps(rounded)}; the custom op adds "
        f"{mean['custom op'] - mean['launch wrapper']:.2f} us to the launch "
        f"wrapper, which adds "
        f"{mean['launch wrapper'] - mean['C entry point']:.2f} us to the C "
        f"entry point")

    # export, save, load and run ViT-B/16 on K1
    model, _ = hub.load(MODEL, num_classes=1000, seed=seed, device=dev,
                        **hub.model_kwargs(MODEL, "flash_hb"))
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(EXPORT_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = torch.export.export(model, (x,))
    t_export = time.perf_counter() - t0
    n_nodes = sum(str(n.target) == "dltpu.flash_fwd.default"
                  for n in ep.graph.nodes)
    path = os.path.join(workdir, "vit_b16_flash_hb.pt2")
    t0 = time.perf_counter()
    torch.export.save(ep, path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = torch.export.load(path).module()
    t_load = time.perf_counter() - t0
    check(n_nodes == DEPTH, f"the exported graph holds {DEPTH} K1 nodes")
    fa.reset_launch_counts()
    with torch.no_grad():
        got = loaded(x)
        torch.cuda.synchronize()
        per_call = fa.launch_counts()[fa.KERNEL_NAMES[4]]
        want = model(x)
    err = float((got.float() - want.float()).abs().max())
    bits = bool(torch.equal(got, want))
    ms = {}
    with torch.no_grad():
        for name, fn in (("exported", loaded), ("eager", model),
                         ("eager", model), ("exported", loaded)):
            ms.setdefault(name, []).append(_time_ms(lambda: fn(x), iters=20,
                                                    warmup=3))
    counts = {fa.KERNEL_NAMES[4]: per_call}
    log(f"export ViT-B/16 flash_hb batch {EXPORT_BATCH}: export "
        f"{t_export:.2f}s, save {t_save:.2f}s ({os.path.getsize(path)} "
        f"bytes), load {t_load:.2f}s; {per_call} K1 forward launches a call; "
        f"logits max |exported - eager| {err:.3e} (bit-equal {bits}, tol "
        f"{EXPORT_LOGIT_TOL}); forward ms exported "
        f"{[round(v, 4) for v in ms['exported']]}, eager "
        f"{[round(v, 4) for v in ms['eager']]}")
    check(per_call == DEPTH, "the loaded program launches 12 K1 forwards")
    check(np.isfinite(err) and err <= EXPORT_LOGIT_TOL,
          "exported logits equal eager's")
    # phase 60 packages this model and times this program beside its runner
    exported = {"model": model, "program": loaded}
    del ep, model, loaded
    shutil.rmtree(workdir, ignore_errors=True)

    # Conv + BatchNorm folding on ResNet-50
    model, _ = hub.load("resnet50", num_classes=1000, seed=seed, device=dev,
                        dtype=torch.float32)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.running_mean.numel()
                for t, v in ((m.running_mean, rng.normal(0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c)),
                             (m.weight, 1 + rng.normal(0, 0.1, c)),
                             (m.bias, rng.normal(0, 0.1, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    xr = torch.from_numpy(rng.normal(size=(8, 224, 224, 3)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        want = model(xr).float()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    fused = fuse_conv_bn(state, eps=lambda bn: model.get_submodule(bn).eps)
    t_fuse = time.perf_counter() - t0
    model.load_state_dict(fused)
    with torch.no_grad():
        got = model(xr).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"fuse_conv_bn ResNet-50 224² (batch 8, float32): {t_fuse:.2f}s, "
        f"logits max |fused - unfused| {err:.3e} of max |logit| "
        f"{scale:.3e} (tol {FUSE_REL_TOL} of it)")
    check(np.isfinite(err) and err <= FUSE_REL_TOL * scale,
          "fused ResNet-50's logits equal the unfused ones")
    del model, state, fused
    torch.cuda.empty_cache()
    return counts, exported


AOTI_ITERS = 20               # runs a forward-ms reading of phase 60
# the runner's logits (all 8 x 1000) vs eager's: the package's Inductor
# kernels fuse the elementwise ops around the GEMMs and K1 and round bf16 at
# other places than eager's op-by-op run (3.907e-03 measured over the first
# 16 in bf16, 8.848e-07 in float32). Against the naive attention on the same
# weights the runner is held as phase 3 holds the eager engines: LOGP_TOL
AOTI_LOGIT_TOL = 2e-2
K1_BF16_TOL, LSE_TOL = 2e-2, 1e-3      # phase 2's K1 vs the plain version


def _ramp(dims):
    """The runners' input: 0.001f * (i % 1000) in float32, row-major
    (``native/aoti_runner.cc``, as JAX's ``savedmodel_runner.cc``)."""
    import torch
    n = int(np.prod(dims))
    vals = np.float32(0.001) * (np.arange(n) % 1000).astype(np.float32)
    return torch.from_numpy(vals.reshape(dims))


def _run_runner(runner, package, ops, dims, iters=0, out=None) -> dict:
    """One run of ``aoti_runner``: its parsed lines (output_shape,
    values, launches, forward_ms), its whole first output under "whole"
    when ``out`` names the file it writes, and its wall seconds; raises
    when it exits non-zero."""
    cmd = [str(runner), str(package), str(ops), ",".join(map(str, dims))]
    if iters or out:
        cmd.append(str(iters))
    if out:
        cmd.append(str(out))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"aoti_runner exited {proc.returncode}: {proc.stderr[-3000:]}")
    res = {"wall_s": wall}
    for line in proc.stdout.splitlines():
        key, _, rest = line.partition(":")
        if key == "output_shape":
            res["shape"] = tuple(int(v) for v in rest.split())
        elif key == "values":
            res["values"] = np.array([float(v) for v in rest.split()])
        elif key == "launches":
            res["launches"] = {k: int(v) for k, v in
                               (kv.split("=") for kv in rest.split())}
        elif key == "forward_ms":
            res["forward_ms"] = float(rest)
    if out:
        res["whole"] = np.fromfile(out, np.float32).reshape(res["shape"])
    return res


def _wall_ms(fn, iters: int = AOTI_ITERS, warmup: int = 3) -> float:
    """Mean host-clock ms a call over ``iters`` calls ending in a
    synchronise, after ``warmup`` calls: the runner's own method."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _cpp_ops_child(lib: str, in_path: str, out_path: str) -> int:
    """A process of this script that imports torch only: loads the C++ op
    library and calls its ``dltpu::flash_fwd`` on the card on the views
    ViT-B/16's attention hands K1 (q, k, v sliced from one fused (B, N, 3,
    H, D) qkv, read as (B, H, N, D), ``bnhd``) and on contiguous (B, H, N,
    D) copies of them. Saves each call's outputs with their strides, and
    the library's launch counter."""
    import ctypes
    import torch
    torch.ops.load_library(lib)
    count = ctypes.CDLL(lib).dltpu_launches
    count.argtypes, count.restype = [ctypes.c_char_p], ctypes.c_long
    job = torch.load(in_path)
    qkv = job["qkv"].cuda()
    views = [t.transpose(1, 2) for t in qkv.unbind(2)]
    out = {}
    for bnhd, (q, k, v) in ((True, views),
                            (False, [t.contiguous() for t in views])):
        o, lse = torch.ops.dltpu.flash_fwd(q, k, v, job["scale"], False,
                                           job["hpc"], bnhd)
        torch.cuda.synchronize()
        out[bnhd] = {"o": o.cpu(), "o_stride": tuple(o.stride()),
                     "lse": lse.cpu(), "lse_stride": tuple(lse.stride())}
    out["launches"] = count(b"flash_fwd")
    torch.save(out, out_path)
    return 0


def _cpp_ops_start(ops, workdir, qkv, hpc) -> dict:
    """Starts ``_cpp_ops_child`` on ``qkv`` (its inputs saved first)."""
    import torch
    inp = os.path.join(workdir, "cpp_ops_in.pt")
    out = os.path.join(workdir, "cpp_ops_out.pt")
    torch.save({"qkv": qkv.cpu(), "scale": HEAD_DIM ** -0.5, "hpc": hpc},
               inp)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpp-ops", str(ops),
         inp, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return {"proc": proc, "out": out}


def _cpp_ops_check(fa, run, qkv, hpc) -> float:
    """The C++ registration's K1 forward (``_cpp_ops_child``) against the
    plain version on the same inputs, with the Python op's output strides:
    max |out - plain| (held at phase 2's bf16 tolerance) and max |lse -
    plain| (``LSE_TOL``). Returns the larger output error."""
    import torch
    try:
        text = run["proc"].communicate(timeout=300)[0]
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()
    if run["proc"].returncode != 0:
        log(text[-4000:])
    check(run["proc"].returncode == 0, "the C++ op library's child ran")
    got = torch.load(run["out"])
    views = [t.transpose(1, 2) for t in qkv.unbind(2)]
    want_o, want_lse = fa.flash_attention_reference(*views)
    worst = 0.0
    for bnhd in (True, False):
        q, k, v = views if bnhd else [t.contiguous() for t in views]
        py_o, py_lse = fa._attention(q, k, v, sm_scale=None, causal=False,
                                     heads_per_cta=hpc, bnhd=bnhd)
        g = got[bnhd]
        err = float((g["o"].float() - want_o.float().cpu()).abs().max())
        lse_err = float((g["lse"] - want_lse.cpu()).abs().max())
        strides = (g["o_stride"] == tuple(py_o.stride())
                   and g["lse_stride"] == tuple(py_lse.stride()))
        log(f"C++ dltpu::flash_fwd on the card vs the plain version, "
            f"ViT-B/16's {tuple(q.shape)} bf16, hpc={hpc}, bnhd={bnhd} "
            f"({'views of the fused qkv' if bnhd else 'contiguous'}): out "
            f"{err:.3e} (tol {K1_BF16_TOL}) lse {lse_err:.3e} (tol "
            f"{LSE_TOL}), strides {g['o_stride']} as the Python op's "
            f"{strides}")
        check(np.isfinite(err) and err <= K1_BF16_TOL
              and lse_err <= LSE_TOL and strides,
              f"the C++ registration of K1 (bnhd={bnhd}) disagrees with the "
              f"plain version at ViT-B/16's shape")
        worst = max(worst, err)
    check(got["launches"] == 2, f"the C++ op launched K1 twice, counted "
          f"{got['launches']}")
    return worst


def _aoti_runner(fa, dev, seed, workdir, serving, exported) -> tuple:
    """Phase 60: the serving artifact. ViT-B/16 at batch 8 on flash_hb
    (bf16: phase 59's model, ``exported``) packaged by ``export_savedmodel`` on
    the card (``torch.export``, then AOTInductor), and run by
    ``aoti_runner`` (built by g++ in the background since the script's
    start, with the op library whose CUDA impls launch K1) on the JAX
    runner's ramp: its shape and all its logits against the eager port's
    within ``AOTI_LOGIT_TOL``, its log-probabilities against a naive-
    attention copy of the same weights (the plain path) within
    ``LOGP_TOL``, and 12 ``flash_fwd`` kernel launches through the C++
    registration in its one checked run. Beside the packaging, a process
    that imports torch only holds the C++ registration's K1 forward at
    ViT-B/16's shape against the plain version. Then the forward ms at
    batch 8 (host clock over ``AOTI_ITERS`` runs ending in a synchronise)
    of the runner, phase 59's ``.pt2`` program and eager, in turns. Returns the runner's K1 launches and the C++
    registration's max error against the plain version."""
    import copy
    import shutil
    import torch
    from deeplearning_tpu_torch.export.serialize import export_savedmodel
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    built = serving.result()
    (ops, ops_s), (runner, runner_s) = built["dltpu_ops"], \
        built["aoti_runner"]
    log(f"g++ builds (started with the script): op library {ops_s:.2f}s, "
        f"runner {runner_s:.2f}s; joined after "
        f"{time.perf_counter() - t0:.2f}s of waiting")
    hpc = HPC_FOR["flash_attn_fwd_hb"]
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(EXPORT_BATCH, TOKENS, 3, HEADS, HEAD_DIM, device=dev,
                      generator=g).to(torch.bfloat16)
    cpp_run = _cpp_ops_start(ops, workdir, qkv, hpc)
    model, program = exported["model"], exported["program"]
    dims = (EXPORT_BATCH, 224, 224, 3)
    x = _ramp(dims).to(dev)
    # the plain path: the same weights with the naive attention
    naive = copy.deepcopy(model)
    for m in naive.modules():
        if hasattr(m, "attn_fn"):
            m.attn_fn = get_attn_fn("naive")
    with torch.no_grad():
        want = model(x).float().cpu()
        plain = naive(x).float().cpu()
    del naive
    package = os.path.join(workdir, "vit_b16_flash_hb_aoti.pt2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_savedmodel(model, [x], package)
    t_package = time.perf_counter() - t0
    first = _run_runner(runner, package, ops, dims, iters=AOTI_ITERS,
                        out=os.path.join(workdir, "logits.f32"))
    cpp_err = _cpp_ops_check(fa, cpp_run, qkv, hpc)
    whole = first["whole"]
    err16 = float(np.abs(first["values"] - want.flatten()[:16].numpy()).max())
    err = float(np.abs(whole - want.numpy()).max())
    err_plain = float(np.abs(whole - plain.numpy()).max())
    launches = first["launches"]
    log(f"export_savedmodel ViT-B/16 flash_hb batch {EXPORT_BATCH} "
        f"({str(model.dtype)[6:]}): {t_package:.2f}s, "
        f"{os.path.getsize(package)} bytes; aoti_runner: shape "
        f"{first['shape']}, logits max |runner - eager| over all "
        f"{whole.size} {err:.3e} (first 16: {err16:.3e}; tol "
        f"{AOTI_LOGIT_TOL}), max |runner - naive attention| {err_plain:.3e}, "
        f"launches {json.dumps(launches)}, process {first['wall_s']:.2f}s")
    check(first["shape"] == tuple(want.shape), "the runner's output shape")
    check(np.isfinite(whole).all() and err <= AOTI_LOGIT_TOL
          and err16 <= AOTI_LOGIT_TOL, "the runner's logits equal eager's")
    _compare(torch.from_numpy(whole).softmax(-1).numpy(),
             plain.softmax(-1).numpy(),
             "runner vs the naive attention on the same weights, all rows")
    check(launches == {"flash_fwd": DEPTH, "window_attn": 0,
                       "nms_sweep": 0},
          f"the runner launched K1 {DEPTH} times through dltpu::flash_fwd")
    ms = {"runner": [first["forward_ms"]]}
    with torch.no_grad():
        for name in ("eager", "pt2 program", "pt2 program", "eager",
                     "runner"):
            if name == "runner":
                ms[name].append(_run_runner(runner, package, ops, dims,
                                            iters=AOTI_ITERS)["forward_ms"])
            else:
                fn = model if name == "eager" else program
                ms.setdefault(name, []).append(_wall_ms(lambda: fn(x)))
    log(f"forward ms at batch {EXPORT_BATCH} (host clock, {AOTI_ITERS} "
        f"runs ending in a synchronise, in turns runner, eager, pt2, pt2, "
        f"eager, runner): "
        f"{json.dumps({k: [round(v, 4) for v in vs] for k, vs in ms.items()})}")
    del program, model
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"flash_attn_fwd_hb": launches["flash_fwd"]}, cpp_err


CLI_PREDICT_BATCH = 8          # phase 61: predict's .npz, flip-TTA on K1
CLI_EVAL_IMAGES, CLI_EVAL_BATCH = 64, 32


def _cli_stdout(main, argv) -> list:
    """Run a CLI's ``main(argv)`` in this process; its stdout lines."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"{main.__module__} {' '.join(argv)} exited {rc}")
    return buf.getvalue().splitlines()


def _user_clis(fa, wa, nms_ops, dev, seed, workdir) -> dict:
    """Phase 61: the user CLIs in this process, on the card by default.
    ``predict`` on ViT-B/16 (flash_hb) with ``--tta`` over an ``.npz`` of
    8 images: buckets 1 and 8 warmed and one run, two views each, so
    3 x 2 x 12 K1 launches; its top-5 lines equal an engine's TTA
    probabilities on the same weights. ``demo`` on YOLOX-S at 640² over a
    seeded 480 x 640 PNG at score 0: one K3 launch, the annotated image
    written, one JSON line a detection. ``evaluate`` on ViT-B/16 over 64
    images in batches of 32: 2 x 12 K1 launches, its top-1 / top-5 /
    per-class equal to a loop over the same batches in this script.
    Returns the launches, each CLI counted from zero just before its
    run."""
    import shutil
    import torch
    from PIL import Image
    from deeplearning_tpu_torch import demo, evaluate, hub, predict
    from deeplearning_tpu_torch.evaluation.metrics import (
        confusion_matrix, miou_from_confusion, topk_correct)
    from deeplearning_tpu_torch.ops.tta import classify_tta
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    reset, read = _counters(fa, wa, nms_ops)
    total: dict = {}
    rng = np.random.default_rng(seed + 61)

    # predict: ViT-B/16, flip-TTA, one .npz of 8 images
    x = rng.normal(size=(CLI_PREDICT_BATCH, 224, 224, 3)).astype(np.float32)
    npz = os.path.join(workdir, "vit.npz")
    np.savez(npz, images=x, labels=np.zeros(len(x), np.int32))
    t0 = time.perf_counter()
    reset()
    lines = _cli_stdout(predict.main, [
        "--model", MODEL, "--num-classes", "1000", "--input", npz,
        "--tta", "--topk", "5", "--seed", str(seed)])
    counts = read()
    t_predict = time.perf_counter() - t0
    _add(total, counts)
    model, _ = hub.load(MODEL, num_classes=1000, seed=seed, device=dev,
                        **hub.model_kwargs(MODEL, "flash_hb"))
    with torch.no_grad():
        probs = classify_tta(model, torch.from_numpy(x).to(dev)).cpu().numpy()
    want = [f"image {i}: " + "  ".join(
        f"{int(c)}={p[c]:.4f}" for c in np.argsort(-p)[:5])
        for i, p in enumerate(probs)]
    log(f"predict ViT-B/16 --tta on {len(x)} images: {t_predict:.2f}s, "
        f"launches {json.dumps(counts)}; {lines[0]}")
    check(lines[-len(want):] == want,
          "predict's top-5 lines == the TTA probabilities of the same "
          "weights")
    check(counts == {fa.KERNEL_NAMES[4]: 3 * 2 * DEPTH},
          "predict: K1 launches == 3 forwards x 2 views x 12")

    # demo: YOLOX-S at 640² on a seeded PNG
    src = os.path.join(workdir, "street.png")
    out = os.path.join(workdir, "street_det.png")
    Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
                    ).save(src)
    t0 = time.perf_counter()
    reset()
    lines = _cli_stdout(demo.main, [
        "--model", YOLOX, "--num-classes", str(YOLOX_CLASSES), "--input",
        src, "--out", out, "--size", str(YOLOX_SIZE), "--score", "0.0",
        "--seed", str(seed)])
    counts = read()
    t_demo = time.perf_counter() - t0
    _add(total, counts)
    rows = [json.loads(line) for line in lines[:-1]]
    drawn = np.asarray(Image.open(out))
    log(f"demo YOLOX-S 640² on a 480 x 640 PNG: {t_demo:.2f}s, "
        f"{len(rows)} detections, launches {json.dumps(counts)}; "
        f"{lines[-1]}")
    check(counts == {nms_ops.KERNEL_NAMES[0]: 1}, "demo: one K3 launch")
    check(lines[-1] == f"wrote {out} ({len(rows)} detections)"
          and 0 < len(rows) <= YOLOX_MAX_DET and all(
              np.isfinite(r["box"]).all() for r in rows),
          "demo: finite boxes, one line a detection")
    check(drawn.shape == (480, 640, 3) and not np.array_equal(
        drawn, np.asarray(Image.open(src))), "demo: the boxes were drawn")

    # evaluate: ViT-B/16 over 64 images, batches of 32
    images = rng.normal(size=(CLI_EVAL_IMAGES, 224, 224, 3)).astype(
        np.float32)
    labels = rng.integers(0, 1000, CLI_EVAL_IMAGES).astype(np.int32)
    npz = os.path.join(workdir, "eval.npz")
    np.savez(npz, images=images, labels=labels)
    t0 = time.perf_counter()
    reset()
    lines = _cli_stdout(evaluate.main, [
        "--model", MODEL, "--num-classes", "1000", "--npz", npz,
        "--batch", str(CLI_EVAL_BATCH), "--seed", str(seed)])
    counts = read()
    t_eval = time.perf_counter() - t0
    _add(total, counts)
    got = json.loads(lines[-1])
    hits = {"top1": 0, "top5": 0}
    cm = torch.zeros((1000, 1000), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for s in range(0, CLI_EVAL_IMAGES, CLI_EVAL_BATCH):
            xb = torch.from_numpy(images[s:s + CLI_EVAL_BATCH]).to(dev)
            yb = torch.from_numpy(labels[s:s + CLI_EVAL_BATCH]).to(dev)
            scores = model(xb).float()
            c = topk_correct(scores, yb)
            hits = {k: hits[k] + int(c[k]) for k in hits}
            cm += confusion_matrix(scores.argmax(-1), yb, 1000)
    stats = miou_from_confusion(cm.cpu())
    want = {"top1": round(hits["top1"] / CLI_EVAL_IMAGES, 4),
            "top5": round(hits["top5"] / CLI_EVAL_IMAGES, 4),
            "count": CLI_EVAL_IMAGES,
            "per_class_acc": [round(float(a), 4)
                              for a in stats["class_acc"]]}
    log(f"evaluate ViT-B/16 on {CLI_EVAL_IMAGES} images: {t_eval:.2f}s, "
        f"top1 {got['top1']} top5 {got['top5']}, launches "
        f"{json.dumps(counts)}")
    check(got == want, "evaluate == a loop over the same batches here")
    check(counts == {fa.KERNEL_NAMES[4]: 2 * DEPTH},
          "evaluate: K1 launches == 2 batches x 12")
    del model
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


PAR_RANKS = {45: _sp_rank, 46: _pp_rank, 47: _tp_rank, 48: _tp_seq_rank,
             50: _ep_rank}


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
