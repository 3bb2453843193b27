"""Train-step benchmark of the port (ViT-B/16 by default): one JSON line.

    python -m deeplearning_tpu_torch.train.bench              # flash_hb, batch 128
    python -m deeplearning_tpu_torch.train.bench --attn naive
    python -m deeplearning_tpu_torch.train.bench --model \
        swin_tiny_patch4_window7_224          # the fused window-attention kernel
    python -m deeplearning_tpu_torch.train.bench --device cpu --model \
        vit_micro_patch4_56 --depth 1 --batch 2 --steps 1     # a CPU smoke

The counterpart of the JAX package's ``bench.py`` train record and
``tools/mfu_push.py``: the same step (``make_train_step(make_loss_fn(
label_smoothing=0.1))``), AdamW with weight decay 0.05 under warmup-cosine
(base 1e-3, 10 000 steps, 100 warmup), random images and labels from
``--seed``. One warmup step, then ``--steps`` timed steps ending in
``torch.cuda.synchronize()``. Any registered ViT or Swin classifier runs:
``--attn`` picks a ViT's attention, or a Swin model's window attention
(naive: unfused; a flash name: the fused kernel), and ``--size`` the input
(default: the model's own, 224 for ViT-B/16 and Swin-T).

MFU is the analytic step FLOPs (3 x the forward's matmul and attention
products, counted from the model's shapes: ~1.35e13 for ViT-B/16 and
~3.45e12 for Swin-T at batch 128) over the H100 SXM dense bf16 peak (989
TFLOP/s). On the CPU the line carries ``value: null``: a CPU time is no
device measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..core.precision import tree_leaves

__all__ = ["main", "vit_forward_flops", "swin_forward_flops",
           "forward_flops", "PEAK_BF16_FLOPS"]

PEAK_BF16_FLOPS = 989e12     # H100 SXM data sheet, dense bf16, 700 W


def vit_forward_flops(model: nn.Module, batch: int) -> float:
    """Operations of one forward of a VisionTransformer at ``batch``: every
    Linear's product (2 per multiply-add) at the token count it sees, and
    the two attention products of every block."""
    n_patch = model.pos_embed.shape[1] - 1
    tokens = n_patch + 1
    total = 0.0

    def linear(layer: nn.Linear, rows: int) -> float:
        return 2.0 * rows * layer.in_features * layer.out_features

    total += linear(model.patch_embed.proj, n_patch)
    for block in model.blocks:
        attn = block.attn
        for layer in (attn.qkv, attn.proj, block.mlp.fc1, block.mlp.fc2):
            total += linear(layer, tokens)
        dim = attn.qkv.in_features
        total += 4.0 * tokens * tokens * dim      # S = QK^T and PV, all heads
    if model.pre_logits is not None:
        total += linear(model.pre_logits, 1)
    total += linear(model.head, 1)
    return total * batch


def swin_forward_flops(model: nn.Module, batch: int, size: int) -> float:
    """Operations of one forward of a SwinTransformer on ``size``² images at
    ``batch``: every Linear's product at the token count it sees, the two
    window-attention products of every block (4·N²·C per window: 4·tokens·
    N·C a stage), Swin-MLP's token mix over the padded grid, and the
    PatchMerging reductions. v2's position-bias MLP runs once a forward,
    not once an image."""
    from ..models.classification.swin import PatchMerging, SwinMLPBlock

    def linear(layer: nn.Linear, rows: int) -> float:
        return 2.0 * rows * layer.in_features * layer.out_features

    h = w = size // model.patch_size
    total = linear(model.patch_embed, h * w)
    per_forward = 0.0
    for blk in model.stages():
        if isinstance(blk, PatchMerging):
            h, w = h // 2, w // 2
            total += linear(blk.reduction, h * w)
            continue
        tokens, n = h * w, blk.window * blk.window
        dim = blk.mlp.fc1.in_features
        if isinstance(blk, SwinMLPBlock):
            pad = blk.window if blk.shift else 0
            total += 2.0 * (h + pad) * (w + pad) * n * dim
        else:
            attn = blk.attn
            total += linear(attn.qkv, tokens) + linear(attn.proj, tokens)
            total += 4.0 * tokens * n * dim
            if attn.v2:
                rows = (2 * blk.window - 1) ** 2
                per_forward += linear(attn.cpb_fc1, rows) \
                    + linear(attn.cpb_fc2, rows)
        total += linear(blk.mlp.fc1, tokens) + linear(blk.mlp.fc2, tokens)
    total += linear(model.head, 1)
    return total * batch + per_forward


def forward_flops(model: nn.Module, batch: int, size: int) -> float:
    """``vit_forward_flops`` or ``swin_forward_flops``, by the model's kind."""
    from ..models.classification.swin import SwinTransformer
    if isinstance(model, SwinTransformer):
        return swin_forward_flops(model, batch, size)
    return vit_forward_flops(model, batch)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attn", default="flash_hb",
                    choices=["naive", "flash", "flash_hb", "sdpa"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; raises when no card is visible")
    ap.add_argument("--model", default="vit_base_patch16_224")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut a ViT's depth (a smoke run); full depth by "
                         "default")
    ap.add_argument("--size", type=int, default=None,
                    help="input size; default: the model's own (224 for "
                         "ViT-B/16 and Swin-T)")
    args = ap.parse_args(argv)

    from .. import models  # noqa: F401  (registers the factories)
    from ..core.registry import MODELS
    from ..hub import model_kwargs
    from ..models.classification.swin import SwinTransformer
    from .classification import make_loss_fn
    from .optim import build_optimizer
    from .schedules import build_schedule
    from .state import TrainState
    from .steps import make_train_step

    dev = resolve_device(args.device)
    kw = model_kwargs(args.model, args.attn, args.size)
    if args.depth is not None:
        kw["depth"] = args.depth
    model = MODELS.build(args.model, num_classes=1000, remat=args.remat,
                         generator=torch.Generator().manual_seed(args.seed),
                         **kw).to(dev)
    sched = build_schedule("warmup_cosine", base_lr=1e-3,
                           total_steps=10_000, warmup_steps=100)
    params = dict(model.named_parameters())
    tx = build_optimizer("adamw", sched, weight_decay=0.05, params=params)
    state = TrainState.create(model=model, tx=tx)
    opt_state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(state.opt_state))

    size = model.img_size
    data = np.random.default_rng(args.seed)
    batch = {"image": torch.from_numpy(data.normal(
                 size=(args.batch, size, size, 3)).astype(np.float32)),
             "label": torch.from_numpy(data.integers(
                 0, 1000, args.batch).astype(np.int64))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    key = rng_mod.root_key(args.seed)
    step = make_train_step(make_loss_fn(label_smoothing=0.1), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, metrics = step(state, batch, key)          # warmup
    loss0 = float(metrics["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch, key)
    sync()
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    loss1 = float(metrics["loss"])
    if not (np.isfinite(loss0) and np.isfinite(loss1)):
        raise RuntimeError(f"non-finite loss: {loss0} -> {loss1}")

    step_flops = 3.0 * forward_flops(model, args.batch, size)
    on_card = dev.type == "cuda"
    rec = {
        "metric": ("swin_t_train_mfu" if isinstance(model, SwinTransformer)
                   else "vit_b16_train_mfu"),
        "value": (round(step_flops / dt / PEAK_BF16_FLOPS * 100.0, 2)
                  if on_card else None),
        "unit": "%",
        "images_per_sec": round(args.batch / dt, 1),
        "step_time_ms": round(dt * 1e3, 2),
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else str(dev)),
        "batch": args.batch,
        "attn": args.attn,
        "remat": args.remat,
        "model": args.model,
        "size": size,
        "step_flops": step_flops,
        "loss0": round(loss0, 4),
        "loss1": round(loss1, 4),
        "opt_state_bytes_per_device": opt_state_bytes,
    }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
