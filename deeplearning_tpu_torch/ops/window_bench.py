"""Window-attention (K2) benchmark on the card: the port of
``tools/window_bench.py``. Prints JSON lines and writes no file.

    python -m deeplearning_tpu_torch.ops.window_bench [--tag new] [--wpb 8]

It uses only the public functions of ``ops/window_attention.py``
(``window_attention``, ``window_attention_plain``, ``min_bytes``,
``flops``), of ``ops/window_utils.py`` and ``ops/flash_bench.graph_ms``,
so the same file, copied into another checkout's
``deeplearning_tpu_torch/ops/`` and run there, times that checkout's K2
design on the same inputs: two designs compare in one call, in turns.

At the reference's shapes (Swin-T's four stages at batch 128, Swin-B's
stages 1 and 3 at batch 64; N = 49, d = 32), masked as the models' shifted
blocks are (nW = 64, 16, 4 in stages 1-3; the last stage unmasked), bf16
qkv as strided views of one (BW, N, 3C) projection, made on the card from
``--seed``, it times the kernel, its plain version, the unfused reference
the model runs with ``use_pallas=False`` and ``scaled_dot_product_attention``
with the combined additive mask (a library yardstick the port never
calls), each by CUDA-graph replay (``graph_ms``: device time, no host),
beside the kernel's bound (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s
bf16, at a 700 W power limit). Every line names the card. It needs the
card: without one it raises. A whole Swin-T forward, fused and unfused,
is timed by ``chip_smoke.py`` and ``serve/profile.py``, not here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

import torch

from .flash_bench import graph_ms

__all__ = ["main", "SHAPES"]

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
TOKENS, HEAD_DIM, WINDOW = 49, 32, 7
# (model and stage, batch, windows an image, heads, shift-mask windows or 0
# for none): tools/window_bench.py:39-45, with the models' masks
SHAPES = [
    ("swin_t.1", 128, 64, 3, 64),
    ("swin_t.2", 128, 16, 6, 16),
    ("swin_t.3", 128, 4, 12, 4),
    ("swin_t.4", 128, 1, 24, 0),
    ("swin_b.1", 64, 64, 4, 64),
    ("swin_b.3", 64, 4, 16, 4),
]


def _card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else None}


def stage_inputs(g: torch.Generator, batch: int, wins: int, heads: int,
                 nw: int):
    """qkv (BW, N, 3, heads, d) as a view of one bf16 projection, the bias
    (heads, N, N) and the stage's shift mask (nW, N, N) or None."""
    from .window_utils import shift_window_mask
    bw, c = batch * wins, heads * HEAD_DIM
    qkv = torch.randn(bw, TOKENS, 3 * c, device="cuda", generator=g).to(
        torch.bfloat16).view(bw, TOKENS, 3, heads, HEAD_DIM)
    bias = torch.randn(heads, TOKENS, TOKENS, device="cuda", generator=g)
    mask = None
    if nw:
        side = int(round(nw ** 0.5)) * WINDOW
        mask = torch.from_numpy(shift_window_mask(
            side, side, WINDOW, WINDOW // 2)).cuda()
    return qkv, bias, mask


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wpb", type=int, default=8,
                    help="windows_per_block (the kernel's images a CTA)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="label of this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("window_bench needs a CUDA card")

    from . import window_attention as wa
    from .window_utils import windowed_attention_reference

    card = _card()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for stage, batch, wins, heads, nw in SHAPES:
        qkv, bias, mask = stage_inputs(g, batch, wins, heads, nw)
        bw = qkv.shape[0]
        q, k, v = (x.transpose(1, 2).unflatten(0, (batch, wins))
                   for x in qkv.unbind(2))
        comb = (bias[None] if mask is None
                else bias[None] + mask[:, None]).to(torch.bfloat16)
        out = wa.window_attention(qkv, bias, mask, windows_per_block=args.wpb)
        ref = wa.window_attention_plain(qkv, bias, mask)
        err = (out.float() - ref.float()).abs().max().item()
        nbytes = wa.min_bytes(bw, TOKENS, heads, HEAD_DIM, 2, nw)
        flops = wa.flops(bw, TOKENS, heads, HEAD_DIM)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        kernel_ms = graph_ms(lambda: wa.window_attention(
            qkv, bias, mask, windows_per_block=args.wpb))
        rec = {
            "tag": args.tag, "stage": stage,
            "shape": [bw, TOKENS, heads, HEAD_DIM], "nW": nw,
            "wpb": args.wpb, "kernel_ms": kernel_ms,
            "plain_ms": graph_ms(lambda: wa.window_attention_plain(
                qkv, bias, mask), calls=5, replays=3),
            "reference_ms": graph_ms(lambda: windowed_attention_reference(
                qkv, bias, mask), calls=5, replays=3),
            "sdpa_ms": graph_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    q, k, v, attn_mask=comb)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "x_bound": kernel_ms / max(bytes_ms, ops_ms),
            "max_abs_err_vs_plain": err, **card}
        print(json.dumps(rec), flush=True)
        del qkv, bias, mask, q, k, v, comb, out, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
