"""NMS (K3) benchmark on the card. Prints JSON lines and writes no file.

    python -m deeplearning_tpu_torch.ops.nms_bench [--tag new]

It uses only the public functions of ``ops/nms.py`` (``sort_pad_candidates``,
``nms_sweep``, ``nms``), so the same file, copied into another checkout's
``deeplearning_tpu_torch/ops/`` and run there, times that checkout's K3
design on the same inputs: two designs compare in one call, in turns.

Three workloads, boxes and scores made on the card from ``--seed``:

- ``served``: 32 images of 8 400 candidates (YOLOX-S's batch at 640²),
  overlap-heavy boxes of 80 classes at 640² coordinates, made class-aware
  by offsetting each class as ``batched_nms`` does, threshold 0.65,
  ``max_out`` 100, score threshold 0;
- ``overlap-heavy``: 1 image of 20 000 boxes, threshold 0.5, ``max_out``
  100;
- ``worst``: 1 image of 20 000 boxes that overlap nowhere, ``max_out``
  20 000: every candidate is kept, so a greedy sweep tests each against
  every box kept before it (about 200 M IoUs).

For each: ``sweep_ms``, the device time of ``nms_sweep`` on the sorted,
padded candidates (the K3 launches and the few torch ops around them,
captured in a CUDA graph and replayed); ``call_ms``, the whole ``nms``
call on the card (sort, pad, K3, emit; CUDA events around
back-to-back calls, so host time where the host is slower); ``plain_ms``,
the same call through the plain blocked sweep. Beside them the kept count
and the card's name and power limit. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, List, Optional

import torch

from . import nms as nms_ops
from .flash_bench import graph_ms, time_ms

__all__ = ["main", "workloads", "disjoint_boxes", "past_shared_memory"]

CLASSES, SIZE = 80, 640.0


def _boxes(g: torch.Generator, b: int, n: int, span: float, wh_max: float):
    ctr = torch.rand(b, n, 2, device="cuda", generator=g) * span
    wh = 2.0 + torch.rand(b, n, 2, device="cuda", generator=g) * (
        wh_max - 2.0)
    return torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)


def disjoint_boxes(g: torch.Generator, b: int, n: int) -> torch.Tensor:
    """(b, n, 4) boxes, one inside each cell of a square grid of 10-wide
    cells: no two of an image overlap."""
    side = int(n ** 0.5) + 1
    cell = torch.arange(n, device=g.device)
    corner = torch.stack([cell % side, cell // side], dim=-1).float() * 10.0
    lo = corner + 1.0 + torch.rand(b, n, 2, device=g.device, generator=g)
    hi = lo + 2.0 + 5.0 * torch.rand(b, n, 2, device=g.device, generator=g)
    return torch.cat([lo, hi], dim=-1)


def past_shared_memory(g: torch.Generator, b: int):
    """(b, 13 000, 4) boxes and (b, 13 000) scores whose 12 000 greedy keeps
    an image outnumber the kept boxes K3 holds in shared memory: 12 000
    boxes that overlap nowhere, scored above 1 000 exact copies of the
    10 500th-11 499th of them, which those originals, kept past the shared
    list, must suppress."""
    base = disjoint_boxes(g, b, 12_000)
    scores = 1.0 + torch.rand(b, 12_000, device=g.device, generator=g)
    dup = scores.argsort(dim=1, descending=True)[:, 10_500:11_500]
    copies = base.gather(1, dup[..., None].expand(-1, -1, 4))
    below = torch.rand(b, 1000, device=g.device, generator=g)   # < 1
    return torch.cat([base, copies], dim=1), torch.cat([scores, below],
                                                       dim=1)


def workloads(g: torch.Generator) -> List[dict]:
    cls = torch.randint(0, CLASSES, (32, 8400), device="cuda", generator=g)
    served = nms_ops.class_offset_boxes(
        _boxes(g, 32, 8400, SIZE, 160.0), cls)
    return [
        {"name": "served", "boxes": served,
         "scores": torch.rand(32, 8400, device="cuda", generator=g),
         "th": 0.65, "max_out": 100, "score_threshold": 0.0},
        {"name": "overlap-heavy", "boxes": _boxes(g, 1, 20_000, 64.0, 24.0),
         "scores": torch.rand(1, 20_000, device="cuda", generator=g),
         "th": 0.5, "max_out": 100, "score_threshold": float("-inf")},
        {"name": "worst", "boxes": disjoint_boxes(g, 1, 20_000),
         "scores": torch.rand(1, 20_000, device="cuda", generator=g),
         "th": 0.5, "max_out": 20_000, "score_threshold": float("-inf")},
    ]


def _measure(w: dict) -> dict:
    boxes, scores, th, mo, st = (w[k] for k in ("boxes", "scores", "th",
                                                "max_out",
                                                "score_threshold"))
    sboxes, alive0, _, _ = nms_ops.sort_pad_candidates(boxes, scores, st,
                                                       nms_ops.WORD)
    worst = w["name"] == "worst"
    reps = dict(calls=2, replays=3) if worst else {}
    iters = dict(iters=3, warmup=1) if worst else dict(iters=20, warmup=3)

    def call(impl: str) -> Callable[[], object]:
        return lambda: nms_ops.nms(boxes, scores, th, mo, st, impl=impl)

    alive = nms_ops.nms_sweep(sboxes, alive0, th, mo)
    before = dict(nms_ops.launch_counts())
    sweep = graph_ms(lambda: nms_ops.nms_sweep(sboxes, alive0, th, mo),
                     **reps)
    row = {"workload": w["name"], "images": int(scores.shape[0]),
           "candidates": int(scores.shape[1]), "th": th, "max_out": mo,
           "kernels": sorted(k for k, v in nms_ops.launch_counts().items()
                             if v > before.get(k, 0)),
           "sweep_ms": sweep, "call_ms": time_ms(call("auto"), **iters),
           "plain_ms": time_ms(call("blocked"), **(
               dict(iters=2, warmup=1) if worst else
               dict(iters=5, warmup=1))),
           "kept": int(alive.sum()),
           "live": nms_ops.live_counts(alive0)}
    row["greedy_ious"] = nms_ops.greedy_ious(alive, alive0, mo)
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="a label copied into each line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nms_bench times the CUDA kernels: no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for w in workloads(g):
        row = _measure(w)
        row["live"] = [min(row["live"]), max(row["live"])]
        print(json.dumps({"tag": args.tag, **row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
