"""Genetic hyperparameter evolution (yolov5 ``--evolve`` equivalent) — a
copy of ``deeplearning_tpu/train/evolve.py`` (numpy and json only).

Reference behavior (detection/yolov5/train.py:637-716): keep a results
file across generations; each generation picks a parent from the top-5
previous runs by fitness (weighted random), multiplies each evolvable
hyperparameter by a clipped gaussian gain (mutation prob 0.8, sigma 0.2,
per-gene gain scale from a meta table, clip [0.3, 3.0], retry until
something changes), clamps to per-gene [low, high] bounds, trains, and
appends the result. Fitness for detection is the weighted metric mix
0.1·mAP@50 + 0.9·mAP (utils/metrics.py:15).

Differences here: records are JSONL (one {"fitness", "hyp"} object per
generation — append-only and resumable like evolve.csv), randomness comes
from a caller-seeded ``numpy.random.Generator`` instead of time-seeding,
and the train step is any callable ``hyp -> fitness`` so the same loop
evolves detection, classification, or a unit-test toy identically.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["det_fitness", "mutate", "evolve", "load_records", "best_hyp",
           "DETECTION_META"]

# (mutation gain 0-1, lower, upper) per evolvable hyperparameter — the
# subset of yolov5's meta table (train.py:637-666) that maps onto this
# framework's detection hyps.
DETECTION_META: Dict[str, Tuple[float, float, float]] = {
    "lr": (1.0, 1e-5, 1e-1),
    "final_lr_frac": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_frac": (1.0, 0.0, 0.2),
    "box_gain": (1.0, 0.02, 0.2),
    "cls_gain": (1.0, 0.2, 4.0),
    "obj_gain": (1.0, 0.2, 4.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
}


def det_fitness(metrics: Mapping[str, float]) -> float:
    """0.1·AP50 + 0.9·AP(0.5:0.95) — the reference's model-selection
    score (yolov5 utils/metrics.py:15 fitness, w=[0, 0, 0.1, 0.9]).
    Accepts either this repo's CocoEvaluator keys (AP/AP50) or
    lowercase."""
    ap = metrics.get("AP", metrics.get("ap", 0.0))
    ap50 = metrics.get("AP50", metrics.get("ap50", 0.0))
    return 0.1 * float(ap50) + 0.9 * float(ap)


def load_records(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def best_hyp(path: str) -> Optional[Dict[str, float]]:
    recs = load_records(path)
    if not recs:
        return None
    return max(recs, key=lambda r: r["fitness"])["hyp"]


def _select_parent(records: Sequence[dict],
                   rng: np.random.Generator, top_n: int = 5
                   ) -> Dict[str, float]:
    top = sorted(records, key=lambda r: -r["fitness"])[:top_n]
    fit = np.array([r["fitness"] for r in top])
    w = fit - fit.min() + 1e-6
    idx = rng.choice(len(top), p=w / w.sum())
    return dict(top[idx]["hyp"])


def mutate(hyp: Mapping[str, float],
           meta: Mapping[str, Tuple[float, float, float]],
           rng: np.random.Generator,
           mutation_prob: float = 0.8, sigma: float = 0.2
           ) -> Dict[str, float]:
    """One mutation: multiply each gene by a clipped gaussian gain,
    retrying until at least one gene changes, then clamp to bounds.
    Genes with mutation gain 0 are immutable; if nothing is mutable the
    hyp is returned unchanged (the retry loop could never exit)."""
    keys = [k for k in hyp if k in meta and meta[k][0] > 0]
    if not keys:
        return dict(hyp)
    gains = np.array([meta[k][0] for k in keys])
    v = np.ones(len(keys))
    while np.all(v == 1.0):
        v = (gains * (rng.random(len(keys)) < mutation_prob)
             * rng.standard_normal(len(keys)) * rng.random() * sigma
             + 1.0).clip(0.3, 3.0)
    out = dict(hyp)
    for k, g in zip(keys, v):
        lo, hi = meta[k][1], meta[k][2]
        out[k] = round(float(np.clip(hyp[k] * g, lo, hi)), 5)
    return out


def evolve(eval_fn: Callable[[Dict[str, float]], float],
           hyp0: Mapping[str, float],
           meta: Mapping[str, Tuple[float, float, float]],
           generations: int,
           records_path: str,
           seed: int = 0,
           top_n: int = 5,
           mutation_prob: float = 0.8,
           sigma: float = 0.2) -> Dict[str, float]:
    """Run ``generations`` evolution steps, appending each result to
    ``records_path`` (resumable: existing records seed the parent pool).
    ``eval_fn(hyp) -> fitness`` trains/evaluates one mutation — wrap
    ``det_fitness`` around a detection eval for the reference semantics.
    Returns the best hyp seen (including prior records)."""
    rng = np.random.default_rng(seed)
    records = load_records(records_path)
    os.makedirs(os.path.dirname(records_path) or ".", exist_ok=True)
    for _ in range(generations):
        if records:
            parent = _select_parent(records, rng, top_n)
            hyp = mutate(parent, meta, rng, mutation_prob, sigma)
        else:
            hyp = {k: round(float(v), 5) for k, v in hyp0.items()}
            # clamp the seed hyp too so eval always sees legal values
            for k, (_, lo, hi) in meta.items():
                if k in hyp:
                    hyp[k] = round(float(np.clip(hyp[k], lo, hi)), 5)
        fitness = float(eval_fn(dict(hyp)))
        rec = {"fitness": fitness, "hyp": hyp}
        records.append(rec)
        with open(records_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return best_hyp(records_path)
