"""Sampling strategies: identity PK, aspect-ratio grouping, infinite.

A copy of ``deeplearning_tpu/data/samplers.py`` (numpy only), kept in the
port so it imports nothing of the JAX package; the same
``np.random.Generator`` gives the same outputs in both.

Surface of the reference's sampler zoo: BDB's identity PK sampler
(metric_learning/BDB/data/samplers.py — P identities × K instances per
batch for triplet mining), fasterRcnn's GroupedBatchSampler
(utils/group_by_aspect_ratio.py:23 — batches of similar aspect ratio to
minimize pad waste), YOLOX's InfiniteSampler (yolox/data/samplers.py).
All emit numpy index arrays that plug into DataLoader via a custom
epoch-indices hook or direct batch iteration.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Sequence

import numpy as np


def pk_batches(labels: np.ndarray, p: int, k: int, *, seed: int = 0,
               epoch: int = 0) -> np.ndarray:
    """(num_batches, P*K) index batches: P random identities × K samples
    each (with replacement when an identity has < K)."""
    rng = np.random.default_rng((seed, epoch))
    by_id: Dict[int, np.ndarray] = defaultdict(list)
    for i, lab in enumerate(np.asarray(labels)):
        by_id[int(lab)].append(i)
    ids = [i for i, idxs in by_id.items() if len(idxs) >= 1]
    rng.shuffle(ids)
    n_batches = max(len(ids) // p, 1)
    batches = []
    for b in range(n_batches):
        chosen = list(ids[b * p:(b + 1) * p])
        if len(chosen) < p:
            # top up from identities not already in the batch; only reuse
            # identities when the dataset has fewer than P of them
            pool = [i for i in ids if i not in chosen]
            need = p - len(chosen)
            if pool:
                take = min(need, len(pool))
                chosen += list(rng.choice(pool, take, replace=False))
                need -= take
            if need > 0:
                chosen += list(rng.choice(ids, need, replace=True))
        batch = []
        for ident in chosen:
            pool = np.asarray(by_id[ident])
            batch.extend(rng.choice(pool, k, replace=len(pool) < k))
        batches.append(np.asarray(batch))
    return np.stack(batches)


def aspect_ratio_groups(aspect_ratios: Sequence[float], n_groups: int = 2
                        ) -> np.ndarray:
    """Group id per sample by aspect-ratio quantile bins
    (group_by_aspect_ratio surface)."""
    ar = np.asarray(aspect_ratios, np.float64)
    edges = np.quantile(ar, np.linspace(0, 1, n_groups + 1)[1:-1]) \
        if n_groups > 1 else np.asarray([])
    return np.searchsorted(edges, ar)


def grouped_batches(aspect_ratios: Sequence[float], batch_size: int, *,
                    n_groups: int = 2, seed: int = 0, epoch: int = 0
                    ) -> np.ndarray:
    """(num_batches, batch_size) indices where every batch comes from one
    aspect-ratio group (drops the ragged remainder per group)."""
    rng = np.random.default_rng((seed, epoch))
    groups = aspect_ratio_groups(aspect_ratios, n_groups)
    batches = []
    for g in np.unique(groups):
        idx = np.where(groups == g)[0]
        rng.shuffle(idx)
        for start in range(0, len(idx) - batch_size + 1, batch_size):
            batches.append(idx[start:start + batch_size])
    order = rng.permutation(len(batches))
    return np.stack([batches[i] for i in order]) if batches else \
        np.zeros((0, batch_size), np.int64)


def infinite_indices(size: int, *, seed: int = 0) -> Iterator[int]:
    """Endless shuffled index stream (InfiniteSampler surface)."""
    epoch = 0
    while True:
        rng = np.random.default_rng((seed, epoch))
        yield from rng.permutation(size)
        epoch += 1
