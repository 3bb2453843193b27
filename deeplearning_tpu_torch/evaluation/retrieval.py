"""Retrieval metrics: CMC / mAP + k-reciprocal re-ranking — the port's copy
of ``deeplearning_tpu/evaluation/retrieval.py`` (numpy only, so it is
copied as it is).

Surface of metric_learning/BDB trainers/evaluator.py:52 (market1501-style
CMC + mAP over query/gallery with camera-id filtering) and
trainers/re_ranking.py (k-reciprocal encoding re-ranking). All host-side
numpy — these run on gathered embeddings after the forward.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def pairwise_distances(query: np.ndarray, gallery: np.ndarray,
                       metric: str = "euclidean") -> np.ndarray:
    q = np.asarray(query, np.float32)
    g = np.asarray(gallery, np.float32)
    if metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        gn = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
        return 1.0 - qn @ gn.T
    sq = np.sum(q * q, 1, keepdims=True)
    sg = np.sum(g * g, 1, keepdims=True)
    d2 = sq + sg.T - 2.0 * (q @ g.T)
    return np.sqrt(np.clip(d2, 0, None))


def cmc_map(dist: np.ndarray, q_ids: np.ndarray, g_ids: np.ndarray,
            q_cams: Optional[np.ndarray] = None,
            g_cams: Optional[np.ndarray] = None,
            topk: int = 50) -> Dict[str, np.ndarray]:
    """Market-1501 protocol: same-id same-cam gallery entries are removed
    per query (evaluator.py:52 eval_func surface)."""
    nq, ng = dist.shape
    if q_cams is None:
        q_cams = -np.ones(nq, np.int64)
    if g_cams is None:
        g_cams = -2 * np.ones(ng, np.int64)
    order = np.argsort(dist, axis=1, kind="mergesort")
    cmc = np.zeros(topk)
    aps = []
    valid_q = 0
    for qi in range(nq):
        ranked = order[qi]
        remove = (g_ids[ranked] == q_ids[qi]) & \
            (g_cams[ranked] == q_cams[qi])
        kept = ranked[~remove]
        matches = (g_ids[kept] == q_ids[qi]).astype(np.float64)
        if not matches.any():
            continue
        valid_q += 1
        first_hit = int(np.argmax(matches))
        if first_hit < topk:
            cmc[first_hit:] += 1
        # average precision
        hits = np.cumsum(matches)
        precision = hits / (np.arange(len(matches)) + 1)
        aps.append(float(np.sum(precision * matches) / matches.sum()))
    cmc = cmc / max(valid_q, 1)
    return {"cmc": cmc, "rank1": float(cmc[0]), "rank5": float(cmc[4]),
            "mAP": float(np.mean(aps)) if aps else 0.0}


def k_reciprocal_rerank(q_feats: np.ndarray, g_feats: np.ndarray,
                        k1: int = 20, k2: int = 6,
                        lambda_value: float = 0.3) -> np.ndarray:
    """k-reciprocal encoding re-ranking (re_ranking.py surface): Jaccard
    distance over k-reciprocal neighbor sets blended with the original
    distance."""
    feats = np.concatenate([q_feats, g_feats], axis=0).astype(np.float32)
    nq = len(q_feats)
    n = len(feats)
    original = pairwise_distances(feats, feats)
    original = original / np.maximum(original.max(axis=0, keepdims=True),
                                     1e-12)
    rank = np.argsort(original, axis=1, kind="mergesort")

    k1 = min(k1, n - 1)
    recip_sets = []
    for i in range(n):
        forward = rank[i, :k1 + 1]
        backward = rank[forward][:, :k1 + 1]
        recip = forward[np.any(backward == i, axis=1)]
        # expand with half-k1 reciprocal neighbors of the set
        expanded = list(recip)
        half = max(k1 // 2, 1)
        for cand in recip:
            c_fwd = rank[cand, :half + 1]
            c_bwd = rank[c_fwd][:, :half + 1]
            c_recip = c_fwd[np.any(c_bwd == cand, axis=1)]
            if len(np.intersect1d(c_recip, recip)) > 2 / 3 * len(c_recip):
                expanded.extend(c_recip)
        recip_sets.append(np.unique(np.asarray(expanded)))

    weights = np.zeros((n, n), np.float32)
    for i in range(n):
        weights[i, recip_sets[i]] = np.exp(-original[i, recip_sets[i]])
    if k2 > 1:
        weights = np.stack(
            [np.mean(weights[rank[i, :k2]], axis=0) for i in range(n)])
    weights = weights / np.maximum(weights.sum(1, keepdims=True), 1e-12)

    jaccard = np.zeros((nq, n), np.float32)
    for qi in range(nq):
        minimum = np.minimum(weights[qi][None, :], weights).sum(1)
        maximum = np.maximum(weights[qi][None, :], weights).sum(1)
        jaccard[qi] = 1.0 - minimum / np.maximum(maximum, 1e-12)
    final = (1 - lambda_value) * jaccard + lambda_value * original[:nq]
    return final[:, nq:]
