"""Top-k accuracy counts — the port of
``deeplearning_tpu/evaluation/metrics.py::topk_correct``. Counts, not
rates, stay on the device: the caller divides by the number of examples
once, on the host. The confusion-matrix, dice and PR-curve helpers come
with the segmentation and detection slices.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["topk_correct"]


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """{"top{k}": int32 count of rows whose label is among the k largest
    logits, ..., "count": rows}."""
    maxk = min(max(ks), logits.shape[-1])
    pred = torch.topk(logits, maxk, dim=-1).indices
    correct = pred == labels[:, None].to(pred.dtype)
    out = {}
    for k in ks:
        k_eff = min(k, maxk)
        out[f"top{k}"] = correct[:, :k_eff].any(dim=-1).sum().to(torch.int32)
    out["count"] = torch.tensor(labels.shape[0], dtype=torch.int32,
                                device=logits.device)
    return out
