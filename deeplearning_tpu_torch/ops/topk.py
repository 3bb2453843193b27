"""``jax.lax.top_k`` with its tie order: the k largest values along the
last dim in descending order, equal values in index order (the lower
index first). ``torch.topk`` promises no order among ties, and the
detectors' bf16 heads give many equal scores, so the port's detection
postprocesses all select candidates through ``topk_stable``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["topk_stable"]


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last dim:
    a stable descending sort, then a slice."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
