"""Mixed-precision policy — the port of ``deeplearning_tpu/core/precision.py``.

Params and optimizer state in float32, activations and matmuls in
bfloat16 (the models' ``dtype``), gradients in float32. bfloat16 keeps
float32's exponent, so no loss scaling is needed; what stays from the
reference's AMP scaler is the gradient norm and clipping.

A "tree" here is what the port keeps parameters in: a dict of tensors
(``dict(model.named_parameters())``), a list, or a single tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["Policy", "get_policy", "global_norm", "clip_by_global_norm",
           "tree_map", "tree_leaves"]


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree: Any) -> Any:
        return tree_map(lambda x: x.to(self.compute_dtype)
                        if x.is_floating_point() else x, tree)

    def cast_to_param(self, tree: Any) -> Any:
        return tree_map(lambda x: x.to(self.param_dtype)
                        if x.is_floating_point() else x, tree)


def get_policy(name: str = "bf16") -> Policy:
    if name in ("bf16", "bfloat16", "mixed"):
        return Policy()
    if name in ("f32", "float32", "full"):
        return Policy(compute_dtype=torch.float32)
    raise ValueError(f"Unknown precision policy {name!r}")


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device; no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: Optional[float]
                        ) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped_tree, pre_clip_norm). ``max_norm`` None or <= 0
    disables clipping but still reports the norm. The scale is
    min(1, max_norm / (norm + 1e-6)), as in the JAX package (optax's
    clip in ``train/optim.py`` uses another formula)."""
    norm = global_norm(tree)
    if not max_norm or max_norm <= 0:
        return tree, norm
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm
