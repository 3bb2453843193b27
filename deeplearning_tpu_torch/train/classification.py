"""Classification loss and metric functions — the port of
``deeplearning_tpu/train/classification.py``.

``loss_fn(params, state, batch, rng) -> (loss, aux)`` and
``metric_fn(params, state, batch) -> counts``, as the JAX steps consume
them: integer labels with optional label smoothing, mixup soft targets
(labels with the logits' rank), and models that return
``(logits, aux_logits)`` in train mode (the 0.3-weighted GoogLeNet aux
heads). The forward runs inside ``parallel.moe.collect_moe()``, the
port's harvest of JAX's ``losses`` / ``moe_metrics`` collections: every
model-internal auxiliary loss (a Swin-MoE block's load-balance loss) is
added to the loss, and the MoE layers' routing metrics become
``moe/drop_rate`` and ``moe/capacity_util`` (mean over the layers) and
``moe/max_expert_load`` (max over the layers), device tensors like the
rest.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..evaluation.metrics import topk_correct
from ..ops import losses
from ..parallel.moe import collect_moe
from .state import TrainState

__all__ = ["make_loss_fn", "make_metric_fn"]


def make_loss_fn(label_smoothing: float = 0.0, has_batch_stats: bool = False,
                 aux_weight: float = 0.3):
    def loss_fn(params: Dict[str, torch.Tensor], state: TrainState,
                batch: Dict, rng: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with collect_moe() as sown:
            logits = state.apply_fn(params, batch["image"], train=True,
                                    rng=rng)
        aux: Dict[str, Any] = {}
        if has_batch_stats:   # torch BN updates its buffers in place
            aux["batch_stats"] = dict(state.model.named_buffers())
        aux_logits = ()
        if isinstance(logits, tuple):
            logits, aux_logits = logits
        labels = batch["label"]
        if labels.ndim == logits.ndim:          # mixup soft targets
            loss = losses.soft_target_cross_entropy(logits, labels)
            acc_labels = torch.argmax(labels, -1)
        else:
            loss = losses.cross_entropy(logits, labels, label_smoothing)
            acc_labels = labels
        for a in aux_logits:
            if a is not None and labels.ndim < logits.ndim + 1:
                loss = loss + aux_weight * losses.cross_entropy(
                    a, acc_labels, label_smoothing)
        for al in sown["losses"]:
            loss = loss + al
        acc = (torch.argmax(logits, -1) == acc_labels).float().mean()
        aux["metrics"] = {"accuracy": acc}
        if sown["moe_metrics"]:
            for name in ("drop_rate", "capacity_util", "max_expert_load"):
                vals = torch.stack([m[name] for m in sown["moe_metrics"]])
                aux["metrics"][f"moe/{name}"] = (
                    vals.max() if name == "max_expert_load" else vals.mean())
        return loss, aux
    return loss_fn


def make_metric_fn(ks=(1, 5)):
    def metric_fn(params: Dict[str, torch.Tensor], state: TrainState,
                  batch: Dict) -> Dict[str, torch.Tensor]:
        logits = state.apply_fn(params, batch["image"], train=False)
        counts = topk_correct(logits, batch["label"], ks)
        counts["loss_sum"] = losses.cross_entropy(
            logits, batch["label"]) * batch["label"].shape[0]
        return counts
    return metric_fn
