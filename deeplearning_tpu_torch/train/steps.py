"""Train and eval steps — the port of ``deeplearning_tpu/train/steps.py``.

``make_train_step(loss_fn)`` returns ``step(state, batch, rng) ->
(state, metrics)``:

- the step's random stream is ``core.rng.step_key(rng, state.step)``, a
  ``torch.Generator`` on the step's device: the same (key, step) draws the
  same masks;
- ``accum_steps > 1`` splits the batch into that many microbatches and
  averages their float32 gradients, losses and metrics (torch BN updates
  its statistics in place between microbatch forwards, as the JAX scan
  threads them);
- gradients are float32 whatever the compute dtype; ``grad_norm`` is
  their global norm before any clip, ``bad_step`` an int32 flag set when
  the loss is not finite. Every metric stays a tensor on the device: the
  step never calls ``.item()`` and never waits for the card.

It runs on the card (``device`` defaults to ``cuda`` and raises when no
card is visible) unless the caller asks for the CPU. Batches may be
numpy arrays or tensors; they are moved to the step's device. JAX's
``donate`` flags are accepted: the port updates the state in place
anyway. ``mesh``, ``weight_update="zero1"`` and ``grad_comm="int8"`` come
with the multi-GPU slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step"]

LossFn = Callable[..., Tuple[torch.Tensor, Dict]]
_MULTI_GPU = ("come with the multi-GPU slice (ROADMAP Queue 1 item 7)")


def _to_device(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return batch


def _microbatch(batch: Any, accum_steps: int, i: int) -> Any:
    if isinstance(batch, dict):
        return {k: _microbatch(v, accum_steps, i) for k, v in batch.items()}
    micro = batch.shape[0] // accum_steps
    return batch[i * micro:(i + 1) * micro]


def _value_and_grad(loss_fn: LossFn, params: Dict[str, torch.Tensor],
                    state: TrainState, batch: Any, gen: torch.Generator):
    loss, aux = loss_fn(params, state, batch, gen)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    # float32 gradients: the optimizer sees one dtype at every accum_steps
    return loss.detach(), aux, {
        n: (torch.zeros_like(params[n], dtype=torch.float32) if g is None
            else g.float()) for n, g in zip(names, grads)}


def make_train_step(loss_fn: LossFn, mesh: Any = None, accum_steps: int = 1,
                    donate: bool = True, donate_batch: bool = False,
                    weight_update: str = "replicated",
                    grad_comm: str = "fp32", rules: Any = None,
                    comm_block: int = 256,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable[[TrainState, Any, int],
                                  Tuple[TrainState, Dict]]:
    """Build the train step. ``batch`` leaves have a leading batch dim
    divisible by ``accum_steps``; ``rng`` is the run's key
    (``core.rng.root_key(seed)``)."""
    del donate, donate_batch, comm_block
    if weight_update not in ("replicated", "zero1"):
        raise ValueError(f"weight_update must be 'replicated' or 'zero1', "
                         f"got {weight_update!r}")
    if grad_comm not in ("fp32", "int8"):
        raise ValueError(f"grad_comm must be 'fp32' or 'int8', "
                         f"got {grad_comm!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None or rules or weight_update != "replicated" \
            or grad_comm != "fp32":
        raise NotImplementedError(
            f"mesh / rules / weight_update={weight_update!r} / "
            f"grad_comm={grad_comm!r}: sharded training and quantized "
            f"collectives {_MULTI_GPU}")
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch: Any, rng: int
                ) -> Tuple[TrainState, Dict]:
        gen = rng_mod.step_key(rng, state.step, dev)
        batch = _to_device(batch, dev)
        params = state.params
        if accum_steps == 1:
            loss, aux, grads = _value_and_grad(loss_fn, params, state, batch,
                                               gen)
            metrics = {k: v.detach()
                       for k, v in aux.get("metrics", {}).items()}
        else:
            grads, loss, metrics, aux = None, 0.0, {}, {}
            for i in range(accum_steps):
                l, aux, g = _value_and_grad(
                    loss_fn, params, state,
                    _microbatch(batch, accum_steps, i), gen)
                if grads is None:
                    grads = g
                else:
                    names = list(grads)
                    torch._foreach_add_([grads[n] for n in names],
                                        [g[n] for n in names])
                loss = loss + l
                for k, v in aux.get("metrics", {}).items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach()
            names = list(grads)
            torch._foreach_div_([grads[n] for n in names], accum_steps)
            loss = loss / accum_steps
            metrics = {k: v / accum_steps for k, v in metrics.items()}

        state.apply_gradients(grads, aux.get("batch_stats"))
        out = {"loss": loss.float(), **metrics}
        out["grad_norm"] = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads.values()))))
        # device-side divergence flag: read lagged, never synced per step
        out["bad_step"] = (~torch.isfinite(loss)).to(torch.int32)
        return state, out

    return step_fn


def make_eval_step(metric_fn: Callable[..., Dict], mesh: Any = None,
                   use_ema: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[[TrainState, Any], Dict]:
    """``metric_fn(params, state, batch)`` returns per-batch metric SUMS
    (summing, not averaging, lets callers weight by true batch size). The
    EMA params are used when the state keeps them and ``use_ema``."""
    if mesh is not None:
        raise NotImplementedError(f"mesh {_MULTI_GPU}")
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch: Any) -> Dict:
        with torch.no_grad():
            params = state.eval_params if use_ema else state.params
            return metric_fn(params, state, _to_device(batch, dev))

    return step_fn
