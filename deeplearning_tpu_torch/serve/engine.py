"""InferenceEngine: one model session on the card, bucketed batch shapes.

The port of ``deeplearning_tpu/serve/engine.py``, for ``task="classify"``
and ``task="detect"`` (picked from the registry name when ``task="auto"``,
as in JAX):

- **One session.** The model is built (registry + seed or weights) and
  moved to the device once; every request runs against those resident
  weights.
- **Bucketed static shapes.** Requests only ever run at a fixed set of
  padded batch sizes (default 1/8/32/128 × one image size), as in JAX.
- **Warmup.** PyTorch runs eagerly, so there is no executable to
  compile; ``warmup()`` runs every bucket once on the card instead, which
  builds the CUDA kernels (first use) and warms the caching allocator, so
  the first request pays neither.
- **Counters as contract.** ``trace_count`` counts forward builds (the
  first run of a bucket) and ``compile_count`` warmed buckets; a
  steady-state serve loop leaves both at ``len(buckets)``, and ``warm``
  means what it means in JAX.

A detection engine runs its family's postprocess
(``models/detection/predict.build_predict_fn``) after the forward, so an
answer is ``max_det`` rows of {boxes, scores, labels, valid}, never raw
heads; padded slots carry label −1. Every NMS of a batch on the card is
one K3 launch (``ops/nms.py``; Faster R-CNN makes two, proposals and
detections). All five families are ported (RetinaNet, FCOS, Faster
R-CNN, YOLOv5, YOLOX); ``task="detect"`` for a name of no family raises
``ValueError``, as the JAX predict builder does.

**int8 weight residency** (``weight_quant="int8"``, as in JAX): every
floating leaf of the model's flax variable tree with at least 1 024
elements (kernels, biases of wide layers, BatchNorm statistics) is stored
as block-scaled int8 (``parallel/collectives.py``: 256-element blocks cut
over the leaf's flax element order, so the blocks and scales are JAX's),
about 3.9× denser than float32. The payloads live in one flat int8 buffer
and the scales in one float32 buffer; each forward dequantizes them in one
launch into a flat float32 transient and runs the model on views of it
(``torch.func.functional_call``). Smaller leaves and the port's constant
buffers stay float32. ``variables_nbytes()`` is the resident footprint of
the variables, the quantized one under int8.

**Checkpoints and TTA.** ``ckpt`` restores a checkpoint of the port
through ``hub.load`` (``core.checkpoint.restore_variables``: the EMA
weights first, the BatchNorm statistics from the checkpoint). ``tta=True``
serves a classifier's flip-TTA (``ops/tta.classify_tta``: the mean of the
softmax over the identity and a horizontal flip), two forwards a batch;
a detector's TTA is ``ops/tta.yolox_tta``, which the detection CLI's
``train.eval_tta`` runs, and ``tta=True`` on a detection engine raises.

Outputs of ``run`` stay on the device (a tensor, or a dict of tensors for
detection); callers materialise them (the batcher's dispatch thread never
synchronises).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.convert import variable_names

__all__ = ["InferenceEngine"]

# as JAX's engine: 256-element blocks, one scale each; leaves below 1 024
# elements (biases, norm scales) stay float32
_QUANT_BLOCK = 256
_QUANT_MIN_SIZE = 1024


def _map(fn, out):
    """``fn`` over a tensor or over each value of a detection dict."""
    return {k: fn(v) for k, v in out.items()} if isinstance(out, dict) \
        else fn(out)


class _Int8Weights:
    """A model's large variables as block-scaled int8: one flat int8
    payload, one float32 scale a block, and where each leaf's blocks
    start. Building it quantizes on the CPU (the same arithmetic on every
    device) and strips the quantized tensors out of ``model``, so only the
    payloads stay resident once ``to(device)`` moves them."""

    def __init__(self, model: torch.nn.Module):
        from ..parallel.collectives import _pad_to, _quantize_blocks
        from ..utils.convert import to_flax_order
        state = model.state_dict()
        payloads, scales = [], []
        self.leaves = []            # (name, first element, size, shape)
        start = 0
        for name in variable_names(model):
            t = state[name]
            if not t.is_floating_point() or t.numel() < _QUANT_MIN_SIZE:
                continue
            flat = to_flax_order(name, t.detach()).to(
                "cpu", torch.float32).reshape(-1)
            flat, _ = _pad_to(flat, _QUANT_BLOCK)
            q, s = _quantize_blocks(flat.view(-1, _QUANT_BLOCK))
            payloads.append(q)
            scales.append(s)
            self.leaves.append((name, start, t.numel(), tuple(t.shape)))
            start += q.numel()
        self.q = torch.cat(payloads)                  # (blocks, 256) int8
        self.s = torch.cat(scales)                    # (blocks, 1) float32
        for name, *_ in self.leaves:
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            empty = torch.empty(0, device=state[name].device)
            setattr(module, leaf, torch.nn.Parameter(empty, False)
                    if leaf in module._parameters else empty)

    def to(self, device: torch.device) -> None:
        self.q, self.s = self.q.to(device), self.s.to(device)

    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.s.numel()

    def dequantize(self) -> Dict[str, torch.Tensor]:
        """{name: float32 view in the port's layout} of one transient: the
        dequantize is one launch whatever the number of leaves."""
        from ..utils.convert import from_flax_order
        flat = (self.q * self.s).view(-1)
        return {name: from_flax_order(name, flat[i:i + n], shape)
                for name, i, n, shape in self.leaves}


def _classify(model: torch.nn.Module, tta: bool):
    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if tta:
                from ..ops.tta import classify_tta
                return classify_tta(model, images)
            return torch.softmax(model(images), dim=-1)
    return forward


class _Forward(torch.nn.Module):
    """The engine's forward as a module over the served model, so that
    ``functional_call`` puts the dequantized views in for one call. It
    holds no reference to the engine: an evicted engine is freed at once,
    with no cycle to wait for."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, images: torch.Tensor) -> Any:
        return self.fn(images)


class InferenceEngine:
    """A servable model session with per-bucket warmed shapes.

    Build from a registry name (weights from ``seed``, ``weights``: an
    ``.npz`` of a JAX variable tree, or ``ckpt``: a checkpoint of the
    port), or pass a built module via ``model=`` with optional
    ``variables=`` (a ``state_dict`` or a flax tree) or ``ckpt`` — the
    ``hub.load`` return surface. ``score_thresh``,
    ``max_det``, ``nms_impl`` and ``post_nms_top_n`` (Faster R-CNN's
    proposals) shape a detection engine's postprocess, with the JAX
    defaults. ``attn`` (a registry-name build only) picks the attention
    as the serve CLI's ``--attn`` does (``hub.model_kwargs``; the model
    is then built at ``image_size``); None keeps the factory's default.
    """

    def __init__(self, model_name: Optional[str] = None, *,
                 num_classes: int = 1000,
                 weights: Any = None,
                 ckpt: Optional[str] = None,
                 image_size: int = 224,
                 batch_buckets: Sequence[int] = (1, 8, 32, 128),
                 task: str = "auto",
                 model: Optional[torch.nn.Module] = None,
                 variables: Any = None,
                 tta: bool = False,
                 score_thresh: float = 0.05,
                 max_det: int = 100,
                 nms_impl: str = "auto",
                 post_nms_top_n: int = 256,
                 seed: int = 0,
                 precompile: bool = True,
                 weight_quant: str = "fp32",
                 attn: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        from ..models.detection.predict import is_detection_model
        if model is None and model_name is None:
            raise ValueError("pass model_name or a prebuilt model")
        if task not in ("auto", "classify", "detect"):
            raise ValueError(f"task must be auto, classify or detect, "
                             f"got {task!r}")
        if weight_quant not in ("fp32", "int8"):
            raise ValueError(f"weight_quant must be fp32 or int8, "
                             f"got {weight_quant!r}")
        self.name = model_name or type(model).__name__.lower()
        self.task = (("detect" if is_detection_model(self.name)
                      else "classify") if task == "auto" else task)
        if tta and self.task == "detect":
            raise ValueError("tta=True is a classifier's flip-TTA; a "
                             "detector's is ops.tta.yolox_tta (the "
                             "detection CLI's train.eval_tta)")
        if self.task == "detect" and not is_detection_model(self.name):
            raise ValueError(f"no detection predict path for model "
                             f"{self.name!r}")
        self.tta = tta
        self.score_thresh = score_thresh
        self.max_det = max_det
        self.nms_impl = nms_impl
        self.post_nms_top_n = post_nms_top_n
        self.weight_quant = weight_quant
        self.num_classes = num_classes
        self.image_size = int(image_size)
        self.buckets: Tuple[int, ...] = tuple(
            sorted({int(b) for b in batch_buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad batch_buckets {batch_buckets!r}")
        self.device = resolve_device(device)

        if model is None:
            from .. import hub
            from ..models.detection.predict import head_classes
            # Faster R-CNN's head carries class 0 = background besides
            # them (its predict shifts labels back to 0-based); built on
            # the CPU, moved below
            model_kw = ({} if attn is None else
                        hub.model_kwargs(self.name, attn, self.image_size))
            model, _ = hub.load(self.name,
                                num_classes=head_classes(self.name,
                                                         num_classes),
                                weights=weights, ckpt=ckpt, seed=seed,
                                device="cpu", **model_kw)
        else:
            if weight_quant == "int8":
                # the int8 session strips its model: keep the caller's
                model = copy.deepcopy(model)
            if variables is not None or weights is not None:
                from ..utils.convert import as_state_dict
                model.load_state_dict(as_state_dict(
                    variables if variables is not None else weights,
                    like=model))
            elif ckpt:
                from ..core.checkpoint import restore_variables
                model.load_state_dict(restore_variables(
                    ckpt, model.state_dict()))
        self._int8 = (_Int8Weights(model) if weight_quant == "int8"
                      else None)
        # the session's single resident copy of the weights (the int8
        # payloads and scales in place of the large ones under int8), in
        # a memory pool of its own on the card: dropping the engine leaves
        # whole segments free, which torch.cuda.empty_cache hands back (a
        # zoo eviction lowers mem_get_info's reading by the tenant's
        # bytes, however the caching allocator placed other blocks)
        self._pool = (torch.cuda.MemPool() if self.device.type == "cuda"
                      else None)
        with (torch.cuda.use_mem_pool(self._pool, self.device.index)
              if self._pool is not None else contextlib.nullcontext()):
            self.model = model.to(self.device).eval()
            if self._int8 is not None:
                self._int8.to(self.device)
        self._predict = None
        if self.task == "detect":
            from ..models.detection.predict import build_predict_fn
            self._predict = build_predict_fn(
                self.model, self.name, num_classes,
                score_thresh=score_thresh, max_det=max_det,
                post_nms_top_n=post_nms_top_n, nms_impl=nms_impl)
        self._runner = _Forward(self.model, self._predict
                                or _classify(self.model, tta))

        # counters: the "no new work after warmup" test surface
        self.trace_count = 0        # first forward of a bucket
        self.compile_count = 0      # buckets warmed
        self.warmup_seconds: Dict[int, float] = {}
        self._warm: set = set()
        self._warm_lock = threading.Lock()
        if precompile:
            self.warmup()

    # ------------------------------------------------------- forward fn
    def _forward(self, images: torch.Tensor) -> Any:
        if self._int8 is None:
            return self._runner(images)
        with torch.no_grad():
            views = {f"model.{k}": v
                     for k, v in self._int8.dequantize().items()}
            return torch.func.functional_call(self._runner, views,
                                              (images,))

    # --------------------------------------------------------- buckets
    def bucket_for(self, n: int) -> int:
        """Smallest bucket admitting ``n`` requests (largest bucket for
        oversize batches — callers chunk, see ``infer``)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _warm_bucket(self, bucket: int) -> None:
        with self._warm_lock:
            if bucket in self._warm:
                return
            t0 = time.perf_counter()
            size = self.image_size
            self._forward(torch.zeros((bucket, size, size, 3),
                                      device=self.device))
            self.trace_count += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.warmup_seconds[bucket] = time.perf_counter() - t0
            self._warm.add(bucket)
            self.compile_count += 1

    def warmup(self) -> Dict[int, float]:
        """Run every bucket once (idempotent); returns {bucket: seconds}."""
        for b in self.buckets:
            self._warm_bucket(b)
        return {b: self.warmup_seconds[b] for b in self.buckets}

    # ------------------------------------------------------- execution
    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device, torch.float32)
        host = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        if self.device.type == "cuda":
            # pinned staging: the copy is asynchronous, so the calling
            # (dispatch) thread never waits on the card here
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def run(self, bucket: int, images) -> Any:
        """Run one bucket on an exactly-``bucket``-row batch; returns DEVICE
        probabilities, or for detection a dict of DEVICE tensors {boxes
        (bucket, max_det, 4), scores, labels, valid} (no synchronisation —
        callers materialise)."""
        if bucket not in self.buckets:
            raise ValueError(f"unknown bucket {bucket} "
                             f"(have {self.buckets})")
        if images.shape[0] != bucket:
            raise ValueError(f"bucket {bucket} fed {images.shape[0]} rows")
        if bucket not in self._warm:
            self._warm_bucket(bucket)
        return self._forward(self._to_device(images))

    def pad_to_bucket(self, images: np.ndarray,
                      bucket: int) -> np.ndarray:
        """Zero-pad rows up to ``bucket`` (padded rows are sliced away
        before any caller sees them)."""
        n = images.shape[0]
        if n == bucket:
            return images
        pad = np.zeros((bucket - n, *images.shape[1:]), images.dtype)
        return np.concatenate([images, pad], axis=0)

    def infer(self, images, materialize: bool = True) -> Any:
        """Synchronous batched inference for ad-hoc callers: pads to the
        smallest admitting bucket, runs, slices padding away; oversize
        inputs chunk through the largest bucket. The dynamic-batching
        request path is ``serve.batcher.MicroBatcher``."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        big = self.buckets[-1]
        outs = []
        for start in range(0, n, big):
            chunk = images[start:start + big]
            bucket = self.bucket_for(chunk.shape[0])
            out = self.run(bucket, self.pad_to_bucket(chunk, bucket))
            outs.append(_map(lambda t: t[:chunk.shape[0]], out))
        if len(outs) == 1:
            out = outs[0]
        elif isinstance(outs[0], dict):
            out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        else:
            out = torch.cat(outs, dim=0)
        return _map(lambda t: t.cpu().numpy(), out) if materialize else out

    # ------------------------------------------------------ introspection
    def variables_nbytes(self) -> int:
        """Resident bytes of the model's variables (the leaves of its flax
        tree: parameters and BatchNorm statistics), as the JAX engine
        counts them; under int8 the payloads and scales in place of the
        quantized leaves. Host metadata only, never a sync."""
        state = self.model.state_dict()
        plain = sum(state[n].numel() * state[n].element_size()
                    for n in variable_names(self.model))
        return int(plain + (self._int8.nbytes() if self._int8 else 0))

    def dequantized_state_dict(self) -> Dict[str, torch.Tensor]:
        """The variables each forward runs on, by ``state_dict`` name: the
        int8 leaves dequantized (a fresh transient), the rest as held."""
        state = self.model.state_dict()
        out = {n: state[n] for n in variable_names(self.model)}
        if self._int8 is not None:
            with torch.no_grad():
                out.update(self._int8.dequantize())
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "model": self.name,
            "task": self.task,
            **({"score_thresh": self.score_thresh, "max_det": self.max_det,
                "nms_impl": self.nms_impl} if self.task == "detect" else {}),
            "device": str(self.device),
            "image_size": self.image_size,
            "buckets": list(self.buckets),
            "trace_count": self.trace_count,
            "compile_count": self.compile_count,
            "warm": self.compile_count >= len(self.buckets),
            "weight_quant": self.weight_quant,
            "tta": self.tta,
            "variables_bytes": self.variables_nbytes(),
            "warmup_seconds": {str(b): round(s, 4)
                               for b, s in self.warmup_seconds.items()},
        }
