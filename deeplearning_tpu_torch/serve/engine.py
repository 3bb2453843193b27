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

Outputs of ``run`` stay on the device (a tensor, or a dict of tensors for
detection); callers materialise them (the batcher's dispatch thread never
synchronises). TTA and int8 weight residency are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["InferenceEngine"]


def _map(fn, out):
    """``fn`` over a tensor or over each value of a detection dict."""
    return {k: fn(v) for k, v in out.items()} if isinstance(out, dict) \
        else fn(out)


class InferenceEngine:
    """A servable model session with per-bucket warmed shapes.

    Build from a registry name (weights from ``seed``, or ``weights``:
    an ``.npz`` of a JAX variable tree), or pass a built module via
    ``model=`` with optional ``variables=`` (a ``state_dict`` or a flax
    tree) — the ``hub.load`` return surface. ``score_thresh``,
    ``max_det``, ``nms_impl`` and ``post_nms_top_n`` (Faster R-CNN's
    proposals) shape a detection engine's postprocess, with the JAX
    defaults.
    """

    def __init__(self, model_name: Optional[str] = None, *,
                 num_classes: int = 1000,
                 weights: Any = None,
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
                 device: Optional[Union[str, torch.device]] = None):
        from ..models.detection.predict import is_detection_model
        if model is None and model_name is None:
            raise ValueError("pass model_name or a prebuilt model")
        if task not in ("auto", "classify", "detect"):
            raise ValueError(f"task must be auto, classify or detect, "
                             f"got {task!r}")
        if tta:
            raise NotImplementedError("test-time augmentation is not "
                                      "ported yet")
        if weight_quant == "int8":
            raise NotImplementedError("int8 weight residency is not "
                                      "ported yet")
        if weight_quant != "fp32":
            raise ValueError(f"weight_quant must be fp32 or int8, "
                             f"got {weight_quant!r}")
        self.name = model_name or type(model).__name__.lower()
        self.task = (("detect" if is_detection_model(self.name)
                      else "classify") if task == "auto" else task)
        if self.task == "detect" and not is_detection_model(self.name):
            raise ValueError(f"no detection predict path for model "
                             f"{self.name!r}")
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
            # them (its predict shifts labels back to 0-based)
            model, _ = hub.load(self.name,
                                num_classes=head_classes(self.name,
                                                         num_classes),
                                weights=weights, seed=seed,
                                device=self.device)
        elif variables is not None or weights is not None:
            from ..utils.convert import as_state_dict
            model.load_state_dict(as_state_dict(
                variables if variables is not None else weights,
                like=model))
        # the session's single resident copy of the weights
        self.model = model.to(self.device).eval()
        self._predict = None
        if self.task == "detect":
            from ..models.detection.predict import build_predict_fn
            self._predict = build_predict_fn(
                self.model, self.name, num_classes,
                score_thresh=score_thresh, max_det=max_det,
                post_nms_top_n=post_nms_top_n, nms_impl=nms_impl)

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
        if self._predict is not None:
            return self._predict(images)
        with torch.no_grad():
            return torch.softmax(self.model(images), dim=-1)

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
        """Resident weight bytes (parameters and buffers)."""
        return int(sum(t.numel() * t.element_size() for t in
                       list(self.model.parameters())
                       + list(self.model.buffers())))

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
            "variables_bytes": self.variables_nbytes(),
            "warmup_seconds": {str(b): round(s, 4)
                               for b, s in self.warmup_seconds.items()},
        }
