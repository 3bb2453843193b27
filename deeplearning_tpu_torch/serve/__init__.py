"""Batched inference serving on the card — the port of
``deeplearning_tpu/serve`` (single model, classification).

    from deeplearning_tpu_torch import serve
    engine = serve.InferenceEngine("vit_base_patch16_224",
                                   batch_buckets=(1, 8, 32))
    with serve.MicroBatcher(engine) as mb:
        probs = mb.submit(image).result(timeout=1.0)   # (224, 224, 3)

CLI: ``python -m deeplearning_tpu_torch.serve --model ... --attn flash_hb``.
"""

from .admission import AdmissionController, DeadlineExceeded, Rejected
from .batcher import MicroBatcher, SubmitHandle
from .engine import InferenceEngine
from .health import DispatchWatch, health
from .telemetry import ServeTelemetry

__all__ = ["InferenceEngine", "MicroBatcher", "SubmitHandle",
           "AdmissionController", "Rejected", "DeadlineExceeded",
           "ServeTelemetry", "health", "DispatchWatch"]
