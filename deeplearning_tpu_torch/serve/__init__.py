"""Batched inference serving on the card — the port of
``deeplearning_tpu/serve``.

    from deeplearning_tpu_torch import serve
    engine = serve.InferenceEngine("vit_base_patch16_224",
                                   batch_buckets=(1, 8, 32))
    with serve.MicroBatcher(engine) as mb:
        probs = mb.submit(image).result(timeout=1.0)   # (224, 224, 3)

Multi-tenant: a ``ModelZoo`` fronts N models in one process (hot
load/evict under device-memory pressure, per-tenant quotas, optional int8
weight residency):

    zoo = serve.ModelZoo()
    zoo.register("vit", "vit_base_patch16_224", attn="flash_hb",
                 batch_buckets=(1, 8))
    with serve.MicroBatcher(zoo=zoo) as mb:
        probs = mb.submit(image, model="vit").result(timeout=30.0)

CLI: ``python -m deeplearning_tpu_torch.serve --model ... --attn flash_hb``
or ``--zoo @spec.json --http PORT``.
"""

from .admission import (AdmissionController, DeadlineExceeded, Rejected,
                        TenantAdmission)
from .batcher import MicroBatcher, SubmitHandle
from .engine import InferenceEngine
from .health import DispatchWatch, health, zoo_health
from .telemetry import ServeTelemetry
from .zoo import ModelSpec, ModelZoo

__all__ = ["InferenceEngine", "MicroBatcher", "SubmitHandle",
           "AdmissionController", "TenantAdmission", "Rejected",
           "DeadlineExceeded", "ServeTelemetry", "health", "zoo_health",
           "DispatchWatch", "ModelZoo", "ModelSpec"]
