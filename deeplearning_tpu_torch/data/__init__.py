"""Input feed of the port: the counterpart of ``deeplearning_tpu/data``.

The loader with its bad-sample quarantine (``loader``, ``quarantine``),
the threaded device feed (``device_prefetch``), the numpy transforms and
samplers (copies of the JAX package's), mixup / cutmix on tensors
(``mixup``), class-folder datasets (``datasets``), the zip source and
memmap cache (``zip_cache``), the native libjpeg decode
(``native_decode``), the folder-loader builder (``build``), the COCO
detection source (``coco``) and the annotation converters
(``label_convert``). Mosaic and random perspective come with ROADMAP
Queue 1 item 5d.
"""

from .device_prefetch import DevicePrefetcher
from .loader import (ArraySource, DataLoader, MapSource, epoch_indices,
                     prefetch_to_device)
from .quarantine import PoisonedData, QuarantineLog, quarantinable

__all__ = ["ArraySource", "MapSource", "DataLoader", "DevicePrefetcher",
           "epoch_indices", "prefetch_to_device", "PoisonedData",
           "QuarantineLog", "quarantinable"]
