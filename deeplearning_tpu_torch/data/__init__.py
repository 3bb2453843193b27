"""Input feed of the port: the counterpart of ``deeplearning_tpu/data``.

This slice has the loader (``loader``), the threaded device feed
(``device_prefetch``), the numpy transforms and samplers (copies of the
JAX package's) and mixup / cutmix on tensors (``mixup``). Datasets,
quarantine, the zip cache and native JPEG decode come with ROADMAP Queue
1 item 5c; COCO, mosaic and the detection transforms with item 5b.
"""

from .device_prefetch import DevicePrefetcher
from .loader import (ArraySource, DataLoader, MapSource, epoch_indices,
                     prefetch_to_device)

__all__ = ["ArraySource", "MapSource", "DataLoader", "DevicePrefetcher",
           "epoch_indices", "prefetch_to_device"]
