"""Metric-learning models of the port: the Batch-DropBlock re-ID network
and the ArcFace retrieval model, and the Happy-Whale mask-crop pipeline
(``mask_crop``)."""

from . import bdb, mask_crop  # noqa: F401
