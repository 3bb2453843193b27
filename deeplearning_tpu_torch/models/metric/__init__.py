"""Metric-learning models of the port: the Batch-DropBlock re-ID network
and the ArcFace retrieval model."""

from . import bdb  # noqa: F401
