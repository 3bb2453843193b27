"""Helpers of the port: weight conversion from the JAX package's trees
(``convert``) and from torch checkpoints (``torch_import``), the
normalization references, profiling and visualization."""
