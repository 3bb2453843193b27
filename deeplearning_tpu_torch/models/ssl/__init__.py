"""Self-supervised models of the port: MAE on ViT blocks (attention
through K1) and the supervised-contrastive ResNets."""

from . import mae, supcon  # noqa: F401
