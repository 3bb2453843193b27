"""Classification models of the port (ViT in this slice)."""

from . import vit  # noqa: F401
from .vit import VisionTransformer

__all__ = ["VisionTransformer"]
