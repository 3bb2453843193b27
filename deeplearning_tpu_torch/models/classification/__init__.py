"""Classification models of the port: the ViT and Swin families."""

from . import swin, vit  # noqa: F401
from .swin import SwinTransformer
from .vit import VisionTransformer

__all__ = ["SwinTransformer", "VisionTransformer"]
