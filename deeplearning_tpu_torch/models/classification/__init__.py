"""Classification models of the port: the ViT, Swin and ResNet
families."""

from . import resnet, swin, vit  # noqa: F401
from .resnet import ResNet
from .swin import SwinTransformer
from .vit import VisionTransformer

__all__ = ["ResNet", "SwinTransformer", "VisionTransformer"]
