"""Classification models of the port: the ViT, Swin and ResNet
families, LeNet, VGG and GoogLeNet, the mobile CNNs, ConvNeXt and CoAtNet,
RepVGG and TransFG, and the Happy-Whale backbones (Xception,
Inception-v4, DPN, NASNet-A, PolyNet, SENet-154)."""

from . import (cnns, convnext, lenet, mobile, repvgg, resnet,  # noqa: F401
               swin, transfg, vit, zoo_extra)
from .resnet import ResNet
from .swin import SwinTransformer
from .vit import VisionTransformer

__all__ = ["ResNet", "SwinTransformer", "VisionTransformer"]
