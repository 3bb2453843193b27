"""Classification models of the port: the ViT, Swin and ResNet
families, LeNet, VGG and GoogLeNet, the mobile CNNs, ConvNeXt and CoAtNet,
RepVGG and TransFG."""

from . import (cnns, convnext, lenet, mobile, repvgg, resnet,  # noqa: F401
               swin, transfg, vit)
from .resnet import ResNet
from .swin import SwinTransformer
from .vit import VisionTransformer

__all__ = ["ResNet", "SwinTransformer", "VisionTransformer"]
