"""Segmentation models of the port: U-Net, FCN and DeepLabV3/V3+ on the
ResNet, HRNet (segmentation head) and the few-shot SSPNet."""

from . import fcn_deeplab, fewshot, hrnet, unet  # noqa: F401
