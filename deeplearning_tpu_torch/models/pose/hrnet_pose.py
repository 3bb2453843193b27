"""HRNet keypoint (pose) models — the port of
``deeplearning_tpu/models/pose/hrnet_pose.py``: the segmentation
family's HRNet trunk (``models/segmentation/hrnet.py``) with the
keypoint head, heatmaps (B, H/4, W/4, K) at stride 4 in float32. Targets,
decoding and OKS are in ``evaluation/keypoints.py``, the affine crops in
``data/keypoint_transforms.py`` and the loss is
``ops/losses.heatmap_mse_loss``.
"""

from __future__ import annotations

from ...core.registry import MODELS
from ..segmentation.hrnet import HRNet


@MODELS.register("hrnet_w18_keypoints")
def hrnet_w18_keypoints(num_classes: int = 17, **kw):
    """num_classes = number of keypoints (heatmap channels)."""
    return HRNet(num_classes=num_classes, base_width=18, head="keypoints",
                 **kw)


@MODELS.register("hrnet_w48_keypoints")
def hrnet_w48_keypoints(num_classes: int = 17, **kw):
    return HRNet(num_classes=num_classes, base_width=48, head="keypoints",
                 **kw)
