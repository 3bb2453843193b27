"""Pose models of the port: HRNet keypoint heads."""

from . import hrnet_pose  # noqa: F401
