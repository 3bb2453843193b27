"""Stereo models of the port: MADNet with MAD online adaptation."""

from . import madnet  # noqa: F401
