"""Tensor ops of the port: attention dispatch and the flash-attention
kernel wrappers."""
