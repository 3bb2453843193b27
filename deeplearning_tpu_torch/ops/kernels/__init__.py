"""Building and loading the hand-written CUDA kernels (``csrc/``)."""
