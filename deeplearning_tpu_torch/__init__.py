"""PyTorch/CUDA port of ``deeplearning_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports none of
it. Subpackages mirror the JAX package's so every module has one obvious
counterpart (``core``, ``ops``, ``models``, ``serve``, ``obs``,
``elastic``, ``utils``, ``hub``). Hand-written CUDA kernels live in
``csrc/`` and are built with nvcc at first use
(``ops/kernels/build.py``). Importing the package builds nothing and
touches no device.
"""

__version__ = "0.1.0"
