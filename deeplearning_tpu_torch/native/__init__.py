"""Native C++ of the port, built with g++ by ``build.py``: the
counterpart of ``deeplearning_tpu/native``. ``imagedec.cpp`` is a copy of
the JAX package's libjpeg decode worker, ``cocoeval.cpp`` of its COCO
greedy matcher; ``my_add.cc`` is the custom-op demo
(``export/custom_op.py``); these three are bound with ctypes.
``dltpu_ops.cpp`` registers the kernel ops (``dltpu::flash_fwd``,
``window_attn``, ``nms_sweep``) from C++, and ``aoti_runner.cc`` runs an
AOTInductor package with them and no Python: the counterpart of
``savedmodel_runner.cc``."""
