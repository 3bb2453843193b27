"""Native host helpers of the port (C++ built with g++, bound with
ctypes): the counterpart of ``deeplearning_tpu/native``. ``imagedec.cpp``
is a copy of the JAX package's libjpeg decode worker, ``cocoeval.cpp`` of
its COCO greedy matcher; ``my_add.cc`` is the custom-op demo
(``export/custom_op.py``)."""
