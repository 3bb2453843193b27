"""Native host helpers of the port (C++ built with g++, bound with
ctypes): the counterpart of ``deeplearning_tpu/native``. ``imagedec.cpp``
is a copy of the JAX package's libjpeg decode worker, ``cocoeval.cpp`` of
its COCO greedy matcher."""
