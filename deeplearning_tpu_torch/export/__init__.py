"""Export of the port — the counterpart of ``deeplearning_tpu/export``:
``serialize`` (``.pt2`` through ``torch.export``, FLOPs), ``onnx`` (the
port's own ONNX writer and evaluator), ``fuse`` (Conv + BatchNorm
folding), ``custom_op`` (the ``my_add`` demo), and the CLI ``python -m
deeplearning_tpu_torch.export``."""
