"""The custom-op demo: the counterpart of
``deeplearning_tpu/export/custom_call.py``.

The "teach the compiler a new op" tutorial the reference does for ONNX
(others/deploy/pytorch2onnx: my_add.cpp + setup.py + support_new_ops.py).
JAX's form is an XLA FFI handler; the port's is a plain C ABI function
(``native/my_add.cc``: 3a + 2b) built with g++ by ``native/build.py``,
loaded through ``ctypes`` and defined as the ``torch.library`` op
``dltpu::my_add`` with a fake implementation (``ops.kernels.define_op``), so it runs eagerly on
host tensors and exports (``torch.export``) as one node, as the port's
kernels do.

Difference from the JAX module, by decision: ``register()`` raises
``RuntimeError`` when the host has no g++ (JAX's returns False).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.kernels import define_op

__all__ = ["register", "my_add"]

_LOCK = threading.Lock()
_LIB = None


def register() -> ctypes.CDLL:
    """Build (once) and load ``libmy_add``; raises without a host
    compiler."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ..native import build
            lib = build.load("my_add")
            if lib is None:
                raise RuntimeError("no host toolchain (g++) to build "
                                   "native/my_add.cc")
            lib.my_add.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            lib.my_add.restype = None
            _LIB = lib
        return _LIB


def _my_add_impl(a, b):
    if a.device.type != "cpu" or b.device.type != "cpu":
        raise ValueError("my_add is a host op: pass CPU tensors")
    lib = register()
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    lib.my_add(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out


_MY_ADD = define_op(
    "my_add(Tensor a, Tensor b) -> Tensor", _my_add_impl,
    lambda a, b: torch.empty(a.shape, dtype=torch.float32, device=a.device))


def my_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3a + 2b through the native function (my_add.cpp semantics), in
    float32; ``a`` and ``b`` of one shape."""
    if a.shape != b.shape:
        raise ValueError(f"my_add takes one shape, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    return _MY_ADD(a, b)
