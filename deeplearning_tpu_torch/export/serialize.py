"""Model export: ``.pt2`` programs, FLOPs — the counterpart of
``deeplearning_tpu/export/serialize.py``.

- ``export_program`` / ``load_program``: ``torch.export`` → a ``.pt2``
  (``torch.export.save`` / ``load``), the portable graph of the port as
  StableHLO is JAX's (``export_stablehlo`` / ``load_stablehlo``). The
  kernels are custom ops with fake implementations (``dltpu::flash_fwd``,
  ``dltpu::window_attn``, ``dltpu::nms_sweep`` ...), so a model on them
  exports with each launch one node, and the loaded program launches the
  same kernels.
- ``export_savedmodel``: the serving artifact, as JAX's TF SavedModel is
  its: ``torch.export``, then ``torch._inductor.aoti_compile_and_package``
  into one AOTInductor package (``.pt2``) compiled for the example
  arguments' device. ``native/aoti_runner.cc`` loads and runs it with no
  Python, the kernel ops registered from C++ by ``native/dltpu_ops.cpp``
  (both built by ``native/build.py``).
- ``flops_estimate``: the forward's operations, by
  ``utils/profiling.compiled_flops`` (``FlopCounterMode`` over a
  fake-mode run: nothing computed; K1 counts through its registered
  formula).
"""

from __future__ import annotations

import io
import os
from typing import Any, Callable, Sequence, Union

import torch

__all__ = ["export_program", "load_program", "export_savedmodel",
           "flops_estimate"]


def _as_module(fn: Callable) -> torch.nn.Module:
    if isinstance(fn, torch.nn.Module):
        return fn

    class _Fn(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)
    return _Fn()


def export_program(fn: Callable, example_args: Sequence[Any],
                   path: Union[str, os.PathLike, None] = None) -> bytes:
    """``torch.export`` ``fn`` (a module or a function) on
    ``example_args`` and serialize the program as ``.pt2`` bytes; writes
    ``path`` if given. Reload with ``load_program``."""
    ep = torch.export.export(_as_module(fn), tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_program(blob: Union[bytes, str, os.PathLike]) -> Callable:
    """The callable of a ``.pt2`` program (bytes or a path)."""
    src = io.BytesIO(blob) if isinstance(blob, (bytes, bytearray)) else blob
    return torch.export.load(src).module()


def export_savedmodel(fn: Callable, example_args: Sequence[Any],
                      path: Union[str, os.PathLike]) -> bool:
    """``torch.export`` ``fn`` on ``example_args``, then compile and package
    it with AOTInductor into ``path`` (a ``.pt2`` package) for the
    arguments' device. Returns True. Run the package with
    ``native/aoti_runner.cc`` and the op library
    (``native.build.build_serving()`` builds both), or from Python with
    ``torch._inductor.aoti_load_package``. The package's host code is
    compiled by the g++ that builds the runner (``native.build.CXX``),
    whatever ``$CXX`` names. A package for the card holds no CPU kernels,
    so its build skips Inductor's probe builds of the host's vector ISAs
    (which pick the CPU kernels' instruction set), and the precompiled
    header of the wrapper (which pays only across several wrapper builds;
    a package has one)."""
    from torch._inductor import aoti_compile_and_package

    from ..native.build import CXX
    configs = {"cpp.cxx": (None, CXX)}
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in example_args):
        configs.update({"cpp.vec_isa_ok": False,
                        "aot_inductor.precompile_headers": False})
    ep = torch.export.export(_as_module(fn), tuple(example_args))
    aoti_compile_and_package(ep, package_path=os.fspath(path),
                             inductor_configs=configs)
    return True


def flops_estimate(fn: Callable, *example_args) -> float:
    """Operations of ``fn(*example_args)`` — the thop / fvcore
    FLOPs-counter successor (vision_transformer/flops.py, yolov5
    torch_utils.py:104). Delegates to ``utils/profiling.compiled_flops``."""
    from ..utils.profiling import compiled_flops
    return compiled_flops(fn, *example_args)
