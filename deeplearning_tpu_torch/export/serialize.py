"""Model export: ``.pt2`` programs, FLOPs — the counterpart of
``deeplearning_tpu/export/serialize.py``.

- ``export_program`` / ``load_program``: ``torch.export`` → a ``.pt2``
  (``torch.export.save`` / ``load``), the portable graph of the port as
  StableHLO is JAX's (``export_stablehlo`` / ``load_stablehlo``). The
  kernels are custom ops with fake implementations (``dltpu::flash_fwd``,
  ``dltpu::window_attn``, ``dltpu::nms_sweep`` ...), so a model on them
  exports with each launch one node, and the loaded program launches the
  same kernels.
- ``export_savedmodel`` raises ``ValueError``: the serving artifact and its
  native runner (an AOTInductor package and a libtorch C++ runner) come
  with ROADMAP Queue 1 item 8d.
- ``flops_estimate``: the forward's operations by
  ``torch.utils.flop_counter.FlopCounterMode`` over a fake-mode run
  (nothing computed; K1 counts through its registered formula).
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
                      path: str) -> bool:
    """JAX's TF SavedModel export; the port's serving artifact comes with
    ROADMAP Queue 1 item 8d."""
    raise ValueError("export_savedmodel: the port's serving artifact (an "
                     "AOTInductor package with a libtorch C++ runner) "
                     "comes with ROADMAP Queue 1 item 8d")


def flops_estimate(fn: Callable, *example_args) -> float:
    """Operations of ``fn(*example_args)`` by ``FlopCounterMode`` over
    fake tensors — the thop / fvcore FLOPs-counter successor
    (vision_transformer/flops.py, yolov5 torch_utils.py:104)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..analysis.audit import fake_mode
    mode = fake_mode()
    counter = FlopCounterMode(display=False)
    with mode:
        args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in example_args]
        with counter, torch.no_grad():
            fn(*args)
    return float(counter.get_total_flops())
