"""Profiling: step timing, the FLOPs count and MFU, torch.profiler traces —
the port of ``deeplearning_tpu/utils/profiling.py``.

- ``StepTimer``: wall-clock per-step timing that synchronises the card
  at each start and stop, so a step's time is its device work, not the
  enqueue.
- ``RetraceGuard``: warns when a wrapped step sees a new argument
  signature (shapes, dtypes, structure). Eager torch retraces nothing, but
  a new shape still means new kernel configurations, a fresh allocator
  pattern and, under ``torch.export`` or AOTInductor, a new artifact: the
  same shape churn JAX's guard catches.
- ``compiled_flops`` / ``measure_mfu``: operations from
  ``torch.utils.flop_counter.FlopCounterMode`` over a fake-mode run
  (nothing computed; K1 counts through its registered formula), measured
  step time, and the card's peak.
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace.

``device_peak_flops`` knows only the card the port is measured on: the
H100 SXM's 989 TFLOP/s dense bf16 (NVIDIA's data sheet), and raises for
any other device rather than guess.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable, Dict, Optional, Union

import torch

__all__ = ["PEAK_BF16_FLOPS", "device_peak_flops", "StepTimer",
           "RetraceGuard", "compiled_flops", "measure_mfu", "trace",
           "model_info"]

# dense bf16 tensor-core peaks by card name (NVIDIA's data sheets); the
# H100 SXM reports itself as "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12}


def device_peak_flops(device: Union[str, torch.device, None] = None
                      ) -> float:
    """The dense bf16 peak of ``device`` (default: the current card).
    Raises ``ValueError`` for a device whose peak the port does not
    know."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError(f"no peak FLOP/s is known for device {device}")
    name = torch.cuda.get_device_name(device)
    for key, val in PEAK_BF16_FLOPS.items():
        if key in name:
            return val
    raise ValueError(f"no peak FLOP/s is known for {name!r} (known: "
                     f"{sorted(PEAK_BF16_FLOPS)})")


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates step wall times; ``start`` and ``stop`` synchronise the
    card (when this process uses one), so a step's time includes its
    device work."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        _synchronize()
        self._t0 = time.perf_counter()

    def stop(self):
        # stop() without a matching start() records nothing
        if self._t0 is None:
            return
        _synchronize()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


class RetraceGuard:
    """Warn when a wrapped step function sees a NEW argument signature
    after its first call: a new shape or dtype (shape churn from a sloppy
    loader, a dtype flip, a non-dropped last batch) means new kernel
    configurations and, for an exported program, a new artifact.

    Signatures are computed on the host from the leaves' shapes and dtypes
    (Python scalars by type) over ``torch.utils._pytree``'s flattening, so
    the guard costs a flatten a call and never touches the device.
    Deliberate shape buckets warn once a new bucket and then stay quiet.
    """

    def __init__(self, fn: Callable, name: str = "step",
                 logger=None, max_warnings: int = 8,
                 on_retrace: Optional[Callable[[Dict], None]] = None):
        self.fn = fn
        self.name = name
        self.logger = logger
        self.max_warnings = max_warnings
        # called with {name, retraces, n_signatures} on every new
        # signature after the first, past the max_warnings cap too
        self.on_retrace = on_retrace
        self._sigs: set = set()
        self.retraces = 0          # new signatures seen after the first

    @property
    def n_signatures(self) -> int:
        return len(self._sigs)

    @staticmethod
    def _leaf_sig(x):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is None and dtype is None:
            return type(x).__name__
        return (tuple(shape) if shape is not None else None, str(dtype))

    def _signature(self, args, kwargs):
        from torch.utils._pytree import tree_flatten
        leaves, spec = tree_flatten((args, kwargs))
        return (str(spec), tuple(self._leaf_sig(leaf) for leaf in leaves))

    def __call__(self, *args, **kwargs):
        sig = self._signature(args, kwargs)
        if sig not in self._sigs:
            self._sigs.add(sig)
            if len(self._sigs) > 1:
                self.retraces += 1
                if self.on_retrace is not None:
                    self.on_retrace({"name": self.name,
                                     "retraces": self.retraces,
                                     "n_signatures": len(self._sigs)})
                if self.retraces <= self.max_warnings:
                    msg = (f"{self.name}: argument signature changed "
                           f"({len(self._sigs)} distinct signatures seen) "
                           "— each new shape/dtype means new kernel "
                           "configurations; pad or bucket inputs to fixed "
                           "shapes")
                    warnings.warn(msg, RuntimeWarning, stacklevel=2)
                    if self.logger is not None:
                        self.logger.warning(msg)
        return self.fn(*args, **kwargs)


def compiled_flops(fn: Callable, *args) -> float:
    """Operations of ``fn(*args)`` (2 a multiply-add) by
    ``FlopCounterMode`` over a fake-mode run: nothing is computed or
    launched; tensor arguments become fake tensors of the same shapes,
    dtypes and devices."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..analysis.audit import fake_mode
    mode = fake_mode()
    counter = FlopCounterMode(display=False)
    with mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with counter, torch.no_grad():
            fn(*fargs)
    return float(counter.get_total_flops())


def measure_mfu(step_fn: Callable, args: tuple, n_steps: int = 10,
                sync_fetch: Optional[Callable] = None,
                peak_flops: Optional[float] = None) -> Dict[str, float]:
    """Run ``step_fn(*args)`` ``n_steps`` times after one warm-up run,
    synchronising the card (and calling ``sync_fetch(output)`` when
    given) before and after, and report the step time, its operations
    (``compiled_flops``) and the MFU against ``peak_flops`` (default:
    ``device_peak_flops()`` of the card)."""
    flops = compiled_flops(step_fn, *args)
    peak = device_peak_flops() if peak_flops is None else float(peak_flops)
    out = step_fn(*args)
    _synchronize()
    if sync_fetch:
        sync_fetch(out)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = step_fn(*args)
    _synchronize()
    if sync_fetch:
        sync_fetch(out)
    dt = (time.perf_counter() - t0) / n_steps
    return {"step_time_s": dt, "flops_per_step": flops,
            "mfu": flops / dt / peak if flops else 0.0,
            "peak_flops": peak}


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's activity too when
    this process uses one); writes ``<logdir>/trace.json`` (a Chrome
    trace, which TensorBoard's and Perfetto's viewers read) and yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)   # fresh run dirs must not fail
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def model_info(model: torch.nn.Module, *example_args, train: bool = False,
               **example_kw) -> Dict[str, float]:
    """Parameters and forward FLOPs of a port model — the get_model_info /
    model_info surface (yolov5 utils/torch_utils.py:236, YOLOX
    yolox/utils/model_utils.py, vision_transformer/flops.py). FLOPs are
    ``compiled_flops`` of the forward on ``example_args`` in train or eval
    mode (the mode is restored after)."""
    n_params = sum(p.numel() for p in model.parameters())
    was = model.training
    model.train(train)
    try:
        flops = compiled_flops(lambda *a: model(*a, **example_kw),
                               *example_args)
    finally:
        model.train(was)
    return {"params_m": n_params / 1e6, "gflops": flops / 1e9}
