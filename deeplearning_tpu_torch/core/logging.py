"""Process-0 logging, metric meters and the logger backends — the port of
``deeplearning_tpu/core/logging.py``.

The same surface: ``create_logger`` (console on process 0, a file per
process), ``AverageMeter`` / ``MetricLogger``, a ``TensorBoardWriter``
that is a no-op where ``torch.utils.tensorboard`` cannot be imported, the
``CsvLogger`` and offline ``JsonlLogger`` sinks, and ``LoggerHub`` over
the ``LOGGERS`` registry, which fails loudly on an unknown backend. The
process index is the ``torch.distributed`` rank when a process group is
up (one process a card), else 0.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

from .registry import Registry

__all__ = ["process_index", "is_main_process", "create_logger",
           "AverageMeter", "MetricLogger", "TensorBoardWriter", "CsvLogger",
           "JsonlLogger", "LOGGERS", "LoggerHub"]

_LOGGERS: Dict[str, logging.Logger] = {}
# output dirs a cached logger already writes to: a cache hit with a new
# dir attaches its file handler, so two runs in one process each get a log
_LOGGER_DIRS: Dict[str, set] = {}


def process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_index() == 0


def _fmt() -> logging.Formatter:
    fmt = (f"[%(asctime)s p{process_index()}] "
           "(%(filename)s:%(lineno)d) %(levelname)s: %(message)s")
    return logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S")


def _attach_file(logger: logging.Logger, name: str,
                 output_dir: str) -> None:
    if output_dir in _LOGGER_DIRS.setdefault(name, set()):
        return
    os.makedirs(output_dir, exist_ok=True)
    fh = logging.FileHandler(
        os.path.join(output_dir, f"log_p{process_index()}.txt"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(_fmt())
    logger.addHandler(fh)
    _LOGGER_DIRS[name].add(output_dir)


def create_logger(name: str = "dltpu", output_dir: Optional[str] = None,
                  to_console: bool = True) -> logging.Logger:
    """Formatted logger; console on process 0 only, per-process file logs.
    Cached by ``name``; an ``output_dir`` the cached logger has not seen
    yet still gets a file handler."""
    if name in _LOGGERS:
        logger = _LOGGERS[name]
        if output_dir:
            _attach_file(logger, name, output_dir)
        return logger
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if to_console and is_main_process():
        h = logging.StreamHandler(sys.stdout)
        h.setLevel(logging.INFO)
        h.setFormatter(_fmt())
        logger.addHandler(h)
    _LOGGERS[name] = logger
    if output_dir:
        _attach_file(logger, name, output_dir)
    return logger


class AverageMeter:
    """Running average over a window plus a global average."""

    def __init__(self, window: int = 50):
        self._window: deque = deque(maxlen=window)
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self._window.append(value)
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def smoothed(self) -> float:
        return float(np.mean(self._window)) if self._window else 0.0

    def reset(self) -> None:
        self._window.clear()
        self.sum = 0.0
        self.count = 0


class MetricLogger:
    """Dict of AverageMeters + iteration timing + ETA, tqdm-free. Values
    are host numbers: the Trainer feeds it lagged, already-fetched
    metrics (a tensor here would be a sync)."""

    def __init__(self, delimiter: str = "  ", window: int = 50):
        self.meters: Dict[str, AverageMeter] = defaultdict(
            lambda: AverageMeter(window))
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name: str) -> AverageMeter:
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{k}: {m.smoothed:.4f} ({m.avg:.4f})"
            for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  logger: Optional[logging.Logger] = None,
                  header: str = "") -> Iterable:
        logger = logger or create_logger()
        n = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = AverageMeter()
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (n and i == n - 1):
                eta = ""
                if n:
                    eta = f" eta: {iter_time.smoothed * (n - i - 1):.0f}s"
                logger.info(f"{header} [{i}{'/' + str(n) if n else ''}]"
                            f" {self}{eta} iter_t: {iter_time.smoothed:.4f}s")


class TensorBoardWriter:
    """Process-0-only wrapper over torch's SummaryWriter; a no-op where
    ``torch.utils.tensorboard`` (the tensorboard package) cannot be
    imported, and on other processes."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is not None and is_main_process():
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(log_dir)
            except ImportError:
                pass

    def add_scalar(self, tag: str, value: Any, step: int) -> None:
        if self._writer:
            self._writer.add_scalar(tag, float(value), step)

    def add_scalars(self, scalars: Dict[str, Any], step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_image(self, tag: str, img: np.ndarray, step: int,
                  dataformats: str = "HWC") -> None:
        if self._writer:
            self._writer.add_image(tag, img, step, dataformats=dataformats)

    def add_histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        if self._writer:
            self._writer.add_histogram(tag, np.asarray(values), step)

    def add_figure(self, tag: str, figure: Any, step: int) -> None:
        if self._writer:
            self._writer.add_figure(tag, figure, step)

    def flush(self) -> None:
        if self._writer:
            self._writer.flush()

    def close(self) -> None:
        if self._writer:
            self._writer.close()


def _scalar(v: Any) -> Any:
    if isinstance(v, bool):        # bools are metadata flags, not metrics
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class CsvLogger:
    """Append-per-step CSV metrics file, process 0 only. Columns are set on
    first write (a resumed run adopts the file's header); later dicts may
    omit keys (blank cell), and new keys widen the header in place."""

    def __init__(self, path: Optional[str]):
        self._path = path if (path and is_main_process()) else None
        self._columns: Optional[list] = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._path is None:
            return
        row = {"step": step, **{k: _scalar(v) for k, v in metrics.items()}}
        write_header = False
        if self._columns is None:
            os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                        exist_ok=True)
            if os.path.exists(self._path) and os.path.getsize(self._path):
                with open(self._path, newline="") as f:
                    self._columns = next(csv.reader(f), None)
            if self._columns is None:
                self._columns = list(row)
                write_header = True
        extra = [k for k in row if k not in self._columns]
        if extra:
            with open(self._path, newline="") as f:
                rows = list(csv.DictReader(f))
            self._columns = self._columns + extra
            with open(self._path, "w", newline="") as f:
                w = csv.DictWriter(f, self._columns)
                w.writeheader()
                w.writerows(rows)
            write_header = False
        with open(self._path, "a", newline="") as f:
            w = csv.DictWriter(f, self._columns, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class JsonlLogger:
    """Offline W&B-style sink: one JSON object a log call (step, wall time,
    metrics) in ``metrics.jsonl``, plus a final summary record."""

    def __init__(self, path: Optional[str]):
        self._path = path if (path and is_main_process()) else None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._path is None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                    exist_ok=True)
        rec = {"step": int(step), "time": time.time(),
               **{k: _scalar(v) for k, v in metrics.items()}}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def summary(self, results: Dict[str, Any]) -> None:
        self.log(-1, {"summary": True, **results})


LOGGERS = Registry("loggers")


@LOGGERS.register("tensorboard")
def _tb_backend(workdir: str):
    return TensorBoardWriter(workdir)


@LOGGERS.register("csv")
def _csv_backend(workdir: str):
    return CsvLogger(os.path.join(workdir, "results.csv"))


@LOGGERS.register("jsonl")
def _jsonl_backend(workdir: str):
    return JsonlLogger(os.path.join(workdir, "metrics.jsonl"))


class LoggerHub:
    """One dispatch point over the selected backends. Unknown backend
    names fail loudly at construction (a config typo is not dropped)."""

    def __init__(self, workdir: Optional[str],
                 backends: Sequence[str] = ("tensorboard", "csv", "jsonl")):
        self.workdir = workdir
        self.backends: Dict[str, Any] = {}
        if workdir:
            for name in backends:
                self.backends[name] = LOGGERS.build(name, workdir)

    @property
    def tb(self) -> TensorBoardWriter:
        return self.backends.get("tensorboard") or TensorBoardWriter(None)

    def scalars(self, metrics: Dict[str, Any], step: int) -> None:
        for backend in self.backends.values():
            if isinstance(backend, TensorBoardWriter):
                backend.add_scalars(metrics, step)
            else:
                backend.log(step, metrics)

    def summary(self, results: Dict[str, Any]) -> None:
        for backend in self.backends.values():
            if hasattr(backend, "summary"):
                backend.summary(results)

    def close(self) -> None:
        for backend in self.backends.values():
            if hasattr(backend, "close"):
                backend.close()
