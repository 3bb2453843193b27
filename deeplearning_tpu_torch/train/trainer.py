"""Hook-structured Trainer — the port of
``deeplearning_tpu/train/trainer.py``.

The epoch loop over a loader (``set_epoch`` each epoch), the train step
it is given, lagged metrics, evaluation with one host fetch an epoch,
checkpoints with best tracking and auto-resume, hook dispatch
(``Callbacks``: YOLOX's before/after train/epoch/iter plus on_evaluate
and on_checkpoint) and ``throughput()``.

The hot loop never waits for the card between log points: each step's
metrics (0-d device tensors) go into a ``DeferredMetrics`` ring and only
entries ``metrics_lag`` steps old are fetched, in one transfer a log
point; a non-finite loss surfaces there as ``FloatingPointError`` within
``metrics_lag + log_every`` steps. A loader with a ``device`` is wrapped
in a ``DevicePrefetcher`` (``prefetch="auto"``), so the host-to-card copy
runs on a side stream, off the loop.

What the JAX Trainer takes and this one does not, and the slice that
brings it (ROADMAP Queue 1):
- ``recovery`` (divergence rollback), ``strict`` (the transfer guard: on
  the card, ``torch.cuda.set_sync_debug_mode``), ``preemptible`` and
  ``heartbeat`` (signals and the supervisor's heartbeat),
  ``async_checkpoint``: item 5c;
- ``metrics_port`` (the ``/metrics`` scrape server), ``hbm_sample_s`` and
  ``hbm_alert_frac`` (the device-memory sampler): item 6;
- ``weight_update`` (ZeRO-1 and the topology sidecar): item 7.
Fixed here, where the JAX Trainer takes an option: a checkpoint every
epoch (``save_every_epochs``), ``best`` by ``top1`` (``best_metric``),
the count-normalised eval (``metric_reducer``; detection's mAP reducer
comes with item 5b), always abort on a non-finite loss
(``abort_non_finite``) and the metrics window from ``log_every``
(``metrics_window``).
``retrace_warn`` never comes: eager PyTorch does not retrace. And
``precompile()`` only starts the prefetcher and returns None, as the JAX
method does when it has nothing to compile ahead: eager PyTorch has no
step to compile.
"""

from __future__ import annotations

import collections
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import rng as rng_mod
from ..core.checkpoint import CheckpointManager
from ..core.logging import LoggerHub, MetricLogger, create_logger
from ..data.device_prefetch import DevicePrefetcher
from ..obs import flight, spans
from ..obs.spans import span, step_span
from .async_metrics import DeferredMetrics, fetch_scalars

__all__ = ["HOOKS", "Callbacks", "Trainer"]

# the eval result whose rise marks a new ``best`` checkpoint
BEST_METRIC = "top1"

HOOKS = ("before_train", "after_train", "before_epoch", "after_epoch",
         "before_iter", "after_iter", "on_evaluate", "on_checkpoint")


class Callbacks:
    """Named hook registry (yolov5 utils/callbacks.py surface)."""

    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def register(self, event: str, fn: Callable) -> None:
        if event not in HOOKS:
            raise KeyError(f"Unknown hook {event!r}; valid: {HOOKS}")
        self._hooks[event].append(fn)

    def fire(self, event: str, trainer: "Trainer", **kw) -> None:
        for fn in self._hooks[event]:
            fn(trainer, **kw)


class Trainer:
    def __init__(
        self, *,
        state,                                  # TrainState
        train_step: Callable,                   # (state, batch, rng)->...
        train_loader,
        eval_step: Optional[Callable] = None,   # (state, batch)->counts
        eval_loader=None,
        epochs: int = 1,
        seed: int = 0,
        log_every: int = 50,
        eval_every_epochs: int = 1,
        workdir: Optional[str] = None,
        callbacks: Optional[Callbacks] = None,
        log_backends=("tensorboard", "csv", "jsonl"),
        metrics_lag: Optional[int] = None,
        prefetch="auto",
        obs="auto",
        run_config: Optional[Dict] = None,
    ):
        self.state = state
        # observability: spans + flight recorder, "auto" = on whenever the
        # run has a workdir to dump trace.json / flightrec.json into
        self.obs_enabled = bool(workdir) if obs == "auto" else bool(obs)
        self.run_config = run_config
        self._obs_owns_tracer = False
        self._obs_started = False
        self.train_step = train_step
        # "auto" wraps a loader with a device (its host-to-card copy is
        # the loop's last blocking stage); an int wraps any loader at that
        # depth; 0 / None wraps nothing
        self.train_loader = self._wrap_prefetch(train_loader, prefetch)
        self.eval_step = eval_step
        self.eval_loader = eval_loader
        self.epochs = epochs
        self.log_every = log_every
        self.eval_every = eval_every_epochs
        self.best_value = float("-inf")
        self.callbacks = callbacks or Callbacks()
        self.workdir = workdir
        self.logger = create_logger("dltpu", workdir)
        self.hub = LoggerHub(workdir, log_backends)
        self.tb = self.hub.tb
        self.meters = MetricLogger()
        self.rng = rng_mod.root_key(seed)
        self.epoch = 0
        # lagged metrics: default lag = log_every, so at each log point
        # the previous window is ready and a NaN aborts within
        # 2 * log_every steps; above 100 steps a window, the entries fold
        # into a device-side running mean
        self.metrics_lag = (metrics_lag if metrics_lag is not None
                            else log_every)
        self.metrics_window = log_every if log_every > 100 else None
        self.deferred = DeferredMetrics(lag=self.metrics_lag,
                                        window=self.metrics_window)
        self.eval_fetches = 0        # host materializations by evaluate()
        self.ckpt = CheckpointManager(f"{workdir}/ckpt") if workdir else None

    @property
    def host_step(self) -> int:
        return int(self.state.step)

    # ----------------------------------------------------- device feed
    @staticmethod
    def _wrap_prefetch(loader, prefetch):
        if loader is None or not prefetch:
            return loader
        if isinstance(loader, DevicePrefetcher):
            return loader                     # caller already wrapped it
        if prefetch == "auto":
            if getattr(loader, "device", None) is None or \
                    not hasattr(loader, "set_epoch"):
                return loader
            depth = 2
        else:
            depth = int(prefetch)
        return DevicePrefetcher(loader, depth=depth)

    def precompile(self) -> None:
        """Start the prefetcher, so the first batches' fetch and copy run
        while the caller does other set-up. Returns None: eager PyTorch
        has no step to compile ahead (the JAX method returns None too
        when it has nothing to compile)."""
        self._obs_start()
        if hasattr(self.train_loader, "start"):
            self.train_loader.start()
        return None

    # ----------------------------------------------------- observability
    def _obs_config(self) -> Dict[str, Any]:
        if self.run_config is not None:
            return self.run_config
        return {"epochs": self.epochs, "log_every": self.log_every,
                "metrics_lag": self.metrics_lag,
                "metrics_window": self.metrics_window,
                "best_metric": BEST_METRIC, "workdir": self.workdir}

    def _obs_start(self) -> None:
        """Idempotent: ``precompile()`` and ``train()`` both call it."""
        if not self.obs_enabled or self._obs_started:
            return
        self._obs_started = True
        self._obs_owns_tracer = not spans.enabled()
        spans.enable()
        if self.workdir:
            flight.configure(os.path.join(self.workdir, "flightrec.json"),
                             config=self._obs_config())

    def _obs_finish(self) -> None:
        if not self.obs_enabled:
            return
        tracer = spans.get_tracer()
        if tracer is not None and self.workdir:
            tracer.dump(os.path.join(self.workdir, "trace.json"))
        if self._obs_owns_tracer:
            spans.disable()
        self._obs_started = False      # a second train() re-arms

    # ------------------------------------------------------------- train
    def train(self) -> Any:
        self._obs_start()
        try:
            return self._train()
        except BaseException as exc:
            if self.obs_enabled:
                reason = ("divergence" if isinstance(exc, FloatingPointError)
                          else "exception")
                flight.dump(reason, exception=exc)
            raise
        finally:
            self._obs_finish()

    def _train(self) -> Any:
        if self.ckpt:
            restored, step = self.ckpt.auto_resume(self.state)
            if step:
                self.state = restored
                self.epoch = int(step) // max(len(self.train_loader), 1)
        self.callbacks.fire("before_train", self)
        for epoch in range(self.epoch, self.epochs):
            self.epoch = epoch
            self.callbacks.fire("before_epoch", self)
            self._epoch_pass(epoch)
            self.callbacks.fire("after_epoch", self)
            if self.eval_step and self.eval_loader is not None and \
                    (epoch + 1) % self.eval_every == 0:
                self.evaluate()
            if self.ckpt:
                self._save()
        self.callbacks.fire("after_train", self)
        summary = {"epochs": self.epochs, **getattr(self, "_last_eval", {})}
        if self.best_value != float("-inf"):
            summary["best_" + BEST_METRIC] = self.best_value
        self.hub.summary(summary)
        self.hub.close()
        return self.state

    def _epoch_pass(self, epoch: int) -> None:
        """Sync-free hot loop: the only host-card round trips are the
        lagged fetches inside ``self.deferred`` (entries >= metrics_lag
        steps old, already computed), one a log point."""
        self.train_loader.set_epoch(epoch)
        n_iter = len(self.train_loader)
        t_data = time.time()
        batches = iter(self.train_loader)
        # an exception mid-epoch must not leave the feed thread running
        try:
            it = 0
            while True:
                with span("data_wait", epoch=epoch):
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                wall_wait = time.time() - t_data
                # the loader's own queue-empty estimate (true starvation)
                # over the wall time between iterations, which holds the
                # dispatch
                loader_wait = getattr(self.train_loader, "last_data_wait",
                                      None)
                data_time = (loader_wait if loader_wait is not None
                             else wall_wait)
                self.callbacks.fire("before_iter", self, batch=batch)
                with step_span("dispatch", self.host_step):
                    self.state, metrics = self.train_step(
                        self.state, batch, self.rng)
                self.callbacks.fire("after_iter", self, metrics=metrics)
                self.deferred.push(metrics, epoch=epoch, it=it,
                                   step=self.host_step, n_iter=n_iter,
                                   data_time=data_time)
                if it % self.log_every == 0:
                    with span("metrics_flush"):
                        self._consume(self.deferred.poll())
                t_data = time.time()
                it += 1
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        # epoch-end barrier: one bulk fetch lands every remaining entry,
        # so short epochs still log and a NaN in the tail still aborts
        with span("metrics_flush", drain=True):
            self._consume(self.deferred.drain())
        feed_stats = getattr(self.train_loader, "stats", None)
        if feed_stats is not None:
            stats = feed_stats()
            self.hub.scalars({f"feed/{k}": v for k, v in stats.items()},
                             self.host_step)
            if self.obs_enabled:
                flight.record("feed", epoch=epoch, **stats)
            reset = getattr(self.train_loader, "reset_stats", None)
            if reset is not None:
                reset()

    def _consume(self, entries) -> None:
        """Divergence-check every materialized entry, then log the newest
        one (the stale snapshot that stands in for 'now')."""
        if not entries:
            return
        if self.obs_enabled:
            for meta, host in entries:
                flight.record("step", step=meta.get("step"),
                              epoch=meta.get("epoch"), it=meta.get("it"),
                              data_time=meta.get("data_time"),
                              metrics=host)
        for meta, host in entries:
            # bad_step is the step's isfinite(loss) flag; the loss check
            # covers custom steps that do not provide it
            if host.get("bad_step", 0) > 0 or not np.isfinite(
                    host.get("loss", 0.0)):
                self.logger.error(
                    f"Loss is {host.get('loss')}, stopping training "
                    f"(epoch {meta['epoch']} it {meta['it']})")
                if self.obs_enabled:
                    flight.record("divergence", step=meta.get("step"),
                                  epoch=meta["epoch"], it=meta["it"],
                                  loss=host.get("loss"))
                raise FloatingPointError(
                    f"non-finite loss {host.get('loss')} at epoch "
                    f"{meta['epoch']} it {meta['it']}")
        meta, host = entries[-1]
        host = {k: v for k, v in host.items() if k != "bad_step"}
        host["data_time"] = meta["data_time"]
        self.meters.update(**host)
        self.logger.info(
            f"epoch {meta['epoch']} it {meta['it']}/{meta['n_iter']} "
            f"{self.meters}")
        self.hub.scalars({f"train/{k}": v for k, v in host.items()},
                         meta["step"])

    # -------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, float]:
        """Every batch's count dict stays on the card while the loop runs;
        then ONE transfer lands them all. Totals are summed on the host in
        batch order, as the JAX Trainer sums them."""
        with span("eval", epoch=self.epoch):
            per_batch = [self.eval_step(self.state, batch)
                         for batch in self.eval_loader]
            host_counts = fetch_scalars(per_batch)
        self.eval_fetches += 1
        totals: Dict[str, float] = defaultdict(float)
        for counts in host_counts:
            for k, v in counts.items():
                totals[k] += v
        results = dict(totals)
        if "count" in totals and totals["count"] > 0:
            results = {k: v / totals["count"] for k, v in totals.items()
                       if k != "count"}
        self._last_eval = dict(results)
        self.callbacks.fire("on_evaluate", self, results=results)
        self.logger.info(f"eval @ epoch {self.epoch}: "
                         + "  ".join(f"{k}={v:.4f}"
                                     for k, v in results.items()))
        self.hub.scalars({f"eval/{k}": v for k, v in results.items()},
                         self.host_step)
        value = results.get(BEST_METRIC)
        if value is not None and value > self.best_value:
            self.best_value = value
            if self.ckpt:
                self._save(is_best=True)
        return results

    def _save(self, is_best: bool = False) -> None:
        step = self.host_step
        with span("checkpoint", step=step, best=is_best):
            self.ckpt.save(step, self.state,
                           metrics={BEST_METRIC: self.best_value},
                           is_best=is_best)
        self.callbacks.fire("on_checkpoint", self, step=step)

    # -------------------------------------------------- throughput mode
    def throughput(self, n_iters: int = 30, lag: int = 3) -> float:
        """Images a second over ``n_iters`` pipelined steps on real loader
        batches (swin main.py:281-300). After dispatching step i the loop
        reads step i-``lag``'s loss: that waits only for a step already
        behind ``lag`` others in the queue, so the card never drains, and
        the times between those reads are the per-step times (p50/p90).
        With a ``DevicePrefetcher`` its feed counters join
        ``throughput_stats``."""
        if n_iters < 2:
            raise ValueError("throughput needs n_iters >= 2")
        lag = max(1, min(int(lag), n_iters - 1))
        loader = self.train_loader
        reset = getattr(loader, "reset_stats", None)
        if reset is not None:
            reset()

        def cycle():
            while True:
                got = False
                for b in iter(loader):
                    got = True
                    yield b
                if not got:
                    raise ValueError("loader yielded zero batches")
        it = cycle()
        batch = next(it)
        bsz = int(next(iter(batch.values())).shape[0])
        # warmup step, then drain: a clean start
        self.state, m = self.train_step(self.state, batch, self.rng)
        m["loss"].item()
        ring: collections.deque = collections.deque()
        lag_marks, data_times = [], []
        t0 = time.perf_counter()
        for _ in range(n_iters):
            t_d = time.perf_counter()
            batch = next(it)
            wait = getattr(loader, "last_data_wait", None)
            data_times.append(wait if wait is not None
                              else time.perf_counter() - t_d)
            self.state, m = self.train_step(self.state, batch, self.rng)
            ring.append(m)
            if len(ring) > lag:
                ring.popleft()["loss"].item()      # lagged, non-draining
                lag_marks.append(time.perf_counter())
        while ring:                                # end-of-run drain
            ring.popleft()["loss"].item()
            lag_marks.append(time.perf_counter())
        it.close()                                 # stops the feed thread
        total = time.perf_counter() - t0
        ips = bsz * n_iters / total
        step_times = np.diff(lag_marks) if len(lag_marks) > 1 else \
            np.asarray([total / n_iters])
        p50, p90 = np.percentile(step_times, [50, 90])
        data_frac = sum(data_times) / total if total else 0.0
        self.throughput_stats = {
            "images_per_sec": ips,
            "step_ms_mean": total / n_iters * 1e3,
            "step_ms_p50": p50 * 1e3,
            "step_ms_p90": p90 * 1e3,
            "data_wait_frac": data_frac,
            "batch": bsz,
        }
        feed_stats = getattr(loader, "stats", None)
        if feed_stats is not None:
            self.throughput_stats.update(feed_stats())
        self.logger.info(
            f"throughput: {ips:.1f} images/s "
            f"({total / n_iters * 1e3:.1f} ms/iter pipelined, "
            f"p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms, "
            f"data-wait {data_frac:.1%}, batch {bsz}, lag {lag})")
        return ips
