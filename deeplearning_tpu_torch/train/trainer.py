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

The robust half, as in JAX:
- ``recovery``: ``"rollback"`` (or a ``RecoveryPolicy`` /
  ``RecoveryManager``) keeps a device-side anchor of the state, rolls
  back to it on a non-finite step, reseeds the loader (the skip) and
  damps the updates of a cooldown; the abort comes only once the budget
  is spent (``train/recovery.py``). The ``nan@step:N`` fault poisons the
  parameters at step N so the whole path runs for real.
- ``strict``: ``"transfers"`` wraps every step region in
  ``torch.cuda.set_sync_debug_mode("error")`` (the lagged metrics fetch
  stays outside it); ``"nans"`` arms NaN detection for the whole run;
  ``"threads"`` arms the thread sanitizer before the run's objects build
  their locks (``analysis/strict.py``, ``analysis/threadsan.py``).
- ``preemptible``: SIGTERM / SIGINT flush the in-flight checkpoint, and
  ``Preempted`` is raised at the next step boundary after the state is
  checkpointed at the step rank 0 reports (``elastic/preempt.py``; the
  CLI exits 75). ``heartbeat``: the step / activity watermark file
  (``"auto"``: the path in ``DLTPU_HEARTBEAT``).
- ``async_checkpoint``: ``CheckpointManager(async_save=True)``; the
  ``ckpt_corrupt`` fault garbles a committed step.

With observability on (``obs``), as in JAX: an ``HbmWatermark`` samples
the card's memory reading every ``hbm_sample_s`` from its own thread
(``hbm_alert_frac`` arms its alert), the metrics registry
(``obs/metrics.py``) takes the lagged train scalars, the feed's stats and
the rollbacks, and ``metrics_port`` serves it as ``/metrics``,
``/metrics.json`` and ``/healthz`` (``"auto"``: the port in
``DLTPU_METRICS_PORT``, if any; 0 picks a free one; None off) beside the
loop, advertised in ``DLTPU_ENDPOINT_FILE`` when set. The scrape reads
the host copies the log line reads: it adds no fetch from the card.

On a mesh (the step from ``make_train_step(mesh=...)``, the state
placed by ``shard_state``): ``weight_update`` ("replicated" / "zero1",
None to read it off the state's layout) goes into every checkpoint's
``topology.json`` with the mesh and the layout (JAX's sidecar); the
checkpoint gathers the slices on every rank and rank 0 writes it; rank 0
alone writes the logs, the flight and trace files, the heartbeat and the
metrics port; a preemption lands at the step rank 0 reports
(``agree_preempt_step``), and rank 0 decides whether it still has to be
saved.

Fixed here, where the JAX Trainer takes an option: a checkpoint every
epoch (``save_every_epochs``), ``best`` by ``top1`` (``best_metric``),
the count-normalised eval (``metric_reducer``: no caller of the JAX
package passes one, detection scores its mAP in its own CLI, so the
option comes with its first caller), always abort on a non-finite loss
(``abort_non_finite``) and the metrics window from ``log_every``
(``metrics_window``).
``retrace_warn`` never comes: eager PyTorch does not retrace. And
``precompile()`` only starts the prefetcher and returns None, as the JAX
method does when it has nothing to compile ahead: eager PyTorch has no
step to compile.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..analysis import strict as strict_mod
from ..core import rng as rng_mod
from ..core.checkpoint import CheckpointManager
from ..core.logging import LoggerHub, MetricLogger, create_logger
from ..data.device_prefetch import DevicePrefetcher
from ..elastic import faults
from ..elastic import heartbeat as hb
from ..elastic.preempt import (Preempted, PreemptionGuard,
                               agree_preempt_step)
from ..obs import flight, spans
from ..obs import metrics as obs_metrics
from ..obs.spans import span, step_span
from ..parallel.collectives import broadcast_from_host0
from ..parallel.mesh import rank
from . import recovery as recovery_mod
from .async_metrics import DeferredMetrics, fetch_scalars
from .recovery import RecoveryExhausted, RecoveryManager, RecoveryPolicy

__all__ = ["HOOKS", "Callbacks", "Trainer"]

# the eval result whose rise marks a new ``best`` checkpoint
BEST_METRIC = "top1"

HOOKS = ("before_train", "after_train", "before_epoch", "after_epoch",
         "before_iter", "after_iter", "on_evaluate", "on_checkpoint")


class _DivergenceDetected(Exception):
    """Internal control flow: a lagged metrics entry surfaced a
    non-finite step. Carries the offending entry so the rollback path
    can report it; never escapes the Trainer."""

    def __init__(self, meta: Dict[str, Any], host: Dict[str, Any]):
        super().__init__(f"divergence at step {meta.get('step')}")
        self.meta = meta
        self.host = host


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
        async_checkpoint: bool = False,
        log_backends=("tensorboard", "csv", "jsonl"),
        metrics_lag: Optional[int] = None,
        prefetch="auto",
        obs="auto",
        run_config: Optional[Dict] = None,
        preemptible: bool = True,
        heartbeat="auto",
        recovery=None,
        strict=None,
        hbm_sample_s: float = 0.25,
        hbm_alert_frac: Optional[float] = None,
        metrics_port="auto",
        weight_update: Optional[str] = None,
    ):
        self.state = state
        # rank 0 alone writes logs, traces, the heartbeat and the port
        self.is_main = rank() == 0
        # "replicated" / "zero1", recorded in every checkpoint's topology
        # sidecar; None lets the sidecar read it off the state's layout
        self.weight_update = weight_update
        # strict mode: "transfers" arms the sync guard around every step
        # region, "nans" NaN detection for the whole run; None defers to
        # DLTPU_STRICT in the environment
        self.strict_modes = strict_mod.resolve(strict)
        self.strict_sections = 0     # guard regions entered (test hook)
        # "threads" arms the thread sanitizer now, before the prefetcher,
        # heartbeat and metrics objects construct their locks: enable()
        # patches modules' threading attributes, so timing matters
        strict_mod.maybe_enable_threads(self.strict_modes)
        # self-healing policy: None/"abort" raises on the first bad step;
        # "rollback" (or a RecoveryPolicy / RecoveryManager) rolls back
        # to a device-side anchor, skips the bad data window and damps
        # the updates of a cooldown, aborting once the budget is spent
        if recovery is None or recovery == "abort":
            self._recovery: Optional[RecoveryManager] = None
        elif recovery == "rollback":
            self._recovery = RecoveryManager(RecoveryPolicy())
        elif isinstance(recovery, RecoveryPolicy):
            self._recovery = (RecoveryManager(recovery)
                              if recovery.mode == "rollback" else None)
        elif isinstance(recovery, RecoveryManager):
            self._recovery = recovery
        else:
            raise ValueError(f"recovery must be None|'abort'|'rollback'|"
                             f"RecoveryPolicy|RecoveryManager, "
                             f"got {recovery!r}")
        # elastic wiring: preemptible installs the chained SIGTERM/SIGINT
        # guard (flush checkpoint -> Preempted at the next step boundary
        # -> exit 75); heartbeat "auto" writes the watermark file when
        # DLTPU_HEARTBEAT names one (a path forces it, None disables)
        self.preemptible = bool(preemptible)
        self._heartbeat_opt = heartbeat
        self.preempt_guard: Optional[PreemptionGuard] = None
        self._beat: Optional[hb.Heartbeat] = None
        self._beat_writer: Optional[hb.HeartbeatWriter] = None
        # observability: spans + flight recorder, "auto" = on whenever the
        # run has a workdir to dump trace.json / flightrec.json into
        self.obs_enabled = self.is_main and (
            bool(workdir) if obs == "auto" else bool(obs))
        self.run_config = run_config
        self._obs_owns_tracer = False
        self._obs_started = False
        # the memory sampler (with obs) and the scrape server: "auto"
        # serves /metrics only when DLTPU_METRICS_PORT names a port; an
        # int forces that port (0 = ephemeral); None / False disables
        self.hbm_sample_s = hbm_sample_s
        self.hbm_alert_frac = hbm_alert_frac
        self._hbm = None
        self.hbm_watermark: Dict[str, float] = {}
        if not self.is_main:
            self.metrics_port = None
        elif metrics_port == "auto":
            raw = os.environ.get("DLTPU_METRICS_PORT")
            self.metrics_port = int(raw) if raw not in (None, "") else None
        else:
            # "is", not "in": 0 == False, and 0 asks for a free port (the
            # JAX Trainer's membership test turns metrics_port=0 off)
            self.metrics_port = (None if metrics_port is None
                                 or metrics_port is False
                                 else int(metrics_port))
        self._metrics_server = None
        self._owns_metrics_registry = False
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
        self.hub = LoggerHub(workdir if self.is_main else None,
                             log_backends)
        self.tb = self.hub.tb
        self.meters = MetricLogger()
        self.rng = rng_mod.host_key(seed)
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
        self.ckpt = (CheckpointManager(f"{workdir}/ckpt",
                                       async_save=async_checkpoint)
                     if workdir else None)

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
            flight.install_signal_handler()
        from ..obs.xla import HbmWatermark
        self._hbm = HbmWatermark(interval_s=self.hbm_sample_s,
                                 alert_frac=self.hbm_alert_frac).start()
        # the registry is on with obs (the pushes of _consume, the feed
        # and the rollback need a home); the server only on a port
        self._owns_metrics_registry = not obs_metrics.enabled()
        obs_metrics.enable()
        if self.metrics_port is not None and self._metrics_server is None:
            self._metrics_server = obs_metrics.MetricsServer(
                port=self.metrics_port,
                healthz_fn=self._metrics_healthz).start()
            obs_metrics.write_endpoint(self._metrics_server.url,
                                       role="train")

    def _metrics_healthz(self):
        """Train-replica health, backed by the heartbeat's step/activity
        watermark when one is armed."""
        payload = {"status": "ready", **obs_metrics.replica_identity()}
        if self._beat is not None:
            payload["step"] = self._beat.step
            payload["activity"] = self._beat.activity
            payload["phase"] = self._beat.phase
        return 200, payload

    def _obs_finish(self) -> None:
        if not self.obs_enabled:
            return
        if self._hbm is not None:
            self._hbm.stop()
            self.hbm_watermark = self._hbm.watermark()
        tracer = spans.get_tracer()
        if tracer is not None and self.workdir:
            tracer.dump(os.path.join(self.workdir, "trace.json"))
        if self._obs_owns_tracer:
            spans.disable()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        reg = obs_metrics.get_registry()
        if reg is not None and self.workdir:
            reg.dump(os.path.join(self.workdir, "metrics_registry.json"))
        if self._owns_metrics_registry:
            obs_metrics.disable()
        self._obs_started = False      # a second train() re-arms

    # ---------------------------------------------------------- elastic
    def _elastic_start(self) -> None:
        """Arm the preemption guard and the heartbeat writer; idempotent
        like ``_obs_start``."""
        if self.preemptible and self.preempt_guard is None:
            guard = PreemptionGuard()
            if self.ckpt:
                # in-handler flush: the in-flight async write commits even
                # if the loop never reaches another step boundary
                guard.add_flush(self.ckpt.flush)
            if guard.install():
                self.preempt_guard = guard
        if self._beat_writer is None and self.is_main:
            path = self._heartbeat_opt
            if path == "auto":
                path = os.environ.get(hb.ENV_VAR)
            if path:
                self._beat = hb.Heartbeat(step=self.host_step)
                self._beat_writer = hb.HeartbeatWriter(
                    str(path), self._beat).start()

    def _elastic_finish(self) -> None:
        if self._beat_writer is not None:
            self._beat_writer.stop()
            self._beat_writer = None
        if self.preempt_guard is not None:
            self.preempt_guard.uninstall()
            self.preempt_guard = None

    def _beat_touch(self, phase: str) -> None:
        if self._beat is not None:
            self._beat.touch(phase, step=self.host_step)

    def _check_preempted(self) -> None:
        """Step-boundary poll (one ``Event.is_set`` when armed). A
        SIGTERM handler defers its flight dump to here: no file I/O on
        the signal stack."""
        if self.obs_enabled:
            flight.flush_pending()
        if self.preempt_guard is not None and \
                self.preempt_guard.requested():
            raise Preempted(
                f"preemption signal at step {self.host_step}",
                signum=self.preempt_guard.signum, step=self.host_step)

    def _on_preempted(self, exc: Preempted) -> None:
        """Land the final state: checkpoint the step rank 0 reports
        (unless a save already wrote it), wait for the write, dump the
        flight ring with the reason 'preempted'."""
        if self.ckpt:
            step = agree_preempt_step(int(self.state.step))
            # one decision for every rank: the save is collective
            if broadcast_from_host0(self.ckpt.latest_step() != step):
                self._save()
            self.ckpt.flush()
            self.logger.info(
                f"preempted (signal {exc.signum}): checkpoint flushed at "
                f"step {step}; exit with EXIT_PREEMPTED requeues")
        if self.obs_enabled:
            flight.dump("preempted", exception=exc)

    # ------------------------------------------------------------- train
    def _strict_ctx(self):
        """One hot-loop guard region (``analysis.strict``), counted so
        tests can assert it wrapped every step."""
        if "transfers" in self.strict_modes:
            self.strict_sections += 1
            return strict_mod.no_host_transfers()
        return contextlib.nullcontext()

    def train(self) -> Any:
        self._obs_start()
        self._elastic_start()
        try:
            if "nans" in self.strict_modes:
                # run-wide: the forward hooks and anomaly mode stay armed
                with strict_mod.debug_nans(model=self.state.model):
                    return self._train()
            return self._train()
        except Preempted as exc:
            self._on_preempted(exc)
            raise
        except BaseException as exc:
            if self.obs_enabled:
                reason = ("divergence" if isinstance(exc, FloatingPointError)
                          else "exception")
                flight.dump(reason, exception=exc)
            raise
        finally:
            self._elastic_finish()
            self._obs_finish()

    def _train(self) -> Any:
        if self.ckpt:
            restored, step = self.ckpt.auto_resume(self.state)
            if step:
                self.state = restored
                self.epoch = int(step) // max(len(self.train_loader), 1)
        if self._recovery is not None:
            # fresh init or a just-restored checkpoint: both known-clean
            self._recovery.seed(self.host_step, self.state)
        self.callbacks.fire("before_train", self)
        try:
            for epoch in range(self.epoch, self.epochs):
                self.epoch = epoch
                self.callbacks.fire("before_epoch", self)
                self._train_one_epoch(epoch)
                self.callbacks.fire("after_epoch", self)
                if self.eval_step and self.eval_loader is not None and \
                        (epoch + 1) % self.eval_every == 0:
                    self.evaluate()
                if self.ckpt:
                    self._save()
        finally:
            # land an in-flight async write and the pending best copy even
            # on an abort, before hooks that might read the best copy
            if self.ckpt:
                self.ckpt.wait_until_finished()
        self.callbacks.fire("after_train", self)
        if self._recovery is not None and self._recovery.rollbacks \
                and self.obs_enabled:
            # the run SURVIVED its divergences: land the evidence in
            # flightrec.json though nothing crashed
            flight.record("recovery_summary", **self._recovery.stats())
            flight.dump("recovered")
        summary = {"epochs": self.epochs, **getattr(self, "_last_eval", {})}
        if self.best_value != float("-inf"):
            summary["best_" + BEST_METRIC] = self.best_value
        self.hub.summary(summary)
        self.hub.close()
        return self.state

    def _train_one_epoch(self, epoch: int) -> None:
        """One epoch, retried through divergence rollbacks: each
        ``_DivergenceDetected`` rolls the state back to the anchor and
        replays the epoch under a fresh loader permutation; the budget in
        ``_rollback`` bounds the retries."""
        while True:
            try:
                return self._epoch_pass(epoch)
            except _DivergenceDetected as d:
                self._rollback(d)

    def _epoch_pass(self, epoch: int) -> None:
        """Sync-free hot loop: the only host-card round trips are the
        lagged fetches inside ``self.deferred`` (entries >= metrics_lag
        steps old, already computed), one a log point."""
        self.train_loader.set_epoch(epoch)
        n_iter = len(self.train_loader)
        t_data = time.time()
        batches = iter(self.train_loader)
        # an exception mid-epoch (a rollback too) must not leave the feed
        # thread running
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
                # strict region: before_iter through the metrics push;
                # the lagged poll below stays outside, it is the one
                # designed sync a log point
                with self._strict_ctx():
                    self.callbacks.fire("before_iter", self, batch=batch)
                    # recovery hooks, queued BEFORE the in-place step:
                    # the periodic anchor snapshot, and inside a cooldown
                    # a params copy for the damped update
                    prev_params = cooldown = None
                    if self._recovery is not None:
                        self._recovery.maybe_snapshot(self.host_step,
                                                      self.state)
                        cooldown = self._recovery.cooldown_scale(
                            self.host_step)
                        if cooldown is not None:
                            prev_params = recovery_mod.snapshot_state(
                                self.state.params)
                    with step_span("dispatch", self.host_step):
                        self.state, metrics = self.train_step(
                            self.state, batch, self.rng)
                    if cooldown is not None:
                        # shrink this step's param delta; the optimizer
                        # moments keep their own schedule
                        damped = recovery_mod.damp_update(
                            prev_params, self.state.params, cooldown)
                        with torch.no_grad():
                            for name, p in self.state.params.items():
                                p.copy_(damped[name])
                    self.callbacks.fire("after_iter", self, metrics=metrics)
                    self.deferred.push(metrics, epoch=epoch, it=it,
                                       step=self.host_step, n_iter=n_iter,
                                       data_time=data_time)
                if it % self.log_every == 0:
                    with span("metrics_flush"):
                        self._consume(self.deferred.poll())
                # step boundary: the heartbeat, the fault harness (a
                # sigterm fault goes through the real handler chain),
                # then a requested preemption lands while the state is
                # whole
                self._beat_touch("step")
                faults.maybe_fire("step", step=self.host_step)
                if faults.consume("nan", "step", step=self.host_step):
                    # poison the params so the NEXT step's loss is NaN
                    # through the real bad_step flag
                    recovery_mod.poison_state(self.state)
                self._check_preempted()
                t_data = time.time()
                it += 1
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        # epoch-end barrier: one bulk fetch lands every remaining entry,
        # so short epochs still log and a NaN in the tail is still caught
        with span("metrics_flush", drain=True):
            self._consume(self.deferred.drain())
        feed_stats = getattr(self.train_loader, "stats", None)
        if feed_stats is not None:
            stats = feed_stats()
            self.hub.scalars({f"feed/{k}": v for k, v in stats.items()},
                             self.host_step)
            if self.obs_enabled:
                flight.record("feed", epoch=epoch, **stats)
                for k, v in stats.items():
                    if isinstance(v, (int, float)):
                        obs_metrics.set_gauge(f"dltpu_feed_{k}", float(v))
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
        bad_i = None
        for i, (meta, host) in enumerate(entries):
            # bad_step is the step's isfinite(loss) flag; the loss check
            # covers custom steps that do not provide it
            if host.get("bad_step", 0) > 0 or not np.isfinite(
                    host.get("loss", 0.0)):
                bad_i = i
                break
        if self._recovery is not None and bad_i != 0:
            # the newest verified-finite step vouches for every pending
            # anchor snapshot strictly older than it
            clean_meta = entries[len(entries) - 1 if bad_i is None
                                 else bad_i - 1][0]
            if clean_meta.get("step") is not None:
                self._recovery.mark_verified(clean_meta["step"])
        if bad_i is not None:
            meta, host = entries[bad_i]
            self.logger.error(
                f"Loss is {host.get('loss')}, "
                + ("recovering" if self._recovery is not None
                   else "stopping training")
                + f" (epoch {meta['epoch']} it {meta['it']})")
            if self.obs_enabled:
                flight.record("divergence", step=meta.get("step"),
                              epoch=meta["epoch"], it=meta["it"],
                              loss=host.get("loss"))
            if self._recovery is not None:
                raise _DivergenceDetected(meta, host)
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
        # the scrape surface: the same lagged host snapshot, no new fetch
        if meta.get("step") is not None:
            obs_metrics.set_gauge("dltpu_train_step", float(meta["step"]))
        for k, v in host.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                safe = "".join(c if c.isalnum() else "_" for c in str(k))
                obs_metrics.set_gauge(f"dltpu_train_{safe}", float(v))

    # ---------------------------------------------------------- recovery
    def _rollback(self, d: _DivergenceDetected) -> None:
        """Roll back to the anchor, skip the offending data window and
        arm the cooldown; with the budget spent, fall through to the
        abort (``FloatingPointError``, the same message)."""
        meta, host = d.meta, d.host
        bad_step = int(meta.get("step") or self.host_step)
        try:
            anchor_step, tree = self._recovery.on_divergence(bad_step)
        except RecoveryExhausted as exc:
            if self.obs_enabled:
                flight.record("recovery_exhausted", step=bad_step,
                              error=str(exc), **self._recovery.stats())
            raise FloatingPointError(
                f"non-finite loss {host.get('loss')} at epoch "
                f"{meta['epoch']} it {meta['it']} ({exc})") from exc
        self.state.load_state_dict(tree)
        # in-flight entries were computed from the poisoned state: replace
        # the ring instead of fetching them
        self.deferred = DeferredMetrics(lag=self.metrics_lag,
                                        window=self.metrics_window)
        # the skip: a reseedable loader replays the epoch under a fresh
        # permutation, so the poisonous batch order is never retraced
        reseed = getattr(self.train_loader, "reseed", None)
        if reseed is not None:
            reseed(self._recovery.rollbacks)
        pol = self._recovery.policy
        self.logger.warning(
            f"divergence at step {bad_step} (loss {host.get('loss')}): "
            f"rolled back to step {anchor_step}, "
            + ("reseeded loader, " if reseed is not None else "")
            + f"lr x{pol.lr_decay} for {pol.cooldown_steps} steps "
            f"({len(self._recovery.recovery_steps)}/{pol.max_recoveries} "
            f"recoveries used)")
        obs_metrics.inc("dltpu_recovery_rollbacks_total")
        if self.obs_enabled:
            flight.record("recovery", step=bad_step,
                          anchor_step=anchor_step, loss=host.get("loss"),
                          epoch=meta.get("epoch"),
                          rollbacks=self._recovery.rollbacks,
                          skipped=[anchor_step, bad_step],
                          cooldown_steps=pol.cooldown_steps,
                          lr_decay=pol.lr_decay,
                          reseeded=reseed is not None)
        self._beat_touch("recovery")

    # -------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, float]:
        """Every batch's count dict stays on the card while the loop runs;
        then ONE transfer lands them all. Totals are summed on the host in
        batch order, as the JAX Trainer sums them."""
        self._beat_touch("eval")
        with span("eval", epoch=self.epoch):
            per_batch = [self.eval_step(self.state, batch)
                         for batch in self.eval_loader]
            host_counts = fetch_scalars(per_batch)
        self._beat_touch("eval")
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
        self._beat_touch("checkpoint")
        faults.maybe_fire("checkpoint", step=step)
        with span("checkpoint", step=step, best=is_best):
            self.ckpt.save(step, self.state,
                           metrics={BEST_METRIC: self.best_value},
                           is_best=is_best, topology=self._topology())
        if faults.consume("ckpt_corrupt", "checkpoint", step=step):
            # flush FIRST so the checksums record the intact files: the
            # bit flip after the commit is the silent on-disk corruption
            # the verified restore must catch
            self.ckpt.flush()
            hit = faults.corrupt_checkpoint(self.ckpt.directory, step)
            self.logger.warning(
                f"fault: corrupted checkpoint step {step} "
                f"({len(hit)} file(s))")
        self.callbacks.fire("on_checkpoint", self, step=step)

    def _topology(self) -> Dict[str, Any]:
        """The checkpoint sidecar's fingerprint: what a cross-topology
        resume reports it reshards from."""
        from ..elastic.topology import current_topology
        return current_topology(state=self.state,
                                weight_update=self.weight_update)

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
