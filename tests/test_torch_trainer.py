"""The port's Trainer, checkpoints and train CLI (deeplearning_tpu_torch/
train/{trainer,__main__}, core/checkpoint, TrainState.state_dict) vs the
JAX package, on the CPU.

- A 2-layer, width-32 ViT (float32, JAX matmuls at the highest precision,
  tests/conftest.py) converted with ``from_flax_params`` and trained for 2
  epochs by the port's Trainer and by the JAX Trainer on the same numpy
  batches: the same hooks in the same order, every logged loss and the
  eval results within 1e-4 (relative; SGD with momentum, so differences of
  float32 rounding stay that size over 8 steps).
- The port's own contracts: ``FloatingPointError`` within
  ``metrics_lag + log_every`` steps of a NaN batch; checkpoints with a
  ``best`` copy; a run stopped after epoch 1 and resumed ends bit-equal to
  an uninterrupted one; a flipped byte in the newest step falls back to
  the one before; ``throughput() > 0`` (no assertion reads a clock); the
  CLI trains on the CPU and names the slice of each later option.
- The robust half: ``nan@step:3`` with rollback through both Trainers
  gives equal ``stats()`` and final parameters within 1e-4; the abort
  mode and an exhausted budget raise ``FloatingPointError``;
  ``ckpt_corrupt`` resumes from the intact step; a ``request()`` and a
  SIGTERM each checkpoint and raise ``Preempted`` (the CLI exits 75);
  async checkpoints equal sync ones, wait for each other and flush on
  ``close()``; a failed first write is retried, recorded and committed
  as by the JAX manager; ``lr_range_test`` gives JAX's rates and suggestion, and
  smoothed losses within 1e-4.
"""

import dataclasses
import functools
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.data import ArraySource as JArraySource
from deeplearning_tpu.data import DataLoader as JDataLoader
from deeplearning_tpu.elastic import faults as jfaults
from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import make_eval_step as j_make_eval_step
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu.train.lr_finder import lr_range_test as j_lr_range_test
from deeplearning_tpu.train.recovery import RecoveryPolicy as JPolicy
from deeplearning_tpu.train.trainer import Trainer as JTrainer
from deeplearning_tpu_torch.core.checkpoint import (CheckpointManager,
                                                    load_pytree, save_pytree)
from deeplearning_tpu_torch.data import ArraySource, DataLoader
from deeplearning_tpu_torch.elastic import Preempted
from deeplearning_tpu_torch.elastic import faults as tfaults
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.obs import flight as tflight
from deeplearning_tpu_torch.ops.attention import get_attn_fn
from deeplearning_tpu_torch.train import TrainState, make_eval_step
from deeplearning_tpu_torch.train import make_train_step
from deeplearning_tpu_torch.train import __main__ as cli
from deeplearning_tpu_torch.train import classification as tcls
from deeplearning_tpu_torch.train import optim as toptim
from deeplearning_tpu_torch.train.lr_finder import lr_range_test
from deeplearning_tpu_torch.train.recovery import RecoveryPolicy
from deeplearning_tpu_torch.train.trainer import HOOKS, Callbacks, Trainer
from deeplearning_tpu_torch.utils.convert import from_flax_params
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32,
            depth=2, num_heads=2)
N, BATCH = 32, 8
BACKENDS = ("csv", "jsonl")           # no TensorBoard import in the tests


@pytest.fixture(scope="module")
def jparams():
    model = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)["params"])


def _data(seed=0, nan_at=None):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(N, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, N).astype(np.int32)
    if nan_at is not None:
        images[nan_at] = np.nan
    return images, labels


def _port_trainer(jparams, *, images=None, labels=None, attn="flash_hb",
                  epochs=2, **kw):
    if images is None:
        images, labels = _data()
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                   attn_fn=get_attn_fn(attn))
    model.load_state_dict(from_flax_params(jparams))
    tx = toptim.build_optimizer("sgd", 0.05, weight_decay=1e-4,
                                params=dict(model.named_parameters()))
    kw.setdefault("log_backends", BACKENDS)
    return Trainer(
        state=TrainState.create(model=model, tx=tx),
        train_step=make_train_step(tcls.make_loss_fn(label_smoothing=0.1),
                                   device="cpu"),
        train_loader=DataLoader(ArraySource(image=images, label=labels),
                                BATCH, seed=0),
        eval_step=make_eval_step(tcls.make_metric_fn(), device="cpu"),
        eval_loader=DataLoader(ArraySource(image=images, label=labels),
                               BATCH, shuffle=False),
        epochs=epochs, **kw)


def _recorder(trainer, events):
    cb = trainer.callbacks
    for hook in HOOKS:
        cb.register(hook, functools.partial(
            lambda name, t, **kw: events.append(name), hook))


def _jax_trainer(jparams, **kw):
    images, labels = _data()
    jtx = optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(0.05, 0.9))
    jstate = JTrainState.create(
        apply_fn=jvit.VisionTransformer(**TINY, dtype=jnp.float32).apply,
        params=jax.tree.map(jnp.asarray, jparams), tx=jtx)
    return JTrainer(
        state=jstate,
        train_step=j_make_train_step(jcls.make_loss_fn(label_smoothing=0.1),
                                     donate=False),
        train_loader=JDataLoader(JArraySource(image=images, label=labels),
                                 BATCH, seed=0),
        eval_step=j_make_eval_step(jcls.make_metric_fn()),
        eval_loader=JDataLoader(JArraySource(image=images, label=labels),
                                BATCH, shuffle=False),
        epochs=2, obs=False, preemptible=False, heartbeat=None,
        metrics_port=None, retrace_warn=False, **kw)


def test_trainer_matches_the_jax_trainer(jparams):
    jtrainer = _jax_trainer(jparams, log_every=2)
    trainer = _port_trainer(jparams, log_every=2, obs=True)
    jevents, tevents = [], []
    _recorder(jtrainer, jevents)
    _recorder(trainer, tevents)
    jlosses = []
    jtrainer.callbacks.register("after_iter", lambda t, metrics:
                                jlosses.append(metrics["loss"]))
    tflight.get_recorder().clear()
    jtrainer.train()
    trainer.train()
    logged = [e["metrics"]["loss"]
              for e in tflight.get_recorder().events("step")]
    assert tevents == jevents and tevents[0] == "before_train"
    assert len(logged) == len(jlosses) == 8
    np.testing.assert_allclose(logged, [float(x) for x in jlosses],
                               rtol=1e-4)
    assert trainer.eval_fetches == jtrainer.eval_fetches == 2
    assert set(trainer._last_eval) == set(jtrainer._last_eval)
    for k, v in jtrainer._last_eval.items():
        np.testing.assert_allclose(trainer._last_eval[k], v, rtol=1e-4,
                                   err_msg=k)
    assert trainer.best_value == pytest.approx(jtrainer.best_value)
    assert trainer.state.step == int(jtrainer.state.step) == 8


def test_nan_batch_aborts_within_the_lag(jparams):
    """A NaN in batch 1 of epoch 0 (sequential order) raises within
    metrics_lag + log_every steps of it."""
    images, labels = _data(nan_at=BATCH + 1)
    ran = []
    trainer = _port_trainer(jparams, images=images, labels=labels,
                            attn="naive", epochs=4, log_every=2,
                            metrics_lag=1)
    trainer.train_loader.shuffle = False
    trainer.callbacks.register("after_iter",
                               lambda t, metrics: ran.append(t.host_step))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.train()
    assert 2 <= len(ran) <= 2 + 1 + 2


def test_checkpoints_best_resume_and_corrupt_fallback(jparams, tmp_path):
    full = _port_trainer(jparams, attn="naive", log_every=2,
                         workdir=str(tmp_path / "full"))
    full.train()
    ckpt = tmp_path / "full" / "ckpt"
    assert full.ckpt.all_steps() == [4, 8] and (ckpt / "best").is_dir()
    assert (ckpt / "checksums.json").is_file()
    assert (tmp_path / "full" / "trace.json").is_file()

    class Stop(Exception):
        pass

    def stop(trainer, step):
        if step == 4:
            raise Stop

    wd = str(tmp_path / "stopped")
    first = _port_trainer(jparams, attn="naive", log_every=2, workdir=wd)
    first.callbacks.register("on_checkpoint", stop)
    with pytest.raises(Stop):
        first.train()
    assert first.ckpt.all_steps() == [4]
    resumed = _port_trainer(jparams, attn="naive", log_every=2, workdir=wd)
    resumed.train()
    assert resumed.state.step == 8 and resumed.epoch == 1
    for name, p in full.state.params.items():
        assert torch.equal(resumed.state.params[name], p), name
    # a flipped byte in the newest step: verified restore walks back
    path = os.path.join(wd, "ckpt", "8", "state.pt")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    fresh = _port_trainer(jparams, attn="naive", workdir=wd)
    state, step = fresh.ckpt.auto_resume(fresh.state)
    assert step == 4 and state.step == 4
    assert os.path.isdir(os.path.join(wd, "ckpt", "corrupt-8"))
    assert fresh.ckpt.all_steps() == [4]


def test_state_dict_round_trip_and_pytrees(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    tx = toptim.build_optimizer("adamw", 0.1,
                                params=dict(model.named_parameters()))
    state = TrainState.create(model=model, tx=tx, use_ema=True,
                              batch_stats=dict(model.named_buffers()))
    model.train()
    model(torch.randn(5, 3))               # moves the BN statistics
    state.apply_gradients({n: torch.ones_like(p)
                           for n, p in state.params.items()})
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    mgr.save(1, state, metrics={"top1": 0.5})
    mgr.save(2, state)
    assert mgr.all_steps() == [2] and mgr.verify_step(2)
    other = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    restored = TrainState.create(
        model=other, tx=toptim.build_optimizer(
            "adamw", 0.1, params=dict(other.named_parameters())),
        use_ema=True, batch_stats=dict(other.named_buffers()))
    assert mgr.restore(restored) is restored and restored.step == 1
    for a, b in ((state.model.state_dict(), other.state_dict()),
                 (state.ema_params, restored.ema_params)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert restored.opt_state[0]["count"] == 1
    assert torch.equal(restored.opt_state[0]["mu"]["0.weight"],
                       state.opt_state[0]["mu"]["0.weight"])
    save_pytree(str(tmp_path / "tree"), {"w": torch.arange(3)})
    assert torch.equal(load_pytree(str(tmp_path / "tree"))["w"],
                       torch.arange(3))
    assert load_pytree(str(tmp_path / "ck" / "2"))["step"] == 1
    with pytest.raises(ValueError, match="EMA"):
        TrainState.create(model=torch.nn.Sequential(
            torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4)), tx=tx
        ).load_state_dict(state.state_dict())


def test_hooks_prefetch_precompile_and_throughput(jparams):
    with pytest.raises(KeyError, match="Unknown hook"):
        Callbacks().register("on_step", lambda t: None)
    trainer = _port_trainer(jparams, attn="naive", prefetch=2)
    # prefetch=2 wraps any loader; "auto" only one with a device
    assert type(trainer.train_loader).__name__ == "DevicePrefetcher"
    assert type(_port_trainer(jparams).train_loader).__name__ == "DataLoader"
    assert trainer.precompile() is None
    assert trainer.train_loader._active is not None
    assert trainer.throughput(n_iters=3, lag=1) > 0
    stats = trainer.throughput_stats
    assert stats["batch"] == BATCH and stats["batches_fed"] > 0
    with pytest.raises(ValueError):
        trainer.throughput(n_iters=1)


def test_metrics_port_answers_during_train(jparams, tmp_path, monkeypatch):
    """``metrics_port=0`` serves /metrics, /metrics.json and /healthz
    beside the loop (the lagged train scalars, the feed's stats, the
    memory sampler's gauges), advertised in DLTPU_ENDPOINT_FILE, and
    stops with the run; the losses are the run's without it."""
    import urllib.request
    from deeplearning_tpu_torch.obs import metrics as tmetrics
    ep = tmp_path / "endpoint.json"
    monkeypatch.setenv("DLTPU_ENDPOINT_FILE", str(ep))
    trainer = _port_trainer(jparams, obs=True, metrics_port=0,
                            hbm_sample_s=0.01, prefetch=2, heartbeat=None,
                            preemptible=False, log_every=2)
    seen = {}

    def scrape(t, **kw):
        if t.epoch == 1 and "text" not in seen:
            url = json.loads(ep.read_text())["url"]
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                seen["text"] = r.read().decode()
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                seen["health"] = json.loads(r.read())
            seen["url"] = url
    trainer.callbacks.register("before_iter", scrape)
    trainer.train()
    text = seen["text"]
    assert "dltpu_train_step" in text and "dltpu_train_loss" in text
    assert "dltpu_hbm_peak_bytes_in_use" in text
    assert "dltpu_feed_" in text
    assert seen["health"]["status"] == "ready"
    assert trainer.hbm_watermark["hbm_samples"] >= 1
    assert tmetrics.get_registry() is None        # the Trainer's own, gone
    with pytest.raises(OSError):
        urllib.request.urlopen(seen["url"] + "/metrics", timeout=2)
    plain = _port_trainer(jparams, heartbeat=None, preemptible=False,
                          log_every=2, prefetch=2)
    plain.train()
    assert trainer.meters.loss.avg == plain.meters.loss.avg
    want = plain.state.model.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in trainer.state.model.state_dict().items())


# ---------------------------------------------------------------- the CLI
CLI_TINY = ["train.device=cpu", "model.name=vit_micro_patch4_56",
            "data.image_size=16", "data.channels=3", "data.n_train=16",
            "data.global_batch=8", "train.epochs=1", "model.precision=f32"]


def test_cli_trains_two_steps_on_the_cpu(capsys, tmp_path):
    assert cli.main(CLI_TINY + [f"train.workdir={tmp_path}",
                                "train.ema=true", "train.mixup=true",
                                "train.accum_steps=2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    results = eval(out)                  # the JAX CLI's printed dict
    assert set(results) == {"top1", "top5", "loss_sum"}
    assert os.path.isdir(tmp_path / "ckpt" / "2")


def test_cli_npz_source_and_its_validation_split(tmp_path):
    """An .npz of uint8 single-channel images: the JAX CLI's split (a
    seeded permutation, at least one eval batch) and per-sample uint8 ->
    float32 in [0, 1] with the channel repeated to 3."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (40, 16, 16), dtype=np.uint8)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    np.savez(tmp_path / "d.npz", images=images, labels=labels)
    from deeplearning_tpu_torch.core.config import load_config
    cfg = load_config(cli.Config(), opts=CLI_TINY + [
        f"data.npz={tmp_path / 'd.npz'}", "data.val_rate=0.25"])
    trainer = cli.build(cfg)
    order = np.random.default_rng(0).permutation(40)
    assert len(trainer.train_loader) == 3 and len(trainer.eval_loader) == 1
    batch = next(iter(trainer.eval_loader))
    want = np.repeat(images[order[:8], ..., None], 3, -1) / np.float32(255)
    np.testing.assert_array_equal(batch["image"].numpy(), want)
    np.testing.assert_array_equal(batch["label"].numpy(),
                                  labels[order[:8]])
    trainer.train()
    assert trainer.state.step == 3


def test_cli_data_and_defaults_are_the_jax_clis(monkeypatch):
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(os.path.dirname(__file__), "..",
                                      "tools", "train.py"))
    jcli = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, jcli)
    spec.loader.exec_module(jcli)
    for section in ("model", "data", "optim", "train"):
        want = dataclasses.asdict(getattr(jcli.Config(), section))
        got = dataclasses.asdict(getattr(cli.Config(), section))
        extra = {"model": {"attn"}, "train": {"device"}}.get(section, set())
        gone = {"train": {"donate_batch"}}.get(section, set())
        assert set(got) - set(want) == extra and set(want) - set(got) == gone
        assert all(got[k] == want[k] for k in set(got) & set(want))
    cfg = cli.DataCfg(image_size=12, channels=3, n_train=20)
    for a, b in zip(cli.load_data(cfg, 4), jcli.load_data(cfg, 4)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("opt,error", [
    ("train.strict=threads", "item 8"), ("train.strict=all", "item 8"),
    # item 7c's model axis now runs: at one process JAX's mesh error
    pytest.param("train.mesh_model_axis=2",
                 "1 devices not divisible by fixed axes 2",
                 id="train.mesh_model_axis=2-item 7c"),
    ("train.mesh_seq_axis=2", "1 devices not divisible by fixed axes 2"),
    ("train.seq_parallel=ulysses", None),
    ("train.pipeline_stages=2", "1 devices not divisible by fixed axes 2"),
    ("train.microbatches=4", None), ("train.weight_update=zero1", None),
    ("train.grad_comm=int8", None)])
def test_cli_later_slice_options_name_their_slice(opt, error, tmp_path,
                                                  capsys):
    """At a one-process world: strict threads / all name item 8; a model
    or seq axis or pipeline stages of two need two ranks (JAX's mesh
    error, from a gloo world the CLI starts and destroys); train.seq_parallel without a seq axis and train.microbatches
    without stages run as JAX's CLI runs them; ZeRO-1 and the int8
    gradient collectives run: a one-process gloo world, the mesh step, and
    a checkpoint whose topology sidecar names the weight-update mode (the
    process group is gone after the run)."""
    import torch.distributed as dist
    if error is not None:
        with pytest.raises(ValueError, match=error):
            cli.main(CLI_TINY + [opt])
        assert not dist.is_initialized()
        return
    assert cli.main(CLI_TINY + [opt, f"train.workdir={tmp_path}"]) == 0
    assert not dist.is_initialized()
    assert "top1" in capsys.readouterr().out.strip().splitlines()[-1]
    with open(tmp_path / "ckpt" / "topology.json") as f:
        (step, doc), = json.load(f).items()
    assert int(step) == 2 and doc["process_count"] == 1
    # the mesh runs record their weight-update mode; the others no mesh
    assert doc.get("weight_update") == {
        "train.weight_update=zero1": "zero1",
        "train.grad_comm=int8": "replicated"}.get(opt)


def test_cli_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([a for a in CLI_TINY if a != "train.device=cpu"])
    # the default model, mnist_cnn (item 8a), trains on the CPU
    assert cli.main(["train.device=cpu", "data.n_train=64",
                     "train.epochs=1"]) == 0


# ------------------------------------------------------- the robust half
@pytest.fixture
def fault_env(monkeypatch):
    """Set ``DLTPU_FAULTS`` for both packages' fault modules, each of
    which parses it once; reset after the test."""
    def arm(spec):
        monkeypatch.setenv(tfaults.ENV_VAR, spec)
        monkeypatch.delenv(tfaults.ATTEMPT_VAR, raising=False)
        jfaults.reset()
        tfaults.reset()
    yield arm
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    jfaults.reset()
    tfaults.reset()


def test_nan_rollback_matches_the_jax_trainer(jparams, fault_env):
    """nan@step:3: both Trainers roll back to the same verified anchor,
    skip the same window, replay under the same reseeded order and damp
    the same cooldown steps."""
    fault_env("nan@step:3")
    jtrainer = _jax_trainer(jparams, log_every=2, metrics_lag=1,
                            recovery=JPolicy(anchor_every=2,
                                             cooldown_steps=2))
    jtrainer.train()
    fault_env("nan@step:3")
    trainer = _port_trainer(jparams, log_every=2, metrics_lag=1,
                            recovery=RecoveryPolicy(anchor_every=2,
                                                    cooldown_steps=2))
    trainer.train()
    stats = trainer._recovery.stats()
    assert stats == jtrainer._recovery.stats() and stats["rollbacks"] == 1
    anchor, bad = stats["skipped_windows"][0]
    assert anchor < 3 < bad
    assert trainer.state.step == int(jtrainer.state.step)
    want = from_flax_params(jax.tree.map(np.asarray, jtrainer.state.params))
    for name, p in trainer.state.params.items():
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("spec,recovery,rollbacks", [
    ("nan@step:3", None, None),
    ("nan@step:2;nan@step:2;nan@step:2",
     RecoveryPolicy(anchor_every=1, max_recoveries=1, cooldown_steps=0), 1)])
def test_abort_and_an_exhausted_budget_raise(jparams, fault_env, spec,
                                             recovery, rollbacks):
    fault_env(spec)
    trainer = _port_trainer(jparams, attn="naive", epochs=4, log_every=1,
                            metrics_lag=1, recovery=recovery)
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train()
    if rollbacks is not None:
        assert trainer._recovery.rollbacks == rollbacks


def test_ckpt_corrupt_fault_resumes_from_the_intact_step(jparams, fault_env,
                                                         tmp_path):
    fault_env("ckpt_corrupt@checkpoint:5")
    wd = str(tmp_path)
    trainer = _port_trainer(jparams, attn="naive", log_every=2, workdir=wd)
    trainer.train()                      # saves 4 and 8; 8 is garbled
    assert not trainer.ckpt.verify_step(8) and trainer.ckpt.verify_step(4)
    fresh = _port_trainer(jparams, attn="naive", workdir=wd)
    state, step = fresh.ckpt.auto_resume(fresh.state)
    assert step == 4 and state.step == 4


@pytest.mark.parametrize("how", ["request", "sigterm"])
def test_preemption_checkpoints_and_raises(jparams, tmp_path, how):
    wd = str(tmp_path)
    trainer = _port_trainer(jparams, attn="naive", log_every=2, workdir=wd,
                            heartbeat=str(tmp_path / "hb.json"))

    def preempt_at_3(t, metrics):
        if t.host_step == 3:
            if how == "request":
                t.preempt_guard.request()
            else:
                os.kill(os.getpid(), signal.SIGTERM)
    trainer.callbacks.register("after_iter", preempt_at_3)
    with pytest.raises(Preempted) as info:
        trainer.train()
    assert info.value.step == 3 and trainer.preempt_guard is None
    assert trainer.ckpt.latest_step() == 3 and trainer.ckpt.verify_step(3)
    doc = json.load(open(tmp_path / "flightrec.json"))
    assert doc["reason"] == "preempted"
    assert json.load(open(tmp_path / "hb.json"))["step"] >= 3
    resumed = _port_trainer(jparams, attn="naive", log_every=2, workdir=wd)
    seen = []
    resumed.callbacks.register("before_train",
                               lambda t: seen.append(t.state.step))
    resumed.train()
    # step 3 lies in epoch 0, which is replayed whole (as in JAX)
    assert seen == [3] and resumed.state.step == 3 + 2 * 4


def test_cli_exits_75_on_a_sigterm(fault_env, tmp_path):
    fault_env("sigterm@step:1")
    assert cli.main(CLI_TINY + [f"train.workdir={tmp_path}"]) == 75
    assert os.path.isdir(tmp_path / "ckpt" / "1")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_async_checkpoints_equal_sync_ones(jparams, tmp_path):
    runs = {}
    for mode in (False, True):
        wd = str(tmp_path / f"async{int(mode)}")
        trainer = _port_trainer(jparams, attn="naive", log_every=2,
                                workdir=wd, async_checkpoint=mode)
        trainer.train()
        assert trainer.ckpt.all_steps() == [4, 8]
        assert all(trainer.ckpt.verify_step(s) for s in (4, 8))
        runs[mode] = wd
    for step in (4, 8, "best"):
        a, b = (torch.load(os.path.join(runs[m], "ckpt", str(step),
                                        "state.pt")) for m in (False, True))
        ta, tb = _tensors(a), _tensors(b)
        assert a["step"] == b["step"] and len(ta) == len(tb) > 50
        assert all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_async_save_waits_for_the_last_and_close_flushes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True, max_to_keep=5)
    spans_ = []
    write = mgr._write_step

    def slow(step, tree, metrics):
        t0 = time.monotonic()
        time.sleep(0.1)
        write(step, tree, metrics)
        spans_.append((step, t0, time.monotonic()))
    mgr._write_step = slow
    w = torch.zeros(3)
    mgr.save(1, {"w": w}, is_best=True)
    w += 1                               # the snapshot was taken already
    assert mgr.latest_step() == 1 and mgr.all_steps() == []
    mgr.save(2, {"w": w})
    mgr.close()
    assert [s for s, *_ in spans_] == [1, 2]
    assert spans_[1][1] >= spans_[0][2]          # 2 began after 1 landed
    assert mgr.all_steps() == [1, 2] and mgr._writer is None
    assert torch.equal(mgr.restore({"w": None}, step=1)["w"],
                       torch.zeros(3))
    assert torch.equal(load_pytree(str(tmp_path / "best"))["w"],
                       torch.zeros(3))


@pytest.mark.parametrize("async_save", [False, True])
def test_failed_write_is_retried_as_in_jax(tmp_path, monkeypatch,
                                           async_save):
    """The first write raises in both managers: each records one
    ``ckpt_retry``, retries after the backoff and commits the step with
    the same values and checksum verdict."""
    from deeplearning_tpu.core.checkpoint import CheckpointManager as JMgr
    from deeplearning_tpu.obs import flight as jflight
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    err = RuntimeError("disk full")

    def once(fn):
        calls = []

        def failing(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise err
            return fn(*args, **kwargs)
        return failing

    jmgr = JMgr(str(tmp_path / "jax"), save_retries=1)
    monkeypatch.setattr(jmgr._mgr, "save", once(jmgr._mgr.save))
    tmgr = CheckpointManager(str(tmp_path / "port"), save_retries=1,
                             async_save=async_save)
    monkeypatch.setattr(torch, "save", once(torch.save))
    recs = []
    for fl, mgr, tree in ((jflight, jmgr, {"w": jnp.asarray(w)}),
                          (tflight, tmgr, {"w": torch.from_numpy(w)})):
        fl.get_recorder().clear()
        mgr.save(3, tree)
        mgr.close()
        recs.append([(e["kind"], e["step"], e["attempt"], e["error"])
                     for e in fl.get_recorder().events("ckpt_retry")])
        assert mgr.verify_step(3)
    assert recs[0] == recs[1] == [("ckpt_retry", 3, 1, repr(err))]
    assert jmgr._mgr.all_steps() == tmgr.all_steps() == [3]
    got = tmgr.restore({"w": None}, step=3)["w"].numpy()
    want = np.asarray(jmgr.restore({"w": jnp.zeros((2, 3))}, step=3)["w"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, w)


def test_lr_range_test_matches_jax(jparams):
    images, labels = _data()
    batches = [{"image": images[i:i + 4], "label": labels[i:i + 4]}
               for i in range(0, 32, 4)]

    def jstate(schedule):
        return JTrainState.create(
            apply_fn=jvit.VisionTransformer(**TINY, dtype=jnp.float32).apply,
            params=jax.tree.map(jnp.asarray, jparams),
            tx=optax.sgd(schedule, momentum=0.0))

    def tstate(schedule):
        model = tvit.VisionTransformer(**TINY, dtype=torch.float32)
        model.load_state_dict(from_flax_params(jparams))
        return TrainState.create(model=model, tx=toptim.build_optimizer(
            "sgd", schedule, momentum=0.0,
            params=dict(model.named_parameters())))
    want = j_lr_range_test(
        jstate, lambda s: j_make_train_step(jcls.make_loss_fn(),
                                            donate=False),
        batches, min_lr=1e-3, max_lr=0.5)
    got = lr_range_test(
        tstate, lambda s: make_train_step(tcls.make_loss_fn(),
                                          device="cpu"),
        batches, min_lr=1e-3, max_lr=0.5)
    np.testing.assert_array_equal(got["lrs"], want["lrs"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["suggestion"] == want["suggestion"]


def test_cli_takes_the_robust_options_and_a_folder(tmp_path):
    """data.folder (class folders of .npy images), data.num_workers,
    data.augment, train.recovery=rollback, train.strict and
    train.async_checkpoint train on the CPU."""
    rng = np.random.default_rng(0)
    for c in range(3):
        os.makedirs(tmp_path / "data" / f"c{c}")
        for i in range(8):
            np.save(tmp_path / "data" / f"c{c}" / f"{i}.npy",
                    rng.integers(0, 256, (20, 20, 3), dtype=np.uint8))
    opts = [o for o in CLI_TINY if not o.startswith("data.n_train")]
    assert cli.main(opts + [
        f"data.folder={tmp_path / 'data'}", "model.num_classes=3",
        "data.num_workers=2", "data.augment=light",
        "train.recovery=rollback", "train.strict=transfers,nans",
        "train.async_checkpoint=true",
        f"train.workdir={tmp_path / 'run'}"]) == 0
    assert os.path.isdir(tmp_path / "run" / "ckpt" / "2")
    assert json.load(open(tmp_path / "run" / "class_indices.json")) == {
        "0": "c0", "1": "c1", "2": "c2"}
    with pytest.raises(ValueError, match="3 classes"):
        cli.main(opts + [f"data.folder={tmp_path / 'data'}"])
