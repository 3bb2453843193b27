"""The port's task CLI (deeplearning_tpu_torch/train/task.py) against the
JAX package's (tools/train_task.py), on the CPU.

Each of the seven tasks runs JAX's runner as it is, at the sizes of
tests/test_train_task_cli.py and 3 steps; its initial parameters are taken
where JAX's ``_loop`` receives them (``MADSampler.grad_mask`` for the
online task), converted, and the port's task trains from them on the
same synthetic data. The losses agree within 1e-4 relative: JAX's first
and last (step 0 and step 2, after two Adam updates), and all three of
the online task, whose block picks follow the losses. MAE's mask noise is
made from the masks JAX draws at each step (kept tokens first, in index
order: the encoder is token-order free and the decoder restores the
order). Then the CLI itself: ``python -m deeplearning_tpu_torch.train.task``
runs every task and prints its ``task_metric``, MAE also with the naive
attention, and an unknown task exits.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.config import config_cli as jconfig_cli
from deeplearning_tpu.models.stereo import madnet as jmadnet
from deeplearning_tpu_torch.core.config import config_cli
from deeplearning_tpu_torch.train import task as ptask
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import train_task as jtask  # noqa: E402

LOSS_RTOL = 1e-4
# tests/test_train_task_cli.py's sizes, at 3 steps
TASKS = [
    ("segmentation", ["model.image_size=32", "data.batch=2"]),
    ("mae", ["model.image_size=32", "data.batch=2"]),
    ("supcon", ["model.image_size=32", "data.batch=8"]),
    ("metric", ["model.image_size=32", "data.batch=8",
                "model.num_classes=4"]),
    ("keypoints", ["model.image_size=64", "data.batch=2"]),
    ("stereo", ["model.image_size=64"]),
    ("stereo_online", ["model.image_size=64", "data.batch=1",
                       "train.lr=1e-4"]),
]


def _jax_run(task, overrides, monkeypatch):
    """JAX's runner as it is; returns (initial params as numpy, the
    losses it reports, the JAX config)."""
    argv = ["--task", task] + overrides + ["train.steps=3"]
    cfg = jconfig_cli(jtask.TaskConfig(), argv[2:])
    seen = {}
    if task == "stereo_online":
        class Spy(jmadnet.MADSampler):
            def grad_mask(self, params, selected):
                seen.setdefault("params", jax.tree.map(np.asarray, params))
                return super().grad_mask(params, selected)

            def update(self, selected, loss):
                seen.setdefault("losses", []).append(loss)
                super().update(selected, loss)
        monkeypatch.setattr(jmadnet, "MADSampler", Spy)
    else:
        real = jtask._loop

        def spy(loss_fn, params, steps, lr):
            seen["params"] = jax.tree.map(np.asarray, params)
            out = real(loss_fn, params, steps, lr)
            seen["losses"] = [out[1], out[2]]
            return out
        monkeypatch.setattr(jtask, "_loop", spy)
    assert jtask.main(argv) == 0          # its compile cache on, as run
    return seen["params"], seen["losses"], cfg


def _mae_noise(cfg, params):
    """Step i's noise for the port: JAX's mask at step i (the same rngs
    its runner passes), kept tokens first in index order."""
    from deeplearning_tpu.core.registry import MODELS
    s = max(cfg.model.image_size, 32)
    x = jnp.asarray(np.random.default_rng(cfg.train.seed).normal(
        size=(cfg.data.batch, s, s, 3)), jnp.float32)
    model = MODELS.build("mae_vit_small_patch16", dtype=jnp.float32,
                         depth=2, decoder_depth=2)
    apply = jax.jit(lambda p, i: model.apply(
        {"params": p}, x, train=True,
        rngs={"masking": jax.random.fold_in(jax.random.key(5), i),
              "dropout": jax.random.fold_in(jax.random.key(6), i)})[2])

    def noise(i):
        m = np.asarray(apply(params, i), np.float32)
        return torch.from_numpy(m + np.arange(m.shape[1]) / (2 * m.shape[1])
                                ).float()
    return noise


@pytest.mark.parametrize("task,overrides", TASKS, ids=[t for t, _ in TASKS])
def test_task_step_matches_jax_loop(task, overrides, monkeypatch, capsys):
    params, want, jcfg = _jax_run(task, overrides, monkeypatch)
    cfg = config_cli(ptask.TaskConfig(), overrides + [
        "train.steps=3", "train.device=cpu"])
    noise = _mae_noise(jcfg, params) if task == "mae" else None
    got = ptask.run(task, cfg, weights={"params": params}, mask_noise=noise)
    if task != "stereo_online":
        got = [got[0], got[-1]]
    out = capsys.readouterr().out
    assert out.count("task_metric") == 2, out
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0,
                               err_msg=task)


@pytest.mark.parametrize("task,overrides", TASKS, ids=[t for t, _ in TASKS])
def test_cli_main_runs_every_task(task, overrides, capsys):
    rc = ptask.main(["--task", task, "train.device=cpu", "train.steps=2"]
                    + overrides)
    out = capsys.readouterr().out
    assert rc == 0 and "task_metric" in out, out


def _module_cli(*args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run(
        [sys.executable, "-m", "deeplearning_tpu_torch.train.task", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_module_entry_point_and_attention_option():
    """``-m`` runs MAE with the naive attention (the model's own softmax
    path) and prints its metric; an unknown task exits non-zero."""
    done = _module_cli("--task", "mae", "train.device=cpu", "train.steps=2",
                       "model.image_size=32", "data.batch=2",
                       "model.attn=naive")
    assert done.returncode == 0, done.stderr[-2000:]
    assert "task_metric mae_recon_loss=" in done.stdout
    with pytest.raises(SystemExit):
        ptask.main(["--task", "nope", "train.device=cpu"])
    done = _module_cli("--task", "nope")
    assert done.returncode != 0 and "--task must be one of" in done.stderr
