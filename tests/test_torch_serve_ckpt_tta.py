"""The rest of the port's serving surface vs the JAX package, on the CPU at
a tiny size: checkpoint restore (``restore_variables``), loading at
another image size (``surgical_load`` and the resize functions),
test-time augmentation (``ops/tta.py``, the engine's ``tta``, the
detection CLI's ``train.eval_tta``), the batcher's heartbeat and
preempt / crash callbacks, and the serve CLI's ``--ckpt``, ``--tta``,
supervision variables and image-file requests.

Float32 on both sides, ``highest`` matmul precision (``conftest.py``),
inputs made from a numpy seed. Tolerances: state dicts and resized tables
exact; logits 1e-4; probabilities 1e-5; resized images 1e-5; YOLOX TTA
from JAX's merged decoded rows: equal keep sets, scores 1e-6.
"""

import functools
import io
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core import checkpoint as jckpt
from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.detection import yolox as jyolox
from deeplearning_tpu.ops import tta as jtta
from deeplearning_tpu.serve import InferenceEngine as JaxEngine
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import checkpoint as tckpt
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.elastic import faults as tfaults
from deeplearning_tpu_torch.elastic import heartbeat as thb
from deeplearning_tpu_torch.obs import flight as tflight
from deeplearning_tpu_torch.obs import metrics as tmetrics
from deeplearning_tpu_torch.obs import spans as tspans
from deeplearning_tpu_torch.ops import tta as ttta
from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
from deeplearning_tpu_torch.serve import __main__ as serve_cli
from deeplearning_tpu_torch.train import detection as tdet
from deeplearning_tpu_torch.train.multiscale import _resize_images
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import serve as jserve_cli  # noqa: E402  (tools/serve.py)

MICRO = "vit_micro_patch4_56"


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _jax_init(jmodel, size, seed=0):
    return jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.key(seed), jnp.zeros((1, size, size, 3)))


def _micro(size, num_classes, seed):
    """JAX and port ``vit_micro_patch4_56`` (two blocks) at ``size``²,
    float32, the port's state dict converted from JAX's init of
    ``seed``."""
    jmodel = JMODELS.build(MICRO, num_classes=num_classes, img_size=size,
                           depth=2, dtype=jnp.float32)
    variables = _jax_init(jmodel, size, seed)
    model = TMODELS.build(MICRO, num_classes=num_classes, img_size=size,
                          depth=2, dtype=torch.float32)
    model.load_state_dict(from_flax_params(variables, like=model))
    return jmodel, variables, model.eval()


def _equal_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------ resize functions, exact
def test_bilinear_resize_and_resize_fns_equal_jax():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(14, 14, 8)).astype(np.float32)
    np.testing.assert_array_equal(tckpt._bilinear_resize(grid, 24, 24),
                                  jckpt._bilinear_resize(grid, 24, 24))
    pos = rng.normal(size=(1, 1 + 14 * 14, 8)).astype(np.float32)
    new = (1, 1 + 24 * 24, 8)
    got = tckpt.resize_vit_pos_embed("pos_embed", pos, new)
    want = jckpt.resize_vit_pos_embed("pos_embed", pos, new)
    assert got.shape == new
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :1], pos[:, :1])   # cls kept
    table = rng.normal(size=(13 * 13, 3)).astype(np.float32)
    name = "layers.0.blocks.0.attn.relative_position_bias_table"
    got = tckpt.resize_relative_position_bias(name, table, (23 * 23, 3))
    want = jckpt.resize_relative_position_bias(name.replace(".", "/"),
                                               table, (23 * 23, 3))
    np.testing.assert_array_equal(got, want)
    for fn in (tckpt.default_resize_fn, jckpt.default_resize_fn):
        np.testing.assert_array_equal(
            fn("pos_embed", pos, new),
            jckpt.resize_vit_pos_embed("pos_embed", pos, new))
        np.testing.assert_array_equal(fn(name, table, (23 * 23, 3)), want)
        # a head, a grid that is not square, another head count: None
        assert fn("head.weight", table, (5, 3)) is None
        assert fn("pos_embed", pos, (1, 1 + 20, 8)) is None
        assert fn(name, table, (23 * 23, 4)) is None


def test_surgical_load_at_another_size_equals_jax():
    _, src_vars, src = _micro(56, 10, seed=0)
    jmodel, dst_vars, dst = _micro(112, 7, seed=1)
    want_tree = jckpt.surgical_load(dst_vars["params"], src_vars["params"],
                                    drop=[r"^head"],
                                    resize_fn=jckpt.default_resize_fn)
    want = from_flax_params(want_tree, like=dst)
    got = tckpt.surgical_load(dst.state_dict(), src.state_dict(),
                              drop=[r"^head"],
                              resize_fn=tckpt.default_resize_fn)
    _equal_state(got, want)
    # the head kept the target's, pos_embed was resized 14² -> 28²
    assert torch.equal(got["head.weight"], dst.state_dict()["head.weight"])
    assert got["pos_embed"].shape == (1, 1 + 28 * 28, 128)
    # rename: a tensor under another name lands there
    moved = tckpt.surgical_load(
        {"a": torch.zeros(3)}, {"b": torch.ones(3), "c": torch.ones(2)},
        rename={"b": "a"})
    assert torch.equal(moved["a"], torch.ones(3))
    dst.load_state_dict(got)
    x = _images(2, 112, seed=3)
    want_logits = np.asarray(jax.jit(functools.partial(
        jmodel.apply, train=False))({"params": want_tree}, jnp.asarray(x)))
    with torch.no_grad():
        logits = dst(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, want_logits, atol=1e-4, rtol=0)


# --------------------------------------------------------- restore_variables
@pytest.fixture(scope="module")
def nano_trees():
    """yolox_nano (it has BatchNorm) at 64²: a seeded flax tree, a second
    seeded params tree as the EMA, and the port's model."""
    jmodel = JMODELS.build("yolox_nano", num_classes=3, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    tree = jax.tree.map(np.asarray, seeded_tree(shapes, seed=0))
    ema = jax.tree.map(np.asarray, seeded_tree(shapes, seed=1))["params"]
    init = jax.tree.map(np.asarray, seeded_tree(shapes, seed=2))
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    return {"tree": tree, "ema": ema, "init": init, "model": model}


def _layouts(t, like):
    """The same checkpoint as the port writes it: a Trainer step's
    ``TrainState.state_dict()`` layout, and a bare state dict."""
    full = from_flax_params(t["tree"], like=like)
    params = from_flax_params(t["tree"]["params"], like=like)
    stats = {k: v for k, v in full.items() if k not in params}
    ema = from_flax_params(t["ema"], like=like)
    return {"trainstate": {"step": 3, "params": params, "buffers": stats,
                           "ema_params": ema, "opt_state": {}},
            "bare": params}


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_restore_variables_equals_jax(nano_trees, tmp_path, prefer_ema):
    t, like = nano_trees, nano_trees["model"]
    jtree = {"step": 3, **t["tree"], "ema_params": t["ema"]}
    jckpt.save_pytree(str(tmp_path / "jax"), jtree)
    jckpt.save_pytree(str(tmp_path / "jax_bare"), t["tree"]["params"])
    init_sd = from_flax_params(t["init"], like=like)
    for layout, tree in _layouts(t, like).items():
        path = str(tmp_path / layout)
        tckpt.save_pytree(path, tree)
        jpath = str(tmp_path / ("jax_bare" if layout == "bare" else "jax"))
        want = from_flax_params(jckpt.restore_variables(
            jpath, t["init"], prefer_ema=prefer_ema), like=like)
        got = tckpt.restore_variables(path, init_sd, prefer_ema=prefer_ema)
        _equal_state(got, want)
    # a bare tree keeps the init statistics; a TrainState-style one brings
    # its own
    key = next(k for k in init_sd if k.endswith("running_mean"))
    stats = _layouts(t, like)["trainstate"]["buffers"]
    assert torch.equal(got[key], init_sd[key])
    assert not torch.equal(stats[key], init_sd[key])


def test_restore_reads_a_trainer_step_and_serves_it(tmp_path):
    """A Trainer step directory (a ``CheckpointManager`` step holding
    ``TrainState.state_dict()`` with EMA) restored through ``hub.load``,
    ``hub.serve``, the engine's ``ckpt`` and the CLI's ``--ckpt``: each
    serves the EMA weights."""
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.state import TrainState
    model = TMODELS.build(MICRO, num_classes=5, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(4))
    state = TrainState.create(model=model, use_ema=True, tx=build_optimizer(
        "adamw", 1e-3, params=dict(model.named_parameters())))
    with torch.no_grad():
        for e in state.ema_params.values():
            e.mul_(0.5)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state)
    mgr.close()
    step_dir = str(tmp_path / "ckpt" / "7")
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    loaded, _ = hub.load(MICRO, num_classes=5, ckpt=step_dir, device="cpu")
    for k, v in ema.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    raw, _ = hub.load(MICRO, num_classes=5, ckpt=step_dir, device="cpu",
                      prefer_ema=False)
    assert torch.equal(raw.state_dict()["head.weight"],
                       model.state_dict()["head.weight"])
    with pytest.raises(ValueError, match="not both"):
        hub.load(MICRO, num_classes=5, ckpt=step_dir, weights={},
                 device="cpu")
    x = _images(3, 56, seed=2)
    mem = InferenceEngine(MICRO, model=loaded, num_classes=5, image_size=56,
                          batch_buckets=(1, 4), device="cpu")
    served = hub.serve(MICRO, num_classes=5, ckpt=step_dir, image_size=56,
                       batch_buckets=(1, 4), device="cpu")
    assert served.stats()["warm"]
    assert served.trace_count == served.compile_count == 2
    np.testing.assert_array_equal(served.infer(x), mem.infer(x))
    prebuilt = InferenceEngine(
        MICRO, model=TMODELS.build(MICRO, num_classes=5), ckpt=step_dir,
        num_classes=5, image_size=56, batch_buckets=(4,), device="cpu")
    np.testing.assert_allclose(prebuilt.infer(x), mem.infer(x), atol=1e-5)


def test_zoo_tenant_ckpt_reaches_its_engine(tmp_path):
    model = TMODELS.build(MICRO, num_classes=5,
                          generator=torch.Generator().manual_seed(6))
    tckpt.save_pytree(str(tmp_path / "w"), model)
    spec = {"v": {"model": MICRO, "ckpt": str(tmp_path / "w"),
                  "image_size": 56, "num_classes": 5, "buckets": [1],
                  "preload": True}}
    args = serve_cli.build_parser().parse_args(
        ["--zoo", json.dumps(spec), "--http", "0", "--device", "cpu"])
    zoo = serve_cli.build_zoo(serve_cli.parse_zoo_spec(args.zoo), args)
    try:
        state = zoo.engine("v").model.state_dict()
        for k, v in model.state_dict().items():
            assert torch.equal(state[k], v), k
    finally:
        zoo.evict("v")
    tmetrics.disable()


# ------------------------------------------------------------------- TTA
def test_boxes_flip_and_descale_exact():
    rng = np.random.default_rng(0)
    b = rng.uniform(0, 100, (2, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        ttta.flip_lr_boxes(torch.from_numpy(b), 96.0).numpy(),
        np.asarray(jtta.flip_lr_boxes(jnp.asarray(b), 96.0)))
    for scale, flip in ((0.83, True), ((0.8, 0.6), False), (1.0, False)):
        np.testing.assert_array_equal(
            ttta.descale_boxes(torch.from_numpy(b), scale, flip,
                               80.0).numpy(),
            np.asarray(jtta.descale_boxes(jnp.asarray(b), scale, flip,
                                          80.0)))


def test_classify_tta_and_the_tta_engine_equal_jax():
    jmodel, variables, model = _micro(56, 10, seed=0)
    x = _images(3, 56, seed=5)
    want = np.asarray(jax.jit(lambda v, im: jtta.classify_tta(
        lambda y: jmodel.apply(v, y, train=False), im))(variables,
                                                         jnp.asarray(x)))
    with torch.no_grad():
        got = ttta.classify_tta(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jeng = JaxEngine(model=jmodel, variables=variables, image_size=56,
                     batch_buckets=(1, 4), tta=True,
                     use_compile_cache=False)
    eng = InferenceEngine(model=model, image_size=56, batch_buckets=(1, 4),
                          tta=True, device="cpu")
    np.testing.assert_allclose(eng.infer(x), jeng.infer(x), atol=1e-5,
                               rtol=0)
    assert eng.trace_count == eng.compile_count == 2
    assert eng.stats()["tta"]
    plain = InferenceEngine(model=model, image_size=56, batch_buckets=(4,),
                            device="cpu")
    assert not np.allclose(plain.infer(x), eng.infer(x), atol=1e-5)


@pytest.fixture(scope="module")
def tta_nano():
    """yolox_nano at 160² (views 160, 128 flipped, 96) on one seeded tree,
    and JAX's yolox_tta on two seeded images with the merged decoded rows
    it handed its postprocess."""
    jmodel = JMODELS.build("yolox_nano", num_classes=3, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 160, 160, 3)))
    variables = jax.tree.map(np.asarray, seeded_tree(shapes, seed=3))
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    model.load_state_dict(from_flax_params(variables, like=model))
    x = np.random.default_rng(4).uniform(0, 1, (2, 160, 160, 3)).astype(
        np.float32)
    seen = {}
    orig = jyolox.postprocess_decoded

    def capture(decoded, **kw):
        seen["decoded"] = np.asarray(decoded)
        return orig(decoded, **kw)
    apply = jax.jit(functools.partial(jmodel.apply, train=False))
    jyolox.postprocess_decoded = capture
    try:
        want = jax.tree.map(np.asarray, jtta.yolox_tta(
            lambda im: apply(variables, im), jnp.asarray(x),
            score_thresh=0.01, max_det=50, nms_impl="greedy"))
    finally:
        jyolox.postprocess_decoded = orig
    return {"model": model.eval(), "x": x, "want": want,
            "decoded": seen["decoded"]}


def test_view_resize_within_1e5_of_jax_image_resize():
    x = np.random.default_rng(6).uniform(0, 1, (2, 160, 160, 3)).astype(
        np.float32)
    for hw in ((128, 128), (96, 96), (96, 128)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *hw, 3),
                                           "bilinear"))
        got = _resize_images(torch.from_numpy(x), hw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_yolox_tta_equals_jax(tta_nano, impl):
    t = tta_nano
    x = torch.from_numpy(t["x"])
    with torch.no_grad():
        merged = ttta.yolox_tta_decoded(t["model"], x)
    assert merged.shape == t["decoded"].shape == (
        2, 400 + 100 + 25 + 256 + 64 + 16 + 144 + 36 + 9, 8)
    np.testing.assert_allclose(merged.numpy(), t["decoded"], rtol=1e-4,
                               atol=2e-3)
    # the suppression from JAX's own merged rows: keep sets equal
    from deeplearning_tpu_torch.models.detection.yolox import \
        postprocess_decoded
    got = postprocess_decoded(torch.from_numpy(t["decoded"].copy()),
                              score_thresh=0.01, max_det=50, nms_impl=impl)
    got = {k: v.numpy() for k, v in got.items()}
    want = t["want"]
    for key in ("labels", "valid"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-6)
    assert 0 < want["valid"].sum(axis=1).min()
    # the whole port path: the same keep count an image
    out = ttta.yolox_tta(t["model"], x, score_thresh=0.01, max_det=50,
                         nms_impl=impl)
    assert out["boxes"].shape == (2, 50, 4)
    assert (out["labels"][~out["valid"]] == -1).all()


def test_engine_refuses_tta_for_a_detector():
    model = TMODELS.build("yolox_nano", num_classes=3)
    with pytest.raises(ValueError, match="yolox_tta"):
        InferenceEngine("yolox_nano", model=model, num_classes=3,
                        image_size=64, device="cpu", precompile=False,
                        tta=True)


def test_detection_cli_eval_tta(capsys):
    """``train.eval_tta`` scores YOLOX a second time through ``yolox_tta``
    (JAX's ``tools/train_detection.py`` does the same); the TTA predict is
    ``yolox_tta`` over the run's model at the evaluation's slots."""
    from deeplearning_tpu_torch.core.config import load_config
    base = ["train.device=cpu", "model.image_size=64", "data.batch=2",
            "data.n_train=2", "data.max_gt=4", "train.steps=1",
            "model.name=yolox_nano"]
    assert tdet.main(base + ["train.eval_tta=true"]) == 0
    out = capsys.readouterr().out
    assert out.count("'AP'") == 2 and "TTA {" in out
    r = tdet.build(load_config(tdet.DetConfig(), None, base + [
        "train.eval_score_thresh=0.0", "train.eval_tta=true"]))
    r.close()
    r.model.eval()
    summary, _, calls = tdet.evaluate(r, tdet.tta_predict_fn(r), tag="TTA ")
    assert len(summary) == 12
    want = ttta.yolox_tta(r.model, torch.from_numpy(r.arrays[0]),
                          score_thresh=0.0, max_det=tdet.EVAL_MAX_DET)
    for k in want:
        assert torch.equal(calls[0][k], want[k]), k
    assert bool(want["valid"].any())


# ------------------------------------------- batcher supervision (fake)
class _FakeEngine:
    """The batcher's engine contract with no model: each row's sum."""

    name = "fake"
    task = "classify"
    image_size = 2

    def __init__(self, buckets=(1, 2)):
        self.buckets = tuple(buckets)

    def bucket_for(self, n):
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def pad_to_bucket(self, images, bucket):
        pad = np.zeros((bucket - len(images), *images.shape[1:]),
                       images.dtype)
        return np.concatenate([images, pad], axis=0)

    def run(self, bucket, images):
        return torch.from_numpy(images.sum(axis=(1, 2, 3)))


@pytest.fixture
def fault_env(monkeypatch):
    """Point ``DLTPU_FAULTS`` at a spec for this test only."""
    def set_faults(spec):
        monkeypatch.setenv("DLTPU_FAULTS", spec)
        monkeypatch.setenv("DLTPU_REPLICA", "0")
        tfaults.reset()
    yield set_faults
    tfaults.reset()


def test_batcher_touches_the_heartbeat_once_a_dispatch():
    beat = thb.Heartbeat()
    img = np.ones((2, 2, 3), np.float32)
    with MicroBatcher(_FakeEngine(), max_wait_ms=1.0,
                      heartbeat=beat) as mb:
        for i in range(3):
            assert float(mb.submit(img).result(timeout=10.0)) == 12.0
            deadline = time.monotonic() + 5.0
            while beat.step < i + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert beat.step == mb.dispatched == i + 1
            assert beat.activity == i + 1 and beat.phase == "dispatch"


@pytest.mark.parametrize("kind", ["preempt_replica", "crash_replica"])
def test_replica_faults_wait_for_their_callback(fault_env, kind):
    fault_env(f"{kind}:0@step:0")
    fired = threading.Event()
    with MicroBatcher(_FakeEngine(), max_wait_ms=1.0) as mb:
        time.sleep(0.2)               # the loop polls with no callback set
        assert not any(s.fired for s in tfaults.active_faults())
        setattr(mb, "on_preempt" if kind == "preempt_replica"
                else "on_crash", fired.set)
        assert fired.wait(5.0)
    assert [s.fired for s in tfaults.active_faults()] == [True]


def test_replica_faults_target_their_replica(fault_env, monkeypatch):
    fault_env("preempt_replica:1@step:0;crash_replica:1@step:0")
    calls = []
    with MicroBatcher(_FakeEngine(), max_wait_ms=1.0) as mb:
        mb.on_preempt = lambda: calls.append("preempt")
        mb.on_crash = lambda: calls.append("crash")
        time.sleep(0.3)
    assert calls == []                # this process is replica 0


# ------------------------------------------------------- request images
@pytest.fixture(scope="module")
def png(tmp_path_factory):
    from PIL import Image
    path = str(tmp_path_factory.mktemp("img") / "seeded.png")
    pixels = np.random.default_rng(8).integers(0, 256, (40, 52, 3))
    Image.fromarray(pixels.astype(np.uint8)).save(path)
    return path


@pytest.mark.parametrize("task", ["classify", "detect"])
def test_load_request_images_equals_tools_serve(png, task, tmp_path):
    got = serve_cli.load_request_images(png, 48, task)
    want = jserve_cli.load_request_images(png, 48, task)
    assert got.shape == want.shape == (1, 48, 48, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a model-ready array of another size is resized as JAX resizes it
    npz = str(tmp_path / "b.npz")
    np.savez(npz, images=_images(2, 40, seed=9))
    np.testing.assert_allclose(serve_cli.load_request_images(npz, 48, task),
                               jserve_cli.load_request_images(npz, 48, task),
                               atol=1e-5, rtol=0)


def test_cli_serves_a_checkpoint_with_tta_from_an_image(png, tmp_path,
                                                       monkeypatch, capsys):
    model = TMODELS.build(MICRO, num_classes=5,
                          generator=torch.Generator().manual_seed(2))
    tckpt.save_pytree(str(tmp_path / "w"), model)
    npy = str(tmp_path / "frame.npy")
    np.save(npy, serve_cli.load_request_images(png, 56)[0])
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{png}\n{npy}\n"))
    rc = serve_cli.main(["--model", MICRO, "--size", "56", "--device", "cpu",
                         "--buckets", "1", "--num-classes", "5",
                         "--ckpt", str(tmp_path / "w"), "--tta"])
    captured = capsys.readouterr()
    out = [json.loads(line) for line in captured.out.strip().splitlines()]
    assert rc == 0 and len(out) == 2
    assert out[0]["top"] == out[1]["top"]     # the PNG == its .npy frame
    ready = json.loads(captured.err.splitlines()[0])["ready"]
    assert ready["tta"] and ready["trace_count"] == 1
    eng = InferenceEngine(MICRO, ckpt=str(tmp_path / "w"), num_classes=5,
                          image_size=56, batch_buckets=(1,), tta=True,
                          attn="flash_hb", device="cpu")
    probs = eng.infer(np.load(npy))[0]
    assert out[1]["top"][0] == [int(np.argmax(probs)),
                                round(float(probs.max()), 4)]


# --------------------------------------------- the supervised serve CLI
def _post(url, timeout=30.0):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _predict(url, img):
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue())
    try:
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _supervised(tmp_path, monkeypatch, fault_env, spec, client):
    """``serve_cli.main`` in HTTP mode on this (main) thread under the
    supervision variables and ``spec``; ``client(url)`` runs on a thread
    once the endpoint file names the server. Returns main's exit code."""
    for key, value in {
            "DLTPU_HEARTBEAT": str(tmp_path / "hb.json"),
            "DLTPU_STANDBY": "1", "DLTPU_TRACE": "1",
            "DLTPU_TRACE_FILE": str(tmp_path / "trace.json"),
            "DLTPU_ENDPOINT_FILE": str(tmp_path / "ep.json")}.items():
        monkeypatch.setenv(key, value)
    fault_env(spec)
    result = {}

    def drive():
        deadline = time.monotonic() + 60.0
        doc = None
        while doc is None and time.monotonic() < deadline:
            doc = tmetrics.read_endpoint(str(tmp_path / "ep.json"))
            time.sleep(0.05)
        try:
            result.update(client(doc["url"]))
        except BaseException as exc:  # noqa: BLE001 - to the test
            result["error"] = exc

    thread = threading.Thread(target=drive, daemon=True)
    thread.start()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        rc = serve_cli.main(["--model", MICRO, "--size", "56", "--device",
                             "cpu", "--buckets", "1", "--num-classes", "5",
                             "--http", "0"])
    finally:
        signal.signal(signal.SIGTERM, previous)
        tspans.disable()
        tmetrics.disable()
    thread.join(30.0)
    if "error" in result:
        raise result["error"]
    return rc, result


def test_cli_standby_heartbeat_trace_and_preempt(tmp_path, monkeypatch,
                                                 fault_env):
    img = _images(1, 56, seed=4)[0]

    def client(url):
        out = {"standby": _predict(url, img)[0],
               "promote": _post(url + "/admin/promote")}
        out["served"] = _predict(url, img)
        return out

    rc, out = _supervised(tmp_path, monkeypatch, fault_env,
                          "preempt_replica:0@step:1", client)
    assert rc == 75
    assert out["standby"] == 503
    assert out["promote"] == (200, {"promoted": True, "standby": False})
    assert out["served"][0] == 200
    beat = thb.read_heartbeat(str(tmp_path / "hb.json"))
    assert beat["step"] == 1 and beat["phase"] == "dispatch"
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "serve/dispatch" in names
    kinds = [e["kind"] for e in tflight.get_recorder().events()]
    assert "serve_preempted" in kinds


def test_cli_crash_replica_exits_at_once(tmp_path, monkeypatch, fault_env):
    exits = []

    def fake_exit(code):
        # os._exit never returns; here it ends serve_forever on the main
        # thread instead, and the batcher closes as after a drain
        exits.append(code)
        import _thread
        _thread.interrupt_main()

    monkeypatch.setattr(os, "_exit", fake_exit)
    img = _images(1, 56, seed=4)[0]

    def client(url):
        _post(url + "/admin/promote")
        try:
            return {"served": _predict(url, img)[0]}
        except OSError:
            return {"served": None}

    _supervised(tmp_path, monkeypatch, fault_env,
                "crash_replica:0@step:1", client)
    assert exits == [1]
    kinds = [e["kind"] for e in tflight.get_recorder().events()]
    assert "serve_crash" in kinds
