"""The port's utilities and user CLIs against the JAX package's, on the
CPU: ``utils/{normalization,visualize,profiling,torch_import}.py``,
``core/rng``'s ``host_key`` / ``split_named`` (and the Trainer keyed by
``host_key``), and ``python -m deeplearning_tpu_torch.{predict,evaluate,
demo,autoanchor,data_throughput}`` run in-process through ``main(argv)``.

- The four norms equal JAX's within 1e-5; ``sync_batch_norm_stats`` over
  2 gloo ranks equals JAX's ``pmean`` over 2 virtual devices.
- The grids and ``draw_boxes`` equal JAX's exactly; ``capture_feature_maps``
  records every submodule, the model's own output equal to JAX's.
- ``compiled_flops`` counts a small MLP's products; ``RetraceGuard`` warns
  once a new signature, as JAX's counts them; ``model_info``'s params_m
  equal JAX's; ``device_peak_flops`` raises for a device it does not know.
- ``torch_to_port`` names what JAX's ``torch_to_flax`` and then
  ``utils/convert.from_flax_params`` name, with the same tensors.
- ``evaluate``'s top-1 / top-5 / per-class and ``predict``'s top-k (plain
  and flip-TTA) equal JAX's eval step on the same ``.npz`` (mnist_cnn at
  28², weights converted from JAX, float32); ``demo`` writes the image
  ``draw_boxes`` drew over yolox_nano's detections; ``autoanchor`` prints
  what ``tools/autoanchor.py`` prints on a seeded COCO json;
  ``data_throughput`` runs on a 16-image folder.
"""

import importlib.util
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.evaluation import metrics as jmetrics
from deeplearning_tpu.ops import tta as jtta
from deeplearning_tpu.utils import normalization as jnorm
from deeplearning_tpu.utils import profiling as jprof
from deeplearning_tpu.utils import torch_import as jimport
from deeplearning_tpu.utils import visualize as jvis
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.checkpoint import save_pytree
from deeplearning_tpu_torch.utils import normalization as tnorm
from deeplearning_tpu_torch.utils import profiling as tprof
from deeplearning_tpu_torch.utils import torch_import as timport
from deeplearning_tpu_torch.utils import visualize as tvis
from deeplearning_tpu_torch.utils.convert import from_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ normalization
@pytest.mark.parametrize("name", ["batch_norm", "layer_norm",
                                  "instance_norm", "group_norm"])
def test_norms_equal_jax(name):
    x = _rand(4, 5, 6, 8)
    shape = (8,)
    gamma, beta = _rand(*shape, seed=1) + 1, _rand(*shape, seed=2)
    kw = {"groups": 4} if name == "group_norm" else {}
    want = np.asarray(getattr(jnorm, name)(jnp.asarray(x), gamma, beta, **kw))
    got = getattr(tnorm, name)(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_sync_batch_norm_stats_equal_jax_pmean(tmp_path):
    x = _rand(2, 3, 4, 4, 6)            # (ranks, N, H, W, C)
    want_mean, want_var = jax.pmap(
        lambda a: jnorm.sync_batch_norm_stats(a, "i"), axis_name="i",
        devices=jax.devices()[:2])(jnp.asarray(x))
    outs = run_ranks("sync_bn", 2, tmp_path, {"x": x})
    for out in outs:
        np.testing.assert_allclose(out["mean"], np.asarray(want_mean[0]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out["var"], np.asarray(want_var[0]),
                                   atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- visualize
def test_grids_and_draw_boxes_equal_jax():
    feats = _rand(9, 7, 5)
    kernel = _rand(3, 3, 4, 6)
    assert np.array_equal(tvis.feature_map_grid(feats, max_channels=4),
                          jvis.feature_map_grid(feats, max_channels=4))
    assert np.array_equal(tvis.kernel_grid(kernel), jvis.kernel_grid(kernel))
    img = np.random.default_rng(3).integers(0, 255, (40, 50, 3),
                                            dtype=np.uint8)
    boxes = np.array([[2.4, 3.6, 30.5, 20.0], [-5, 10, 80, 60],
                      [10, 10, 12, 11]], np.float32)
    assert np.array_equal(tvis.draw_boxes(img, boxes, thickness=3),
                          jvis.draw_boxes(img, boxes, thickness=3))


def test_capture_feature_maps_records_every_module():
    model, _ = hub.load("mnist_cnn", num_classes=10, seed=0, device="cpu",
                        dtype=torch.float32)
    jmodel = JMODELS.build("mnist_cnn", num_classes=10, dtype=jnp.float32)
    x = _rand(2, 28, 28, 3)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x), train=False)
    model.load_state_dict(from_flax_params(variables, like=model))
    got = tvis.capture_feature_maps(model, torch.from_numpy(x))
    want = jvis.capture_feature_maps(jmodel, variables, jnp.asarray(x))
    assert "" in got and model.training is False
    np.testing.assert_allclose(got[""], want["__call__"], atol=1e-4,
                               rtol=1e-4)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.Flatten(), torch.nn.Linear(16, 2))
    net.train()
    xs = torch.from_numpy(_rand(2, 3, 4, 4))
    got = tvis.capture_feature_maps(net, xs)
    assert set(got) == {"", "0", "1", "2", "3"} and net.training
    np.testing.assert_array_equal(got["1"], torch.relu(net[0](xs)).detach())
    np.testing.assert_array_equal(got[""], got["3"])
    only = tvis.capture_feature_maps(
        net, xs, filter_fn=lambda n, m: isinstance(m, torch.nn.Conv2d))
    assert set(only) == {"0"}


# ---------------------------------------------------------------- profiling
def test_compiled_flops_of_an_mlp():
    mlp = torch.nn.Sequential(torch.nn.Linear(64, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 10))
    x = torch.zeros(4, 64)
    products = 2 * 4 * (64 * 32 + 32 * 10)
    assert tprof.compiled_flops(mlp, x) == products
    w1, w2 = (np.asarray(p.detach().T) for p in (mlp[0].weight,
                                                  mlp[2].weight))
    jflops = jprof.compiled_flops(
        lambda a: jnp.maximum(a @ w1, 0) @ w2, jnp.zeros((4, 64)))
    # XLA also counts the ReLU's compares: the products are the rest
    assert products <= jflops <= products * 1.05


def test_step_timer_and_mfu_on_the_cpu(tmp_path):
    timer = tprof.StepTimer()
    timer.stop()                      # no start: records nothing
    for _ in range(2):
        timer.start()
        torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop()
    assert len(timer.times) == 2 and timer.mean > 0
    with pytest.raises(ValueError, match="no peak FLOP/s"):
        tprof.device_peak_flops("cpu")
    mlp = torch.nn.Linear(16, 8)
    out = tprof.measure_mfu(mlp, (torch.zeros(2, 16),), n_steps=2,
                            peak_flops=1e12)
    assert out["flops_per_step"] == 2 * 2 * 16 * 8 and out["mfu"] > 0
    with tprof.trace(str(tmp_path / "tr")) as prof:
        mlp(torch.zeros(2, 16))
    assert prof is not None and (tmp_path / "tr" / "trace.json").exists()


def test_retrace_guard_counts_as_jax():
    def run(guard, xs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for x in xs:
                guard(x)
        return guard.retraces, guard.n_signatures, len(caught)
    shapes = [((2, 3), "float32"), ((2, 3), "float32"), ((4, 3), "float32"),
              ((2, 3), "float32"), ((2, 3), "int32")]
    seen = []
    tguard = tprof.RetraceGuard(lambda x: x, on_retrace=seen.append)
    got = run(tguard, [torch.zeros(s, dtype=getattr(torch, d))
                       for s, d in shapes])
    want = run(jprof.RetraceGuard(lambda x: x),
               [jnp.zeros(s, dtype=d) for s, d in shapes])
    assert got == want == (2, 3, 2)
    assert [e["retraces"] for e in seen] == [1, 2]


def test_model_info_params_equal_jax():
    model, _ = hub.load("mnist_cnn", num_classes=10, seed=0, device="cpu",
                        dtype=torch.float32)
    x = torch.zeros(1, 28, 28, 3)
    info = tprof.model_info(model, x)
    jinfo = jprof.model_info(JMODELS.build("mnist_cnn", num_classes=10),
                             jnp.zeros((1, 28, 28, 3)))
    assert info["params_m"] == pytest.approx(jinfo["params_m"], abs=0)
    # the convolutions' and dense layers' products, 2 a multiply-add
    macs = (28 * 28 * 32 * 27 + 14 * 14 * 64 * 288 + 3136 * 128 + 128 * 10)
    assert info["gflops"] == pytest.approx(2 * macs / 1e9)


# ------------------------------------------------------------- torch_import
def test_torch_to_port_names_what_jax_then_convert_name():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = torch.nn.Conv2d(3, 8, 3)
            self.bn1 = torch.nn.BatchNorm2d(8)
            self.norm = torch.nn.LayerNorm(8)
            self.fc = torch.nn.Linear(8, 4)
    ref = torch.nn.Sequential(Block(), Block())
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
    sd = ref.state_dict()

    def rename(stem):
        return None if stem.startswith("1.norm") else f"blocks_{stem}"

    port = timport.torch_to_port(sd, rename)
    via_jax = from_flax_params(jimport.torch_to_flax(sd, rename), like=port)
    assert set(port) == set(via_jax)
    assert "blocks.0.conv1.weight" in port and not any(
        k.endswith("num_batches_tracked") or k.startswith("blocks.1.norm")
        for k in port)
    for k, v in port.items():
        assert torch.equal(v, via_jax[k]), k
        assert torch.equal(v, sd[k.replace("blocks.", "", 1)].float())


def test_load_torch_checkpoint_unwraps(tmp_path):
    lin = torch.nn.Linear(3, 2)
    torch.save({"model": lin.state_dict()}, tmp_path / "w.pth")
    got = timport.load_torch_checkpoint(str(tmp_path / "w.pth"))
    assert set(got) == {"weight", "bias"}
    assert torch.equal(got["weight"], lin.weight.detach())


# -------------------------------------------------------------------- rng
def test_host_key_and_split_named():
    assert trng.host_key(3) == trng.fold_in(trng.root_key(3), 0)
    assert trng.host_key(3) == trng.host_key(3) != trng.root_key(3)
    keys = trng.split_named(trng.host_key(3), ["dropout", "aug", "mask"])
    assert list(keys) == ["dropout", "aug", "mask"]
    assert keys == trng.split_named(trng.host_key(3),
                                    ["dropout", "aug", "mask"])
    parent = trng.host_key(3)
    others = {parent, *(trng.fold_in(parent, i) for i in range(3))}
    assert len(set(keys.values())) == 3 and not others & set(keys.values())
    assert all(0 <= k < 2 ** 63 for k in keys.values())


def test_trainer_keys_with_host_key(tmp_path):
    """The Trainer's steps draw their drop-path masks from ``host_key``:
    its final parameters equal a hand loop's keyed so, and differ from one
    keyed by ``root_key``."""
    from deeplearning_tpu_torch.data import ArraySource, DataLoader
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.train import TrainState, make_train_step
    from deeplearning_tpu_torch.train import classification as tcls
    from deeplearning_tpu_torch.train import optim as toptim
    from deeplearning_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(0)
    images = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)

    def state():
        model = VisionTransformer(img_size=16, patch_size=4, num_classes=10,
                                  embed_dim=32, depth=2, num_heads=2,
                                  drop_path_rate=0.3, dtype=torch.float32,
                                  attn_fn=get_attn_fn("naive"),
                                  generator=torch.Generator().manual_seed(0))
        tx = toptim.build_optimizer("sgd", 0.1,
                                    params=dict(model.named_parameters()))
        return TrainState.create(model=model, tx=tx)

    def loader():
        return DataLoader(ArraySource(image=images, label=labels), 8, seed=0)
    step = make_train_step(tcls.make_loss_fn(), device="cpu")
    trainer = Trainer(state=state(), train_step=step, train_loader=loader(),
                      seed=5, epochs=1, log_backends=("csv",),
                      workdir=str(tmp_path))
    assert trainer.rng == trng.host_key(5)
    trainer.train()
    for key, same in ((trng.host_key(5), True), (trng.root_key(5), False)):
        hand, feed = state(), loader()
        feed.set_epoch(0)
        for batch in feed:
            hand, _ = step(hand, batch, key)
        equal = all(torch.equal(p, trainer.state.params[n])
                    for n, p in hand.params.items())
        assert equal is same


# -------------------------------------------------------------------- CLIs
@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """An .npz of 64 model-ready 28² images, mnist_cnn's JAX variables in
    float32, and a port checkpoint of them."""
    d = tmp_path_factory.mktemp("mnist")
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (64, 28, 28, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    np.savez(d / "d.npz", images=images, labels=labels)
    jmodel = JMODELS.build("mnist_cnn", num_classes=10, dtype=jnp.float32)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(images[:1]),
                            train=False)
    model, _ = hub.load("mnist_cnn", num_classes=10, device="cpu",
                        dtype=torch.float32)
    save_pytree(str(d / "ckpt"), from_flax_params(variables, like=model))
    logits = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    return {"dir": d, "images": images, "labels": labels, "logits": logits,
            "jmodel": jmodel, "variables": variables}


@pytest.fixture
def float32_factories(monkeypatch):
    """The CLIs build their model through ``hub.model_kwargs``; here the
    factory also gets ``dtype=float32``, so the answers hold against JAX's
    float32 forward of the same weights. The rest is the CLIs' own."""
    real = hub.model_kwargs
    monkeypatch.setattr(hub, "model_kwargs", lambda *a, **k: {
        **real(*a, **k), "dtype": torch.float32})


def _cli_args(mnist, *extra):
    return ["--model", "mnist_cnn", "--num-classes", "10", "--ckpt",
            str(mnist["dir"] / "ckpt"), "--device", "cpu", *extra]


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.usefixtures("float32_factories")
def test_evaluate_equals_jax_eval_step(mnist, tta, capsys, tmp_path):
    from deeplearning_tpu_torch.evaluate import main
    out_json = tmp_path / "r.json"
    argv = _cli_args(mnist, "--npz", str(mnist["dir"] / "d.npz"), "--batch",
                     "32", "--out-json", str(out_json))
    assert main(argv + (["--tta"] if tta else [])) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    totals = {"top1": 0, "top5": 0, "count": 0}
    cm = np.zeros((10, 10), np.int64)
    for s in range(0, 64, 32):
        imgs = jnp.asarray(mnist["images"][s:s + 32])
        labs = jnp.asarray(mnist["labels"][s:s + 32])
        if tta:
            probs = jtta.classify_tta(mnist["logits"], imgs)
            scores = jnp.log(jnp.maximum(probs, 1e-30))
        else:
            scores = mnist["logits"](imgs)
        counts = jmetrics.topk_correct(scores, labs)
        for k in totals:
            totals[k] += int(counts[k])
        cm += np.asarray(jmetrics.confusion_matrix(jnp.argmax(scores, -1),
                                                   labs, 10))
    stats = jmetrics.miou_from_confusion(cm)
    want = {"top1": totals["top1"] / 64, "top5": totals["top5"] / 64,
            "count": 64,
            "per_class_acc": [round(float(a), 4) for a in stats["class_acc"]]}
    assert json.loads(out_json.read_text()) == want
    assert printed == {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in want.items()}


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.usefixtures("float32_factories")
def test_predict_topk_equals_jax(mnist, tta, capsys):
    from deeplearning_tpu_torch.predict import main
    path = mnist["dir"] / "few.npz"
    np.savez(path, images=mnist["images"][:3], labels=mnist["labels"][:3])
    assert main(_cli_args(mnist, "--input", str(path), "--topk", "3")
                + (["--tta"] if tta else [])) == 0
    lines = capsys.readouterr().out.strip().splitlines()[-3:]
    imgs = jnp.asarray(mnist["images"][:3])
    probs = np.asarray(jtta.classify_tta(mnist["logits"], imgs) if tta
                       else jax.nn.softmax(mnist["logits"](imgs), -1))
    for bi, line in enumerate(lines):
        order = np.argsort(-probs[bi])[:3]
        want = f"image {bi}: " + "  ".join(f"{int(i)}={probs[bi][i]:.4f}"
                                           for i in order)
        assert line == want


def test_demo_writes_what_draw_boxes_drew(tmp_path, capsys, monkeypatch):
    from PIL import Image

    from deeplearning_tpu_torch import demo
    from deeplearning_tpu_torch.utils import visualize
    shapes = jax.eval_shape(
        lambda: JMODELS.build("yolox_nano", num_classes=3).init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        if str(path[-1].key) == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    model, _ = hub.load("yolox_nano", num_classes=3, device="cpu")
    save_pytree(str(tmp_path / "ckpt"), from_flax_params(variables,
                                                         like=model))
    img = np.random.default_rng(1).integers(0, 255, (48, 80, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    drawn = {}
    real = visualize.draw_boxes

    def spy(image, boxes, **kw):
        drawn["image"], drawn["boxes"] = image, boxes
        drawn["out"] = real(image, boxes, **kw)
        return drawn["out"]
    monkeypatch.setattr(visualize, "draw_boxes", spy)
    out = tmp_path / "out.png"
    assert demo.main(["--model", "yolox_nano", "--num-classes", "3",
                      "--ckpt", str(tmp_path / "ckpt"), "--input",
                      str(tmp_path / "in.png"), "--size", "64", "--score",
                      "0.0", "--out", str(out), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines[:-1]]
    assert lines[-1] == f"wrote {out} ({len(rows)} detections)"
    assert len(rows) == len(drawn["boxes"]) > 0
    np.testing.assert_allclose([r["box"] for r in rows], drawn["boxes"],
                               atol=0.051)
    assert np.array_equal(drawn["image"], img)
    written = np.asarray(Image.open(out))
    assert np.array_equal(written, drawn["out"])
    assert np.array_equal(written, real(img, drawn["boxes"]))
    assert not np.array_equal(written, img)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_autoanchor_prints_what_jax_prints(tmp_path, capsys):
    from deeplearning_tpu_torch.autoanchor import main
    rng = np.random.default_rng(0)
    coco = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 480,
                        "width": 640} for i in range(8)],
            "annotations": [], "categories": [{"id": 1, "name": "a"},
                                              {"id": 2, "name": "b"}]}
    for j in range(120):
        w, h = rng.uniform(3, 300, 2)
        coco["annotations"].append({
            "id": j, "image_id": int(j % 8), "category_id": int(1 + j % 2),
            "bbox": [float(rng.uniform(0, 300)), float(rng.uniform(0, 150)),
                     float(w), float(h)], "area": float(w * h),
            "iscrowd": 0})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(coco))
    tool = _jax_tool("autoanchor")
    for argv in (["--coco", str(path)], ["--coco", str(path), "--force",
                                         "--n", "6", "--img-size", "512"]):
        assert main(argv) == 0
        got = capsys.readouterr().out
        assert tool.main(argv) == 0
        assert got == capsys.readouterr().out
        assert "BPR=" in got


def test_data_throughput_runs_on_a_folder(tmp_path, capsys):
    from PIL import Image

    from deeplearning_tpu_torch.data_throughput import main
    rng = np.random.default_rng(0)
    for i in range(16):
        d = tmp_path / "f" / "ab"[i % 2]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
                        ).save(d / f"{i}.jpg")
    assert main(["--folder", str(tmp_path / "f"), "--image-size", "32",
                 "--batch", "4", "--workers", "2", "--batches", "3",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "memmap_cache:" in out and "jpeg_decode+augment:" in out
    assert "batches moved to cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])                  # the card is the default device
