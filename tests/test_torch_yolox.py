"""Port YOLOX (deeplearning_tpu_torch/models/detection/yolox.py) and its
serving path vs the JAX package, on the CPU.

- Raw head output of ``yolox_nano`` at 64², 3 classes, float32 on both
  sides, on the same weights (kernels N(0, 1/fan_in), BatchNorm means
  N(0, 0.1²) and variances U(0.5, 1.5) in ``batch_stats``): within 1e-4
  (tests/conftest.py sets JAX matmuls to highest precision).
- The postprocess of one raw output: the NMS stage is exact (the port's
  ``batched_nms`` + gather on JAX's decoded boxes and scores give JAX's
  boxes, scores, labels and valid bit for bit). End to end from the raw
  output, labels, valid and the keep order are exact too; boxes and scores
  agree within 1e-6 relative, because XLA's exp and logistic on the CPU
  round differently from torch's in the last bit (measured: exp differs on
  ~9% of float32 inputs).
- The engine answers a detection batch with the rows it gives one image at
  a time; the batcher demuxes the dict per key; the CLI answers valid rows
  only; the converter carries conv kernels and ``batch_stats`` across and
  leaves the ViT/Swin conversions as they were.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.detection import yolox as jyolox
from deeplearning_tpu.ops import nms as jnms
from deeplearning_tpu_torch import hub, models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.detection import predict as tpredict
from deeplearning_tpu_torch.models.detection import yolox as tyolox
from deeplearning_tpu_torch.ops import nms as tnms
from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
from deeplearning_tpu_torch.serve import __main__ as serve_cli
from deeplearning_tpu_torch.utils import convert

SIZE = 64


def _jax_variables(jmodel, size=SIZE, seed=0, channels=3):
    """A flax variable tree of numpy arrays: kernels N(0, 1/fan_in),
    biases N(0, 0.1²), BatchNorm scales 1 + N(0, 0.1²), means N(0, 0.1²),
    variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0),
                            jnp.zeros((1, size, size, channels)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            value = rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        return (value + (name == "scale")).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def nano():
    """JAX and port yolox_nano on the same weights, float32, and the JAX
    raw output of two seeded images."""
    jmodel = JMODELS.build("yolox_nano", num_classes=3, dtype=jnp.float32)
    variables = _jax_variables(jmodel)
    x = np.random.default_rng(1).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    raw = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(x)))
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    return {"variables": variables, "x": x, "raw": raw,
            "model": model.eval()}


def test_raw_head_output_matches_jax(nano):
    with torch.no_grad():
        got = nano["model"](torch.from_numpy(nano["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, 8 * 8 + 4 * 4
                                                        + 2 * 2, 5 + 3)
    np.testing.assert_allclose(got.numpy(), nano["raw"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["yolox_s", "yolox_yolov3"])
def test_state_dict_is_the_flax_tree(name):
    """Names and shapes of every parameter and BatchNorm statistic against
    the flax tree (built on the meta device: no weights are drawn)."""
    jmodel = JMODELS.build(name, num_classes=7)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    want = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[coll])[0]:
            want["/".join(str(p.key) for p in path)] = leaf.shape
    with torch.device("meta"):
        model = TMODELS.build(name, num_classes=7)
    got = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        path = convert.flax_path(key, t.dim())
        shape = tuple(t.shape)
        if len(shape) == 4:                               # OIHW -> HWIO
            shape = (shape[2], shape[3], shape[1], shape[0])
        got[path] = shape
    assert got == want


def test_resnet_layer_and_lrelu_match_jax():
    """The Darknet-53 building block (lrelu ConvBnSiLU, residual)."""
    jlayer = jyolox.ResLayer(8, dtype=jnp.float32)
    variables = _jax_variables(jlayer, size=6, seed=3, channels=8)
    x = np.random.default_rng(4).normal(size=(2, 6, 6, 8)).astype(np.float32)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    layer = tyolox.ResLayer(8, dtype=torch.float32)
    layer.load_state_dict(convert.from_flax_params(variables, like=layer))
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- postprocess
def _grid():
    centers, strides = jyolox.yolox_grid((SIZE, SIZE))
    tc, ts = tyolox.yolox_grid((SIZE, SIZE))
    np.testing.assert_array_equal(centers, tc)
    np.testing.assert_array_equal(strides, ts)
    return centers, strides


def _raw_cases(nano):
    """The JAX model's raw output, and raw rows whose boxes are ~7 strides
    wide (neighbours of one class overlap past IoU 0.65) with varied
    scores, so that NMS suppresses."""
    spread = np.random.default_rng(5).normal(size=nano["raw"].shape)
    spread = spread * [0.2, 0.2, 0.3, 0.3, 2, 2, 2, 2] + [0, 0, 2, 2, 0, 0,
                                                          0, 0]
    return {"model": nano["raw"], "spread": spread.astype(np.float32)}


@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_postprocess_of_one_raw_output_matches_jax(nano, impl):
    centers, strides = _grid()
    suppressed = 0
    for case, raw in _raw_cases(nano).items():
        want = jax.tree.map(np.asarray, jax.jit(functools.partial(
            jyolox.yolox_postprocess, score_thresh=0.0, max_det=100,
            nms_impl="greedy"))(jnp.asarray(raw), jnp.asarray(centers),
                                jnp.asarray(strides)))
        got = tyolox.yolox_postprocess(
            torch.from_numpy(raw.copy()), torch.from_numpy(centers),
            torch.from_numpy(strides), score_thresh=0.0, max_det=100,
            nms_impl=impl)
        got = {k: v.numpy() for k, v in got.items()}
        for key in ("labels", "valid"):
            np.testing.assert_array_equal(got[key], want[key], case)
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-6, err_msg=case)
        assert (got["labels"][~got["valid"]] == -1).all()
        suppressed += raw.shape[0] * raw.shape[1] - int(want["valid"].sum())

        # the NMS stage alone, on JAX's own decoded boxes and scores: exact
        decoded = jyolox.decode_outputs(jnp.asarray(raw),
                                        jnp.asarray(centers),
                                        jnp.asarray(strides))
        scores_all = jax.nn.sigmoid(decoded[..., 4:5]) * \
            jax.nn.sigmoid(decoded[..., 5:])
        best = torch.tensor(np.asarray(jnp.max(scores_all, -1)))
        label = torch.tensor(np.asarray(jnp.argmax(scores_all, -1)))
        boxes = torch.tensor(np.asarray(decoded[..., :4]))
        idx, valid = tnms.batched_nms(boxes, best, label, 0.65, 100,
                                      score_threshold=0.0, impl=impl)
        exact = tnms.gather_nms_outputs(idx, valid, boxes, best, label,
                                        fill=(0, 0, -1))
        for key, value in zip(("boxes", "scores", "labels"), exact):
            np.testing.assert_array_equal(value.numpy(), want[key], case)
        np.testing.assert_array_equal(valid.numpy(), want["valid"], case)
    # 84 candidates an image, 100 slots: whatever is not kept was suppressed
    assert suppressed > 0


def test_predict_fn_and_unported_families():
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    predict = tpredict.build_predict_fn(model.eval(), "yolox_nano", 3,
                                        score_thresh=0.0, max_det=7)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    out = predict(x)
    assert set(out) == {"boxes", "scores", "labels", "valid"}
    assert out["boxes"].shape == (2, 7, 4) and bool(out["valid"].all())
    assert tpredict.is_detection_model("yolox_s")
    assert not tpredict.is_detection_model("vit_base_patch16_224")
    for name in ("retinanet_resnet50_fpn", "fcos_resnet50_fpn",
                 "fasterrcnn_resnet50_fpn", "yolov5s", "yolov5_from_spec"):
        assert callable(tpredict.build_predict_fn(model, name, 3))
    with pytest.raises(ValueError, match="no detection predict path"):
        tpredict.build_predict_fn(model, "vit_tiny", 3)
    with pytest.raises(ValueError, match="no detection predict path"):
        InferenceEngine("vit_tiny", model=model, task="detect",
                        device="cpu", precompile=False)
    assert hub.model_kwargs("yolox_s", "flash_hb", 640) == {}
    assert {"yolox_nano", "yolox_tiny", "yolox_s", "yolox_m", "yolox_l",
            "yolox_x", "yolox_yolov3"} <= set(hub.list_models("yolox"))


# ---------------------------------------------------------- serving path
@pytest.fixture(scope="module")
def engine():
    """A CPU detection engine on yolox_nano at 64² with every box alive and
    more slots (100) than candidates (84), so no near-tie decides which
    boxes make the cut. The class head's weights and biases come from a
    seeded numpy tree drawn as ``_jax_variables`` draws them (a fresh
    head's biases all sit at the prior, and its logits tie to the last
    bit), so a margin far above float noise decides every label."""
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    drawn = convert.from_flax_params(_jax_variables(JMODELS.build(
        "yolox_nano", num_classes=3, dtype=jnp.float32), seed=5), like=model)
    state = model.state_dict()
    state.update({k: v for k, v in drawn.items() if ".cls_pred" in k})
    model.load_state_dict(state)
    return InferenceEngine("yolox_nano", model=model, num_classes=3,
                           image_size=SIZE, batch_buckets=(1, 4),
                           device="cpu", score_thresh=0.0, max_det=100)


def _images(n, seed=7):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _rows(det, i):
    """Image i's valid detections as (label, box, score) rows sorted by
    label and box: a seed-initialised head scores every box ~1e-4, so
    float32 sums of another batch size may reorder ties in the last bit."""
    keep = det["valid"][i]
    labels, boxes = det["labels"][i][keep], det["boxes"][i][keep]
    order = np.lexsort([np.round(boxes[:, k], 2) for k in (1, 0)] + [labels])
    return labels[order], boxes[order], det["scores"][i][keep][order]


def _assert_same_rows(a, i, b, j):
    la, ba, sa = _rows(a, i)
    lb, bb, sb = _rows(b, j)
    np.testing.assert_array_equal(la, lb)
    # stated tolerances: float32 convs of another batch size
    np.testing.assert_allclose(ba, bb, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-9)


def test_engine_answers_a_batch_as_single_images(engine):
    assert engine.task == "detect" and engine.stats()["max_det"] == 100
    x = _images(3)
    # labels are compared exactly, so none may be a tie: the smallest
    # top-2 class-logit gap of the 84 candidates is above 1e-5, four orders
    # of magnitude above the ~3e-10 between raw outputs of two batch sizes
    with torch.no_grad():
        raw = engine.model(torch.from_numpy(x))
    top2 = torch.topk(raw[..., 5:], 2, dim=-1).values
    assert raw.shape == (3, 84, 8)
    assert (top2[..., 0] - top2[..., 1]).min().item() > 1e-5
    batched = engine.infer(x)
    assert batched["boxes"].shape == (3, 100, 4)
    assert batched["labels"].dtype == np.int64
    # 84 candidates, none overlapping (each box its grid cell): all kept
    assert (batched["valid"].sum(1) == 84).all()
    assert (batched["labels"][~batched["valid"]] == -1).all()
    for i in range(3):
        _assert_same_rows(engine.infer(x[i]), 0, batched, i)
    # oversize inputs chunk through the largest bucket and concatenate
    many = engine.infer(_images(6))
    assert many["valid"].shape == (6, 100)
    with MicroBatcher(engine, max_wait_ms=20.0) as mb:
        rows = [h.result(timeout=30) for h in [mb.submit(im) for im in x]]
    for i, row in enumerate(rows):
        assert set(row) == {"boxes", "scores", "labels", "valid"}
        _assert_same_rows({k: v[None] for k, v in row.items()}, 0,
                          batched, i)


def test_engine_detection_rows_carry_minus_one_on_padding():
    model = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    eng = InferenceEngine("yolox_nano", model=model, num_classes=3,
                          image_size=32, batch_buckets=(2,), device="cpu",
                          score_thresh=0.5, max_det=5)
    # seed-initialised heads score every box ~1e-4: nothing passes 0.5
    out = eng.infer(_images(1)[:, :32, :32])
    assert not out["valid"].any() and (out["labels"] == -1).all()


def test_cli_answers_valid_rows_only(tmp_path, monkeypatch, capsys):
    path = tmp_path / "two.npy"
    np.save(path, _images(2))
    for thresh, max_det in (("0.0", 4), ("0.5", 4)):
        monkeypatch.setattr("sys.stdin", io.StringIO(f"{path}\n"))
        rc = serve_cli.main(["--model", "yolox_nano", "--size", str(SIZE),
                             "--device", "cpu", "--buckets", "1,2",
                             "--num-classes", "3", "--score-thresh", thresh,
                             "--max-det", str(max_det)])
        out = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
        assert rc == 0 and [a["image"] for a in out] == [0, 1]
        for answer in out:
            dets = answer["detections"]
            if thresh == "0.0":
                assert len(dets) == max_det
                assert all(set(d) == {"box", "score", "label"}
                           and len(d["box"]) == 4 and 0 <= d["label"] < 3
                           for d in dets)
            else:
                assert dets == []         # no padded (label -1) rows leak


# ------------------------------------------------------------ converter
def test_converter_conv_bn_round_trip_and_classifiers_unchanged(tmp_path):
    rng = np.random.default_rng(8)
    tree = {"params": {"blk": {"conv": {"kernel": rng.normal(
        size=(3, 3, 4, 6)).astype(np.float32)},
        "bn": {"scale": rng.normal(size=6).astype(np.float32),
               "bias": rng.normal(size=6).astype(np.float32)}}},
        "batch_stats": {"blk": {"bn": {
            "mean": rng.normal(size=6).astype(np.float32),
            "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}}}

    class Blk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blk = tyolox.ConvBnSiLU(4, 6, 3, dtype=torch.float32)
    target = Blk()
    state = convert.from_flax_params(tree, like=target)
    target.load_state_dict(state)                   # strict, no counter
    np.testing.assert_array_equal(
        target.blk.conv.weight.detach().numpy(),
        tree["params"]["blk"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(target.blk.bn.running_var.numpy(),
                                  tree["batch_stats"]["blk"]["bn"]["var"])
    for key, ndim, flax in (("blk.conv.weight", 4, "blk/conv/kernel"),
                            ("blk.bn.weight", 1, "blk/bn/scale"),
                            ("blk.bn.running_mean", 1, "blk/bn/mean"),
                            ("head.cls0.1.conv.weight", 4,
                             "head/cls0_1/conv/kernel")):
        assert convert.flax_path(key, ndim) == flax
    # the same tree through a flattened .npz
    path = tmp_path / "w.npz"
    np.savez(path, **{f"{c}/{'/'.join(p)}": v for c in tree
                      for p, v in convert._leaves(tree[c])})
    again = convert.load_npz(str(path), like=target)
    assert set(again) == set(state) and all(
        torch.equal(again[k], state[k]) for k in state)
    # without a target a 4-D kernel is still a patch projection, and with a
    # classifier as target nothing changes: the ViT/Swin rule
    patch = {"params": {"patch_embed": {"kernel": tree["params"]["blk"][
        "conv"]["kernel"]}}}
    flat = convert.from_flax_params(patch)["patch_embed.weight"]
    assert flat.shape == (6, 36)
    for name, size in (("vit_micro_patch4_56", 56),
                       ("swin_micro_patch2_window7", 28)):
        jtree = _jax_variables(JMODELS.build(name, num_classes=5), size)
        port = TMODELS.build(name, num_classes=5, img_size=size)
        plain = convert.from_flax_params(jtree)
        liked = convert.from_flax_params(jtree, like=port)
        assert set(plain) == set(liked) == set(port.state_dict())
        assert all(torch.equal(plain[k], liked[k]) for k in plain)
