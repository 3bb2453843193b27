"""RetinaNet, FCOS, Faster R-CNN and YOLOv5 of the port vs the JAX
package, on the CPU: each family's raw outputs on the same converted
weights, each postprocess, and the serving path (predict builder, engine,
batcher, CLI).

- Raw outputs (``*_resnet18_fpn``, ``yolov5s``, ``yolov5_from_spec`` at
  64-100², 3 classes, float32 on both sides, seeded flax trees with
  nonzero BatchNorm scales): within 1e-4. Faster R-CNN runs at 100², where
  the pyramid's levels (25, 13, 7, 4) are odd and the FPN's top-down
  resizes are not 2×.
- Postprocesses, from JAX's raw outputs: labels, valid and the keep order
  exact; scores within 1e-6 relative, box coordinates within 1e-6 of the
  image size (XLA's exp and logistic on the CPU differ from torch's in
  the last bit, and a corner near 0 keeps the absolute error of the
  centre and size it is formed from). From JAX's own decoded candidates,
  the port's NMS stage gives JAX's outputs bit for bit.
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
from deeplearning_tpu.models.detection import faster_rcnn as jfrcnn
from deeplearning_tpu.models.detection import fcos as jfcos
from deeplearning_tpu.models.detection import predict as jpredict
from deeplearning_tpu.models.detection import retinanet as jretina
from deeplearning_tpu.models.detection import yolov5 as jyolov5
from deeplearning_tpu.ops import boxes as jboxes
from deeplearning_tpu_torch import hub, models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.detection import faster_rcnn as tfrcnn
from deeplearning_tpu_torch.models.detection import fcos as tfcos
from deeplearning_tpu_torch.models.detection import predict as tpredict
from deeplearning_tpu_torch.models.detection import retinanet as tretina
from deeplearning_tpu_torch.models.detection import yolov5 as tyolov5
from deeplearning_tpu_torch.ops import nms as tnms
from deeplearning_tpu_torch.serve import InferenceEngine, MicroBatcher
from deeplearning_tpu_torch.serve import __main__ as serve_cli
from deeplearning_tpu_torch.utils import convert

from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
EXACT_KEYS = ("labels", "valid")
CLOSE_KEYS = ("boxes", "scores")

# name: (classes the head is built with, image size)
FAMILIES = {"retinanet_resnet18_fpn": (3, 64), "fcos_resnet18_fpn": (3, 64),
            "fasterrcnn_resnet18_fpn": (4, 100), "yolov5s": (3, 64),
            "yolov5_from_spec": (3, 96)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _family(name):
    """JAX and port models on the same weights, two seeded images, and
    both raw outputs."""
    nc, size = FAMILIES[name]
    jmodel = JMODELS.build(name, num_classes=nc, dtype=jnp.float32)
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, size, size, 3))), seed=len(name))
    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(
        np.float32)
    apply = jax.jit(functools.partial(jmodel.apply, train=False))
    want = apply(variables, jnp.asarray(x))
    model = TMODELS.build(name, num_classes=nc, dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return {"jmodel": jmodel, "variables": variables, "x": x,
            "apply": apply, "want": want, "model": model, "got": got,
            "hw": (size, size), "nc": nc}


def _assert_det(got, want, size):
    """Labels, valid and the keep order exact; scores within 1e-6, box
    coordinates within 1e-6 of the image size (a corner cx − w/2 near 0
    keeps the absolute error of cx and w, a few ulps of the image size)."""
    got = {k: v.numpy() for k, v in got.items()}
    want = _np_tree(want)
    for key in EXACT_KEYS:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6,
                               atol=1e-6 * size)
    assert (got["labels"][~got["valid"]] == -1).all()


def _nms_stage(want, boxes, scores, classes, nms_thresh, max_det,
               score_thresh, impl):
    """The port's class-aware NMS and gather on JAX's own candidates:
    JAX's detections bit for bit."""
    b = lambda a: torch.from_numpy(np.array(a))         # noqa: E731
    idx, valid = tnms.batched_nms(b(boxes), b(scores), b(classes),
                                  nms_thresh, max_det,
                                  score_threshold=score_thresh, impl=impl)
    out = tnms.gather_nms_outputs(idx, valid, b(boxes), b(scores),
                                  b(classes), fill=(0, 0, -1))
    for key, value in zip(("boxes", "scores", "labels"), out):
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want["valid"]))


# --------------------------------------------------------- raw outputs
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_raw_outputs_match_jax(name):
    fam = _family(name)
    got, want = fam["got"], fam["want"]
    if isinstance(got, torch.Tensor):                        # YOLOv5
        got, want = {"raw": got}, {"raw": want}
    keys = [k for k in got if k not in ("feature_shapes", "level_counts",
                                        "pyramid")]
    assert keys and set(keys) <= set(want)
    for key in keys:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)
    if name.startswith("fasterrcnn"):
        assert got["level_counts"] == [int(c) for c in
                                       want["level_counts"]]
        assert list(got["pyramid"]) == ["p2", "p3", "p4", "p5", "p6"]
        for key, value in got["pyramid"].items():
            np.testing.assert_allclose(
                value.permute(0, 2, 3, 1).numpy(),
                np.asarray(want["pyramid"][key]), err_msg=key, **TOL)


def test_faster_rcnn_roi_stage_matches_jax():
    """The second call on the first call's pyramid, with proposals across
    every RoIAlign level and a padded (zero) one: (7, 7, C) features
    flattened in HWC order into fc6."""
    fam = _family("fasterrcnn_resnet18_fpn")
    props = np.array([[[0, 0, 40, 50], [10, 5, 90, 99], [0, 0, 0, 0],
                       [30, 30, 31, 32], [-10, 20, 100, 100]],
                      [[5, 5, 60, 60], [0, 0, 100, 100], [50, 50, 70, 90],
                       [0, 0, 0, 0], [1, 2, 3, 4]]], np.float32)
    want = jax.jit(lambda v, x, p, pyr: fam["jmodel"].apply(
        v, x, proposals=p, pyramid=pyr, train=False))(
        fam["variables"], jnp.asarray(fam["x"]), jnp.asarray(props),
        fam["want"]["pyramid"])
    with torch.no_grad():
        got = fam["model"](torch.from_numpy(fam["x"]),
                           proposals=torch.from_numpy(props),
                           pyramid=fam["got"]["pyramid"])
    assert set(got) == {"pyramid", "roi_scores", "roi_deltas"}
    assert got["roi_scores"].shape == (2, 5, 4)
    assert got["roi_deltas"].shape == (2, 5, 4, 4)
    for key in ("roi_scores", "roi_deltas"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


# -------------------------------------------------------- postprocesses
@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_retinanet_postprocess_matches_jax(impl):
    fam = _family("retinanet_resnet18_fpn")
    hw, raw = fam["hw"], _np_tree(fam["want"])
    anchors = tretina.retinanet_anchors(hw)
    kw = dict(score_thresh=0.05, max_det=50)
    want = jax.jit(lambda o, a: jretina.retinanet_postprocess(
        o, a, hw, nms_impl="greedy", **kw))(
        {k: jnp.asarray(raw[k]) for k in ("cls_logits", "bbox_deltas")},
        jnp.asarray(anchors))
    got = tretina.retinanet_postprocess(
        {k: _t(raw[k]) for k in ("cls_logits", "bbox_deltas")},
        _t(anchors), hw, nms_impl=impl, **kw)
    _assert_det(got, want, 64)
    assert int(np.asarray(want["valid"]).sum()) > 0
    # JAX's candidates: the top 1 000 (anchor, class) pairs, decoded (as
    # one jitted function, as the postprocess computes them)
    @jax.jit
    def candidates(logits, deltas, anc):
        top_s, top_i = jax.lax.top_k(jax.nn.sigmoid(logits).reshape(2, -1),
                                     1000)
        boxes = jax.vmap(lambda d, i: jboxes.clip_boxes(jboxes.decode_boxes(
            d[i], anc[i]), hw))(deltas, top_i // 3)
        return boxes, top_s, top_i % 3
    _nms_stage(want, *candidates(raw["cls_logits"], raw["bbox_deltas"],
                                 jnp.asarray(anchors)), 0.5, 50, 0.05, impl)


@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_fcos_postprocess_matches_jax(impl):
    fam = _family("fcos_resnet18_fpn")
    hw, raw = fam["hw"], _np_tree(fam["want"])
    locs = tfcos.fcos_locations(hw)[0]
    keys = ("cls_logits", "centerness", "ltrb")
    kw = dict(score_thresh=0.05, max_det=50)
    want = jax.jit(lambda o, l: jfcos.fcos_postprocess(
        o, l, hw, nms_impl="greedy", **kw))(
        {k: jnp.asarray(raw[k]) for k in keys}, jnp.asarray(locs))
    got = tfcos.fcos_postprocess({k: _t(raw[k]) for k in keys}, _t(locs),
                                 hw, nms_impl=impl, **kw)
    _assert_det(got, want, 64)
    assert int(np.asarray(want["valid"]).sum()) > 0
    scores = jnp.sqrt(jax.nn.sigmoid(jnp.asarray(raw["cls_logits"]))
                      * jax.nn.sigmoid(jnp.asarray(raw["centerness"]))[
                          ..., None])
    ltrb, l = jnp.asarray(raw["ltrb"]), jnp.asarray(locs)
    boxes = jboxes.clip_boxes(jnp.stack(
        [l[:, 0] - ltrb[..., 0], l[:, 1] - ltrb[..., 1],
         l[:, 0] + ltrb[..., 2], l[:, 1] + ltrb[..., 3]], -1), hw)
    top_s, top_i = jax.lax.top_k(scores.reshape(2, -1),
                                 min(1000, scores[0].size))
    cand = jnp.take_along_axis(boxes, (top_i // 3)[..., None], axis=1)
    _nms_stage(want, cand, top_s, top_i % 3, 0.6, 50, 0.05, impl)


@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_faster_rcnn_proposals_and_postprocess_match_jax(impl):
    fam = _family("fasterrcnn_resnet18_fpn")
    hw, raw = fam["hw"], fam["want"]
    anchors = tfrcnn.fasterrcnn_anchors(hw)
    jout = {"rpn_obj": raw["rpn_obj"], "rpn_deltas": raw["rpn_deltas"],
            "level_counts": [int(c) for c in raw["level_counts"]]}
    props, pvalid = jax.jit(lambda o, d, a: jfrcnn.generate_proposals(
        {**jout, "rpn_obj": o, "rpn_deltas": d}, a, hw, post_nms_top_n=64,
        nms_impl="greedy"))(raw["rpn_obj"], raw["rpn_deltas"],
                            jnp.asarray(anchors))
    got_p, got_v = tfrcnn.generate_proposals(
        {"rpn_obj": _t(raw["rpn_obj"]), "rpn_deltas": _t(raw["rpn_deltas"]),
         "level_counts": jout["level_counts"]}, _t(anchors), hw,
        post_nms_top_n=64, nms_impl=impl)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(pvalid))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(props), rtol=1e-6,
                               atol=1e-4)
    # the box stage, from JAX's RoI heads on JAX's proposals, the last
    # eight of the second image padded as the proposal stage pads them
    props, pvalid = np.array(props), np.array(pvalid)
    props[1, -8:], pvalid[1, -8:] = 0.0, False
    out2 = jax.jit(lambda v, x, p, pyr: fam["jmodel"].apply(
        v, x, proposals=p, pyramid=pyr, train=False))(
        fam["variables"], jnp.asarray(fam["x"]), props, raw["pyramid"])
    kw = dict(score_thresh=0.05, max_det=40)
    want = jax.jit(lambda s, d, p, v: jfrcnn.fasterrcnn_postprocess(
        s, d, p, hw, prop_valid=v, nms_impl="greedy", **kw))(
        out2["roi_scores"], out2["roi_deltas"], props, pvalid)
    got = tfrcnn.fasterrcnn_postprocess(
        _t(out2["roi_scores"]), _t(out2["roi_deltas"]), _t(props), hw,
        prop_valid=_t(pvalid), nms_impl=impl, **kw)
    _assert_det(got, want, 100)
    assert int(np.asarray(want["valid"]).sum()) > 0
    # labels are the model's classes: background 0 never appears
    assert (np.asarray(want["labels"])[np.asarray(want["valid"])] > 0).all()


@pytest.mark.parametrize("impl", ["greedy", "blocked"])
def test_yolov5_postprocess_matches_jax(impl):
    fam = _family("yolov5s")
    hw, raw = fam["hw"], np.asarray(fam["want"])
    grid = tyolov5.yolov5_grid(hw)
    kw = dict(score_thresh=0.25, max_det=50)
    want = jax.jit(lambda r, g: jyolov5.yolov5_postprocess(
        r, g, nms_impl="greedy", **kw))(
        jnp.asarray(raw), {k: jnp.asarray(v) for k, v in grid.items()})
    got = tyolov5.yolov5_postprocess(
        _t(raw), {k: _t(v) for k, v in grid.items()}, nms_impl=impl, **kw)
    _assert_det(got, want, 64)
    decoded = jyolov5.decode_yolov5(jnp.asarray(raw), {
        k: jnp.asarray(v) for k, v in grid.items()})
    conf = jax.nn.sigmoid(decoded[..., 4:5]) * jax.nn.sigmoid(
        decoded[..., 5:])
    _nms_stage(want, decoded[..., :4], jnp.max(conf, -1),
               jnp.argmax(conf, -1), 0.45, 50, 0.25, impl)


# ------------------------------------------------------------- serving
def test_predict_fn_engine_and_batcher_serve_faster_rcnn():
    """Faster R-CNN through ``build_predict_fn`` and the engine at buckets
    1 and 2: 0-based labels, JAX's detections, a batch answered as its
    single images, the batcher demuxing the dict."""
    fam = _family("fasterrcnn_resnet18_fpn")
    x = fam["x"]
    kw = dict(score_thresh=0.0, max_det=10, post_nms_top_n=32)
    want = _np_tree(jax.jit(jpredict.build_predict_fn(
        fam["jmodel"], "fasterrcnn_resnet18_fpn", 3, nms_impl="greedy",
        **kw))(fam["variables"]["params"], fam["variables"]["batch_stats"],
               jnp.asarray(x)))
    predict = tpredict.build_predict_fn(fam["model"],
                                        "fasterrcnn_resnet18_fpn", 3, **kw)
    got = {k: v.numpy() for k, v in predict(torch.from_numpy(x)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    valid = got["valid"]
    assert valid.all()                    # 32 proposals × 3 classes > 10
    np.testing.assert_array_equal(got["labels"][valid], want["labels"][valid])
    assert set(np.unique(got["labels"])) <= {0, 1, 2}
    for key in CLOSE_KEYS:
        np.testing.assert_allclose(got[key], want[key], **TOL)

    engine = InferenceEngine("fasterrcnn_resnet18_fpn", model=fam["model"],
                             num_classes=3, image_size=100,
                             batch_buckets=(1, 2), device="cpu", **kw)
    assert engine.task == "detect" and engine.trace_count == 2
    batched = engine.infer(x)
    for key in got:
        np.testing.assert_array_equal(batched[key], got[key], key)
    # a batch of one convolves in another order on the CPU: float32
    # rounding, not a different answer
    for i in range(2):
        single = engine.infer(x[i])
        for key in EXACT_KEYS:
            np.testing.assert_array_equal(single[key][0], batched[key][i])
        for key in CLOSE_KEYS:
            np.testing.assert_allclose(single[key][0], batched[key][i],
                                       err_msg=key, **TOL)
    with MicroBatcher(engine, max_wait_ms=20.0) as mb:
        rows = [h.result(timeout=30) for h in [mb.submit(im) for im in x]]
    for i, row in enumerate(rows):
        assert set(row) == {"boxes", "scores", "labels", "valid"}
        np.testing.assert_array_equal(row["labels"], batched["labels"][i])
        np.testing.assert_allclose(row["scores"], batched["scores"][i],
                                   **TOL)
    assert engine.trace_count == 2


def test_engine_builds_faster_rcnn_with_a_background_class():
    engine = InferenceEngine("fasterrcnn_resnet18_fpn", num_classes=3,
                             image_size=64, batch_buckets=(1,),
                             device="cpu", precompile=False)
    assert engine.model.box_predictor.num_classes == 4
    assert tpredict.head_classes("fasterrcnn_resnet50_fpn", 20) == 21
    assert tpredict.head_classes("retinanet_resnet50_fpn", 20) == 20


def test_cli_answers_faster_rcnn_with_zero_based_labels(
        tmp_path, monkeypatch, capsys):
    path = tmp_path / "two.npy"
    np.save(path, np.random.default_rng(3).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{path}\n"))
    rc = serve_cli.main(["--model", "fasterrcnn_resnet18_fpn", "--size",
                         "64", "--device", "cpu", "--buckets", "1,2",
                         "--num-classes", "3", "--score-thresh", "0.0",
                         "--max-det", "5"])
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and [a["image"] for a in out] == [0, 1]
    for answer in out:
        dets = answer["detections"]
        assert len(dets) == 5
        assert all(set(d) == {"box", "score", "label"} and len(d["box"]) == 4
                   and 0 <= d["label"] < 3 for d in dets)


@pytest.mark.parametrize("name,nc,size", [
    ("retinanet_resnet18_fpn", 3, 64), ("fcos_resnet18_fpn", 3, 64),
    ("yolov5s", 3, 64), ("yolov5_from_spec", 3, 64)])
def test_hub_and_engine_serve_every_family(name, nc, size):
    """Each family builds through ``hub.load`` and answers through the
    engine: ``max_det`` rows, class −1 exactly on the padded ones."""
    assert name in hub.list_models()
    engine = InferenceEngine(name, num_classes=nc, image_size=size,
                             batch_buckets=(2,), device="cpu",
                             score_thresh=0.0, max_det=6)
    out = engine.infer(np.random.default_rng(4).normal(
        size=(2, size, size, 3)).astype(np.float32))
    assert out["boxes"].shape == (2, 6, 4) and out["valid"].all()
    assert ((out["labels"] >= 0) & (out["labels"] < nc)).all()
    assert np.isfinite(out["boxes"]).all()
