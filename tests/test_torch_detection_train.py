"""One-stage detection training and COCO evaluation of the port vs the JAX
package, on the CPU: losses, the anchor matcher, SimOTA, the YOLOX and
RetinaNet losses and their gradients, three Adam steps of each family,
multi-scale sizes and resizes, the COCO evaluator (numpy and C++
matching), the experiments, the COCO source and the detection CLI.

- Losses: ``binary_cross_entropy``, ``sigmoid_focal_loss`` and
  ``smooth_l1`` within 1e-6 for each reduction, with and without weights.
- ``match_anchors`` and ``simota_assign`` equal JAX's exactly (SimOTA's
  matched IoU within 1e-6) at 64², G = 6, C = 5, on seeded head outputs
  and on decoded rows built so that float32 costs tie: the test shows a
  tie that decides which anchors a gt takes.
- ``yolox_loss`` (``use_l1`` off and on) and ``retinanet_loss`` from the
  same raw outputs: each term within 1e-5 relative, the gradient with
  respect to the raw outputs within 1e-4 of its norm.
- Three Adam steps (lr 1e-4, clip 1.0) of ``yolox_nano`` and
  ``retinanet_resnet18_fpn`` at 64², float32 on both sides, the same
  converted weights and batches: the port's ``build_task`` loss through
  ``make_train_step`` against JAX's ``build_task`` loss with optax;
  losses within 1e-4 relative at each step, the BatchNorm statistics the
  first step leaves (one train-mode forward on equal weights: the
  momentum and the biased batch variance) within 1e-5. Adam's first
  steps move every parameter by about ±lr whatever its gradient's size,
  so a float32 rounding difference in a gradient near zero becomes an
  lr-sized parameter difference; the seeded
  networks' first gradients are themselves ill-conditioned (each side's
  float32 RetinaNet gradient is 8e-3 from a float64 one, the two 1e-3
  apart). At lr 1e-3 the losses drift apart by ~1e-3 by the third step,
  and a YOLOX positive count that changes with it moves the loss by
  tens of percent; at 1e-4 they stay within 3e-5. The statistics of
  later steps inherit the parameter drift, amplified in RetinaNet's
  layer4, whose BatchNorm sees 8 values a channel at 64² and batch 2.
- ``MultiScaleSchedule`` equal for 100 steps and three seeds;
  ``resize_detection_batch`` within 1e-5 up and down.
- ``CocoEvaluator`` summaries within 1e-12 of JAX's on seeded detections
  with crowd gts over every area range, through both matching paths.
"""

import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.core import experiment as jexp
from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.data import coco as jcoco
from deeplearning_tpu.evaluation import coco_eval as jcoco_eval
from deeplearning_tpu.evaluation import metrics as jmetrics
from deeplearning_tpu.models.detection import retinanet as jretina
from deeplearning_tpu.models.detection import yolox as jyolox
from deeplearning_tpu.ops import losses as jlosses
from deeplearning_tpu.ops import matcher as jmatcher
from deeplearning_tpu.train import multiscale as jms
from deeplearning_tpu.train.optim import build_optimizer as jbuild_optimizer
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import experiment as texp
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.data import coco as tcoco
from deeplearning_tpu_torch.evaluation import coco_eval as tcoco_eval
from deeplearning_tpu_torch.evaluation import metrics as tmetrics
from deeplearning_tpu_torch.models.detection import retinanet as tretina
from deeplearning_tpu_torch.models.detection import yolox as tyolox
from deeplearning_tpu_torch.ops import losses as tlosses
from deeplearning_tpu_torch.ops import matcher as tmatcher
from deeplearning_tpu_torch.train import detection as tdet
from deeplearning_tpu_torch.train import multiscale as tms
from deeplearning_tpu_torch.train.optim import build_optimizer
from deeplearning_tpu_torch.train.state import TrainState
from deeplearning_tpu_torch.train.steps import make_train_step
from deeplearning_tpu_torch.utils import convert

from test_torch_detection import seeded_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

SIZE, G, C, B = 64, 6, 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests. The suite shares the CPU
    among several worker processes, and torch's thread pool then spins
    against theirs: the CLI cases ran 40-80× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


# ------------------------------------------------------------- losses
LOSSES = {
    "binary_cross_entropy": dict(pos_weight=1.7),
    "sigmoid_focal_loss": dict(alpha=0.25, gamma=2.0),
    "smooth_l1": dict(beta=0.3),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, reduction, weighted):
    rng = np.random.default_rng(len(name) + 3 * weighted)
    x = rng.normal(0, 2, (4, 7, 5)).astype(np.float32)
    if name == "smooth_l1":
        y = (x + rng.normal(0, 0.4, x.shape)).astype(np.float32)
    else:
        y = (rng.uniform(size=x.shape) < 0.3).astype(np.float32)
    # an (…, 1) mask against (…, C) losses: the weighted mean divides by
    # its own sum, not by the broadcast one
    w = (rng.uniform(size=(4, 7, 1)) < 0.6).astype(np.float32) \
        if weighted else None
    kw = dict(LOSSES[name], reduction=reduction)
    want = getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y),
                                  weights=None if w is None
                                  else jnp.asarray(w), **kw)
    got = getattr(tlosses, name)(_t(x), _t(y),
                                 weights=None if w is None else _t(w), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ matcher
@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_match_anchors_equals_jax(seed, low_quality):
    """IoUs on a 0.05 grid (ties across gts and across anchors, exact
    threshold hits) with padded gt rows."""
    rng = np.random.default_rng(seed)
    iou = (rng.integers(0, 15, (3, 5, 40)) * 0.05).astype(np.float32)
    iou[:, 1] = iou[:, 0]                       # a gt tied with another
    valid = np.ones((3, 5), bool)
    valid[0, 3:] = False
    valid[2, 1:] = False
    iou[2, 1:] = 0.99                           # padded rows never win
    fn = jax.jit(jax.vmap(functools.partial(
        jmatcher.match_anchors, high_threshold=0.5, low_threshold=0.4,
        allow_low_quality=low_quality)))
    want = np.asarray(fn(jnp.asarray(iou), jnp.asarray(valid)))
    got = tmatcher.match_anchors(_t(iou), _t(valid), 0.5, 0.4,
                                 allow_low_quality=low_quality).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == jmatcher.BETWEEN).any() and (want >= 0).any()


# ------------------------------------------------------------- SimOTA
def _grid(size=SIZE):
    return jyolox.yolox_grid((size, size))


def _yolox_inputs(seed, size=SIZE, spread=0.01):
    """Raw head rows near the 1% prior and small gts, some padded."""
    centers, strides = _grid(size)
    a = len(strides)
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, a, 5 + C), np.float32)
    raw[..., :4] = rng.normal(0, 0.3, (B, a, 4))
    raw[..., 4:] = -4.6 + rng.normal(0, spread, (B, a, 1 + C))
    boxes = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        for g in range(G):
            w, h = rng.uniform(3, 30, 2)
            x0, y0 = rng.uniform(0, size - w), rng.uniform(0, size - h)
            boxes[b, g] = (x0, y0, x0 + w, y0 + h)
    labels = rng.integers(0, C, (B, G))
    valid = np.zeros((B, G), bool)
    valid[0, :4] = True
    valid[1, :] = True
    return raw, boxes, labels, valid


def _tied_decoded(seed):
    """Decoded rows whose boxes all equal the image's first gt and whose
    scores are all equal; gts on whole pixels, so every IoU is exact in
    both frameworks. The first gt's dynamic k is then 10, and its
    candidates outside both gates cost 1e5 plus one class cost: equal
    float32 costs, of which the sort's order decides the ones it takes."""
    _, boxes, labels, valid = _yolox_inputs(seed)
    boxes = np.round(boxes)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 2)
    a = len(_grid()[1])
    dec = np.full((B, a, 5 + C), -4.6, np.float32)
    dec[..., :4] = boxes[:, None, 0]
    return dec, boxes, labels, valid


@functools.lru_cache(maxsize=None)
def _jax_assign():
    centers, strides = (jnp.asarray(a) for a in _grid())
    return jax.jit(jax.vmap(lambda d, b, l, v: jyolox.simota_assign(
        d, centers, strides, b, l, v, C)))


def _jax_cost_and_k(dec, boxes, labels, valid):
    """JAX's SimOTA cost rows and dynamic k (its own formula, jitted)."""
    centers, strides = (jnp.asarray(a) for a in _grid())

    def one(d, gt, lab, v):
        cx = (centers[:, 0] + 0.5) * strides
        cy = (centers[:, 1] + 0.5) * strides
        in_box = ((cx[None] > gt[:, None, 0]) & (cx[None] < gt[:, None, 2])
                  & (cy[None] > gt[:, None, 1]) & (cy[None] < gt[:, None, 3]))
        gcx, gcy = (gt[:, 0] + gt[:, 2]) / 2, (gt[:, 1] + gt[:, 3]) / 2
        rad = 2.5 * strides[None]
        in_c = ((jnp.abs(cx[None] - gcx[:, None]) < rad)
                & (jnp.abs(cy[None] - gcy[:, None]) < rad))
        cand = (in_box | in_c) & v[:, None]
        from deeplearning_tpu.ops import boxes as jb
        iou = jnp.where(v[:, None], jb.box_iou(gt, d[:, :4]), 0.0)
        oh = jax.nn.one_hot(lab, C)
        joint = jnp.sqrt(jnp.clip(jax.nn.sigmoid(d[:, 5:])[None]
                                  * jax.nn.sigmoid(d[:, 4])[None, :, None],
                                  1e-8, 1.0))
        cc = jnp.sum(-(oh[:, None] * jnp.log(joint)
                       + (1 - oh[:, None]) * jnp.log(1 - joint + 1e-8)), -1)
        cost = (cc + 3.0 * -jnp.log(iou + 1e-8) + 1e5 * (~cand)
                + 1e5 * (~(in_box & in_c)))
        top, _ = jax.lax.top_k(jnp.where(cand, iou, 0.0), 10)
        k = jnp.clip(jnp.sum(top, -1).astype(jnp.int32), 1, d.shape[0])
        return cost, k, cand
    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        dec, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))]


def _decisive_ties(cost, k, cand):
    """Rows where equal float32 costs straddle the k-th rank: the sort's
    order among them decides which anchors the gt takes."""
    found = 0
    for b in range(cost.shape[0]):
        for g in range(cost.shape[1]):
            row = cost[b, g]
            kth = np.sort(row, kind="stable")[k[b, g] - 1]
            tied = (row == kth) & cand[b, g]
            below = (row < kth).sum()
            found += int(tied.sum() > 1 and below + tied.sum() > k[b, g])
    return found


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_simota_assign_equals_jax(seed, tied):
    centers, strides = _grid()
    if tied:
        dec, boxes, labels, valid = _tied_decoded(seed)
        dec = jnp.asarray(dec)
    else:
        raw, boxes, labels, valid = _yolox_inputs(seed)
        dec = jyolox.decode_outputs(jnp.asarray(raw), jnp.asarray(centers),
                                    jnp.asarray(strides))
    want = _jax_assign()(dec, jnp.asarray(boxes), jnp.asarray(labels),
                         jnp.asarray(valid))
    got = tyolox.simota_assign(_t(dec), _t(centers), _t(strides), _t(boxes),
                               _t(labels), _t(valid), C)
    np.testing.assert_array_equal(got["fg"].numpy(), np.asarray(want["fg"]))
    np.testing.assert_array_equal(got["matched_gt"].numpy(),
                                  np.asarray(want["matched_gt"]))
    np.testing.assert_allclose(got["matched_iou"].numpy(),
                               np.asarray(want["matched_iou"]), atol=1e-6)
    assert np.asarray(want["fg"]).sum() > 0
    if tied:   # the case the stable sort exists for occurs in these inputs
        assert _decisive_ties(*_jax_cost_and_k(dec, boxes, labels,
                                                valid)) > 0


# ---------------------------------------------- family losses + grads
@pytest.mark.parametrize("use_l1", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_yolox_loss_and_grad_match_jax(seed, use_l1):
    raw, boxes, labels, valid = _yolox_inputs(seed + 10, spread=1.0)
    centers, strides = _grid()
    jargs = [jnp.asarray(a) for a in (centers, strides, boxes, labels,
                                      valid)]

    def jfn(r):
        out = jyolox.yolox_loss(r, *jargs, num_classes=C, use_l1=use_l1)
        return sum(out[k] for k in ("iou_loss", "obj_loss", "cls_loss",
                                    "l1_loss")), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(raw))
    r = _t(raw).requires_grad_()
    got = tyolox.yolox_loss(r, *(_t(a) for a in (centers, strides, boxes,
                                                 labels, valid)),
                            num_classes=C, use_l1=use_l1)
    total = sum(got[k] for k in ("iou_loss", "obj_loss", "cls_loss",
                                 "l1_loss"))
    total.backward()
    for k in ("iou_loss", "obj_loss", "cls_loss", "l1_loss"):
        assert _rel(got[k], want[k]) <= 1e-5, (k, float(got[k]),
                                               float(want[k]))
    assert float(got["num_fg"]) == float(want["num_fg"]) > 0
    assert (float(got["l1_loss"].detach()) > 0) == use_l1
    jg = np.asarray(jgrad)
    assert np.linalg.norm(r.grad.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)


@pytest.mark.parametrize("seed", range(2))
def test_retinanet_loss_and_grad_match_jax(seed):
    rng = np.random.default_rng(seed)
    anchors = jretina.retinanet_anchors((SIZE, SIZE))
    a = len(anchors)
    cls = rng.normal(-2, 1.5, (B, a, C)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, a, 4)).astype(np.float32)
    _, boxes, labels, valid = _yolox_inputs(seed + 20)
    boxes[:, 0] = anchors[100 + seed]            # an exact anchor match

    def jfn(c, d):
        out = jretina.retinanet_loss(
            {"cls_logits": c, "bbox_deltas": d}, jnp.asarray(anchors),
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
        return out["cls_loss"] + out["reg_loss"], out
    (_, want), (gc, gd) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                            jnp.asarray(deltas))
    c, d = _t(cls).requires_grad_(), _t(deltas).requires_grad_()
    got = tretina.retinanet_loss({"cls_logits": c, "bbox_deltas": d},
                                 _t(anchors), _t(boxes), _t(labels),
                                 _t(valid))
    (got["cls_loss"] + got["reg_loss"]).backward()
    for k in ("cls_loss", "reg_loss"):
        assert _rel(got[k], want[k]) <= 1e-5, k
    for mine, theirs in ((c.grad, gc), (d.grad, gd)):
        theirs = np.asarray(theirs)
        assert np.linalg.norm(mine.numpy() - theirs) <= \
            1e-4 * np.linalg.norm(theirs)


# ----------------------------------------------- three Adam steps each
FAMILIES = {"yolox_nano": 3, "retinanet_resnet18_fpn": 3}
ADAM_LR = 1e-4


@functools.lru_cache(maxsize=None)
def _three_steps_jax(name):
    """JAX's build_task loss with optax Adam + clip, three steps (one
    jitted step reused): the start, the losses, the batch_stats after the
    first step, the batches."""
    from train_detection import build_task as jbuild_task
    nc = FAMILIES[name]
    jmodel = JMODELS.build(name, num_classes=nc, dtype=jnp.float32)
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, SIZE, SIZE, 3))), seed=len(name))
    loss_fn, _ = jbuild_task(jmodel, name, nc, 0.3)
    params, stats = variables["params"], variables["batch_stats"]
    tx = jbuild_optimizer("adam", ADAM_LR, clip_grad_norm=1.0,
                          params=params)

    @jax.jit
    def step(params, opt_state, stats, batch):
        (total, new_stats), grads = jax.value_and_grad(
            lambda p: loss_fn(p, stats, batch, jax.random.key(0)),
            has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, new_stats,
                total)

    batches = _batches(nc)
    opt_state, losses, first = tx.init(params), [], None
    for batch in batches:
        params, opt_state, stats, total = step(
            params, opt_state, stats, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        losses.append(float(total))
        first = first or jax.tree.map(np.asarray, stats)
    return variables, losses, first, batches


def _batches(nc):
    images, boxes, labels, valid = tdet.synthetic_boxes(6, SIZE, nc, 4,
                                                        seed=5)
    return [{"image": images[i:i + 2], "boxes": boxes[i:i + 2],
             "labels": labels[i:i + 2], "valid": valid[i:i + 2]}
            for i in (0, 2, 4)]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_three_adam_steps_match_jax(name):
    variables, want_losses, first_stats, batches = _three_steps_jax(name)
    nc = FAMILIES[name]
    model = TMODELS.build(name, num_classes=nc, dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    loss_fn, _ = tdet.build_task(model, name, nc, 0.3)
    params = dict(model.named_parameters())
    state = TrainState.create(
        model=model, tx=build_optimizer("adam", ADAM_LR, clip_grad_norm=1.0,
                                        params=params),
        batch_stats=dict(model.named_buffers()))
    step = make_train_step(loss_fn, device="cpu")
    ref = convert.from_flax_params({"params": variables["params"],
                                    "batch_stats": first_stats}, like=model)
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert names
    for i, (batch, want) in enumerate(zip(batches, want_losses)):
        state, metrics = step(state, batch, 0)
        assert _rel(metrics["loss"], want) <= 1e-4, (i, float(
            metrics["loss"]), want)
        if i == 0:
            buffers = dict(model.named_buffers())
            for k in names:
                np.testing.assert_allclose(buffers[k].numpy(),
                                           ref[k].numpy(), atol=1e-5,
                                           err_msg=k)
    assert int(buffers[names[0].replace("running_mean", "num_batches_"
                                        "tracked").replace(
        "running_var", "num_batches_tracked")]) == 3


# -------------------------------------------------------- multi-scale
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_multiscale_schedule_equals_jax(seed):
    sizes = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
    j = jms.MultiScaleSchedule(sizes, change_every=4, seed=seed)
    t = tms.MultiScaleSchedule(sizes, change_every=4, seed=seed)
    assert [t.size_for_step(s) for s in range(100)] == \
        [j.size_for_step(s) for s in range(100)]
    assert tms.YOLOX_SIZES == jms.YOLOX_SIZES


@pytest.mark.parametrize("size", [48, 56, 80, 96])
def test_resize_detection_batch_matches_jax(size):
    rng = np.random.default_rng(size)
    batch = {"image": rng.uniform(0, 1.6, (2, SIZE, SIZE, 3)).astype(
                 np.float32),
             "boxes": rng.uniform(0, SIZE, (2, 4, 4)).astype(np.float32),
             "valid": np.ones((2, 4), bool)}
    want = jms.resize_detection_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, size)
    got = tms.resize_detection_batch({k: _t(v) for k, v in batch.items()},
                                     size)
    for k in ("image", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0)
    assert got["valid"] is not None
    same = {k: _t(v) for k, v in batch.items()}
    assert tms.resize_detection_batch(same, SIZE) is same
    calls = []
    wrapped = tms.make_multiscale_step(
        lambda st, b, *r: calls.append(b["image"].shape[1]),
        tms.MultiScaleSchedule((size,), seed=0))
    wrapped(None, same)
    assert calls == [size]


# ------------------------------------------------------- COCO metrics
def _coco_case(seed, n_img=8, nc=3):
    """Seeded gts over every area range (crowd among them) and detections
    jittered from them, with duplicates and false positives."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n_img):
        ng = int(rng.integers(0, 7))
        wh = np.exp(rng.uniform(np.log(8), np.log(200), (ng, 2)))
        xy = rng.uniform(0, 300, (ng, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gl = rng.integers(0, nc, ng)
        crowd = rng.uniform(size=ng) < 0.15
        pick = rng.integers(0, max(ng, 1), int(rng.integers(0, 12)))
        db = (gb[pick] + rng.normal(0, 6, (len(pick), 4))) if ng else \
            np.zeros((0, 4))
        dl = gl[pick] if ng else np.zeros(0, int)
        nf = int(rng.integers(0, 5))
        fxy = rng.uniform(0, 300, (nf, 2))
        db = np.concatenate([db, np.concatenate(
            [fxy, fxy + rng.uniform(5, 120, (nf, 2))], 1)])
        dl = np.concatenate([dl, rng.integers(0, nc, nf)])
        ds = np.round(rng.uniform(size=len(db)), 2)    # tied scores too
        cases.append(dict(gt_boxes=gb, gt_labels=gl, gt_crowd=crowd,
                          det_boxes=db, det_scores=ds, det_labels=dl))
    return cases


@pytest.mark.parametrize("use_cpp", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_coco_evaluator_matches_jax(seed, use_cpp):
    if use_cpp:
        from deeplearning_tpu_torch.native.build import load
        if shutil.which("g++") is None or load("cocoeval") is None:
            pytest.skip("g++ is missing: the C++ matcher cannot build")
    nc = 3
    cases = _coco_case(seed, nc=nc)
    j = jcoco_eval.CocoEvaluator(nc, use_cpp=False)
    t = tcoco_eval.CocoEvaluator(nc, use_cpp=use_cpp)
    for i, case in enumerate(cases):
        j.add_image(i, **case)
        t.add_image(i, **case)
    want, got = j.summarize(), t.summarize()
    assert got.keys() == want.keys() and len(got) == 12
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert any(v > 0 for v in want.values())
    if use_cpp:   # the C++ path really ran
        assert t._evaluate_cpp(0, (0.0, 1e10), 100) is not None


def test_coco_add_batch_takes_device_dicts_and_skips_padding():
    cases = _coco_case(3, n_img=4)
    d = 12
    det = {"boxes": torch.zeros(4, d, 4), "scores": torch.zeros(4, d),
           "labels": torch.full((4, d), -1), "valid": torch.zeros(4, d,
                                                                  dtype=bool)}
    gt = {"boxes": np.zeros((4, 6, 4)), "labels": np.zeros((4, 6), int),
          "valid": np.zeros((4, 6), bool), "crowd": np.zeros((4, 6), bool)}
    ref = tcoco_eval.CocoEvaluator(3, use_cpp=False)
    for i, c in enumerate(cases):
        n = min(len(c["det_boxes"]), d)
        det["boxes"][i, :n] = _t(c["det_boxes"][:n])
        det["scores"][i, :n] = _t(c["det_scores"][:n])
        det["labels"][i, :n] = _t(c["det_labels"][:n])
        det["valid"][i, :n] = True
        g = len(c["gt_boxes"])
        gt["boxes"][i, :g] = c["gt_boxes"]
        gt["labels"][i, :g] = c["gt_labels"]
        gt["valid"][i, :g] = True
        gt["crowd"][i, :g] = c["gt_crowd"]
        if i < 3:
            ref.add_image(i, gt_boxes=c["gt_boxes"],
                          gt_labels=c["gt_labels"], gt_crowd=c["gt_crowd"],
                          det_boxes=np.asarray(det["boxes"][i, :n],
                                               np.float64),
                          det_scores=np.asarray(det["scores"][i, :n],
                                                np.float64),
                          det_labels=c["det_labels"][:n])
    ev = tcoco_eval.CocoEvaluator(3, use_cpp=False)
    ev.add_batch(np.arange(4), det, gt, image_valid=np.arange(4) < 3)
    assert sorted(ev._gts) == [0, 1, 2]
    assert ev.summarize() == ref.summarize()


def test_precision_recall_helpers_match_jax():
    rng = np.random.default_rng(0)
    scores = np.round(rng.uniform(size=50), 2)
    tp = rng.uniform(size=50) < 0.4
    want = jmetrics.precision_recall_curve(scores, tp, 30)
    got = tmetrics.precision_recall_curve(scores, tp, 30)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ap"] == want["ap"] > 0
    pts = np.linspace(0, 1, 101)
    np.testing.assert_array_equal(
        tmetrics.interp_precision_at_recall(want["precision"],
                                            want["recall"], pts),
        jmetrics.interp_precision_at_recall(want["precision"],
                                            want["recall"], pts))
    assert tmetrics.precision_recall_curve([], [], 3)["ap"] == 0.0
    assert np.array_equal(tcoco_eval.IOU_THRS, jcoco_eval.IOU_THRS)
    assert tcoco_eval.AREA_RANGES == jcoco_eval.AREA_RANGES
    assert tcoco_eval.MAX_DETS == jcoco_eval.MAX_DETS


# -------------------------------------------------------- experiments
def _attrs(exp):
    return {k: getattr(exp, k) for k in dir(exp)
            if not k.startswith("_") and not callable(getattr(exp, k))}


def test_experiments_equal_jax():
    names = list(jexp.EXPERIMENTS)
    assert names and names == list(texp.EXPERIMENTS)
    for name in names:
        j = jexp.get_exp(exp_name=name)
        t = texp.get_exp(exp_name=name)
        assert _attrs(t) == _attrs(j), name
        if isinstance(j, jexp.DetectionExp):
            assert isinstance(t, texp.DetectionExp)
            assert t.cli_overrides() == j.cli_overrides()
            assert t.get_evaluator().num_classes == j.num_classes
    t = texp.get_exp(exp_name="yolox_s").merge(["img_size=416",
                                                "base_lr", "2"])
    assert (t.img_size, t.base_lr) == (416, 2.0)
    with pytest.raises(KeyError):
        t.merge(["nope=1"])
    model = texp.get_exp(exp_name="yolox_nano").merge(
        ["num_classes=3"]).get_model()
    assert isinstance(model, tyolox.YOLOX)
    with pytest.raises(KeyError):          # not ported yet: the registry
        texp.get_exp(exp_name="mae_pretrain").get_model()


# ---------------------------------------------------------- COCO data
def _write_coco(root):
    from PIL import Image
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"))
    coco = {"images": [], "annotations": [],
            "categories": [{"id": 7, "name": "kite"},
                           {"id": 2, "name": "dog"},
                           {"id": 4, "name": "cat"}]}
    aid = 1
    for i, (h, w) in enumerate([(40, 50), (64, 30), (33, 33), (20, 70),
                                (48, 48), (31, 57)]):
        name = f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(root, "images", name))
        coco["images"].append({"id": 100 + i, "file_name": name,
                               "height": h, "width": w})
        for _ in range(i % 4):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            coco["annotations"].append({
                "id": aid, "image_id": 100 + i, "iscrowd": 0,
                "category_id": int(rng.choice([7, 2, 4])),
                "bbox": [x, y, rng.uniform(2, w / 2), rng.uniform(2, h / 2)],
                "area": 1.0})
            aid += 1
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


def test_coco_source_matches_jax(tmp_path):
    path = _write_coco(str(tmp_path))
    jrec, jnames = jcoco.load_coco_json(path)
    trec, tnames = tcoco.load_coco_json(path)
    assert tnames == jnames == ["dog", "cat", "kite"]
    assert len(trec) == len(jrec) == 6
    for a, b in zip(trec, jrec):
        assert a["filename"] == b["filename"] and a["names"] == b["names"]
        np.testing.assert_array_equal(np.asarray(a["boxes"]),
                                      np.asarray(b["boxes"]))
    jsrc, _ = jcoco.coco_detection_source(path, image_size=32, max_gt=2)
    tsrc, _ = tcoco.coco_detection_source(path, image_size=32, max_gt=2)
    for i in range(6):
        want, got = jsrc[i], tsrc[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    batch = tsrc[np.arange(3)]
    assert batch["image"].shape == (3, 32, 32, 3)
    flip, _ = tcoco.coco_detection_source(path, image_size=32, max_gt=2,
                                          augment=True, seed=1)
    assert flip[3]["image"].shape == (32, 32, 3)
    with pytest.raises(ValueError, match="5d"):
        tcoco.coco_detection_source(path, mosaic=True)


# ---------------------------------------------------------------- CLI
_BASE = ["train.device=cpu", "model.image_size=64", "data.batch=2",
         "data.n_train=4", "train.steps=2"]


@pytest.mark.parametrize("extra", [
    ["model.name=yolox_nano", "train.multiscale=true",
     "train.no_aug_steps=1"],
    [],                                    # the default: RetinaNet R18-FPN
])
def test_cli_trains_and_prints_the_summary(extra, capsys):
    assert tdet.main(_BASE + extra) == 0
    out = capsys.readouterr().out
    line = out.strip().splitlines()[-1]
    summary = eval(line)                   # noqa: S307 (our own dict repr)
    assert len(summary) == 12 and "'AP'" in out and "nan" not in out
    assert "step 0: loss=" in out
    if extra:
        assert "adding L1 loss" in out


def test_cli_coco_split_and_exp(tmp_path, capsys):
    path = _write_coco(str(tmp_path))
    cfg = tdet.DetConfig(
        model=tdet.DetModelCfg(name="yolox_nano", num_classes=3,
                               image_size=32),
        data=tdet.DetDataCfg(coco=path, batch=2, max_gt=3, val_rate=0.5,
                             num_workers=2),
        train=tdet.DetTrainCfg(steps=2, device="cpu"))
    r = tdet.build(cfg)
    try:
        steps = [it for it, _, _ in tdet.train_steps(r)]
    finally:
        r.close()
    summary, ev, calls = tdet.evaluate(r)
    assert steps == [0, 1] and r.state.step == 2
    assert len(summary) == 12
    assert len(calls) == 2                        # 3 val images, 2 chunks
    assert sorted(ev._gts) == [0, 1, 2]
    assert tdet.main(["--exp", "yolox_nano", "model.image_size=64",
                      "data.batch=2", "data.n_train=4", "data.max_gt=4",
                      "model.num_classes=3", "train.steps=1",
                      "train.multiscale=false", "train.device=cpu"]) == 0
    assert "'AP'" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["model.name=fcos_resnet18_fpn"], "5d"),
    (["model.name=fasterrcnn_resnet18_fpn"], "5d"),
    (["model.name=yolov5s"], "5d"),
    (["--evolve", "2"], "5d"),
    (["data.mosaic=true"], "5d"),
    (["data.random_perspective=true"], "5d"),
    (["model.name=yolox_nano", "train.eval_tta=true"], "item 6"),
])
def test_cli_later_items_raise(argv, item):
    with pytest.raises(ValueError, match=item):
        tdet.main(_BASE + argv)


def test_run_refuses_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.run(tdet.DetConfig())
