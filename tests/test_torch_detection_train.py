"""Detection training and COCO evaluation of the port vs the JAX package,
on the CPU: losses, the anchor matcher and sampler, SimOTA, every
family's targets and losses with their gradients, three Adam steps of
each family, multi-scale sizes and resizes, mosaic and random
perspective, autoanchor, evolution, VOC AP, the COCO evaluator (numpy and
C++ matching), the experiments, the COCO source and the detection CLI.

- Losses: ``binary_cross_entropy``, ``sigmoid_focal_loss`` and
  ``smooth_l1`` within 1e-6 for each reduction, with and without weights.
- ``match_anchors`` and ``simota_assign`` equal JAX's exactly (SimOTA's
  matched IoU within 1e-6) at 64², G = 6, C = 5, on seeded head outputs
  and on decoded rows built so that float32 costs tie: the test shows a
  tie that decides which anchors a gt takes. ``balanced_sample`` draws
  from torch's generator (JAX's from ``jax.random``): held by property
  over 200 seeds (exact counts, subsets, BETWEEN never taken, every
  candidate reached).
- ``fcos_targets``, YOLOv5's ``build_targets`` and ``sample_rois`` (every
  candidate sampled, so no draw enters) equal JAX's exactly, float
  targets within 1e-6, on gts with an equal-area tie built in.
- ``yolox_loss`` (``use_l1`` off and on) and ``retinanet_loss`` from the
  same raw outputs: each term within 1e-5 relative; ``rpn_loss`` (every
  anchor sampled), ``roi_head_loss``, ``fcos_loss`` and ``yolov5_loss``
  within 1e-4; the gradient with respect to the raw outputs within 1e-4
  of its norm.
- Three Adam steps (lr 1e-4, clip 1.0) of ``yolox_nano``,
  ``retinanet_resnet18_fpn``, ``fcos_resnet18_fpn``,
  ``fasterrcnn_resnet18_fpn`` and ``yolov5s`` at 64², float32 on both
  sides (FCOS: JAX in float64, see ``JAX_FLOAT64``), the same converted
  weights and batches: the port's ``build_task`` loss through
  ``make_train_step`` against JAX's ``build_task`` loss with optax; losses
  within 1e-4 relative at each step, the BatchNorm statistics the first
  step leaves (one train-mode forward on equal weights: the momentum and
  the biased batch variance) within 1e-5. Adam's first steps move every
  parameter by about ±lr whatever its gradient's size, so a float32
  rounding difference in a gradient near zero becomes an lr-sized
  parameter difference; the seeded networks' first gradients are
  themselves ill-conditioned (layer4's BatchNorm sees 8 values a channel
  at 64² and batch 2). At lr 1e-3 the losses drift apart by ~1e-3 by the
  third step, and a YOLOX positive count that changes with it moves the
  loss by tens of percent; at 1e-4 they stay within 1e-4. Faster R-CNN
  samples through a deterministic test double of ``balanced_sample`` on
  both sides and trains with its backbone's BatchNorm frozen
  (``FROZEN_BN``).
- ``MultiScaleSchedule`` equal for 100 steps and three seeds;
  ``resize_detection_batch`` within 1e-5 up and down.
- ``mosaic4``, ``random_perspective``, ``mosaic_array_source`` and the
  COCO mosaic source equal JAX's exactly from one seed, with cv2 as
  installed and hidden (``_warp_np``); ``kmean_anchors``,
  ``check_anchors``, ``evolve`` / ``mutate`` and ``voc_map`` equal JAX's.
- ``CocoEvaluator`` summaries within 1e-12 of JAX's on seeded detections
  with crowd gts over every area range, through both matching paths.
- Two CPU runs of the detection CLI's steps at four torch threads give
  bit-equal losses.
"""

import functools
import itertools
import json
import math
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
from deeplearning_tpu.data import mixup as jmixup
from deeplearning_tpu.data import transforms as jtransforms
from deeplearning_tpu.evaluation import coco_eval as jcoco_eval
from deeplearning_tpu.evaluation import metrics as jmetrics
from deeplearning_tpu.evaluation import voc as jvoc
from deeplearning_tpu.models.detection import faster_rcnn as jfrcnn
from deeplearning_tpu.models.detection import fcos as jfcos
from deeplearning_tpu.models.detection import retinanet as jretina
from deeplearning_tpu.models.detection import yolov5 as jyolov5
from deeplearning_tpu.models.detection import yolox as jyolox
from deeplearning_tpu.ops import losses as jlosses
from deeplearning_tpu.ops import matcher as jmatcher
from deeplearning_tpu.train import evolve as jevolve
from deeplearning_tpu.train import multiscale as jms
from deeplearning_tpu.train.optim import build_optimizer as jbuild_optimizer
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import experiment as texp
from deeplearning_tpu_torch.core.config import load_config
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.data import coco as tcoco
from deeplearning_tpu_torch.data import mixup as tmixup
from deeplearning_tpu_torch.data import transforms as ttransforms
from deeplearning_tpu_torch.evaluation import coco_eval as tcoco_eval
from deeplearning_tpu_torch.evaluation import metrics as tmetrics
from deeplearning_tpu_torch.evaluation import voc as tvoc
from deeplearning_tpu_torch.models.detection import faster_rcnn as tfrcnn
from deeplearning_tpu_torch.models.detection import fcos as tfcos
from deeplearning_tpu_torch.models.detection import retinanet as tretina
from deeplearning_tpu_torch.models.detection import yolov5 as tyolov5
from deeplearning_tpu_torch.models.detection import yolox as tyolox
from deeplearning_tpu_torch.models.detection.predict import head_classes
from deeplearning_tpu_torch.ops import losses as tlosses
from deeplearning_tpu_torch.ops import matcher as tmatcher
from deeplearning_tpu_torch.train import detection as tdet
from deeplearning_tpu_torch.train import evolve as tevolve
from deeplearning_tpu_torch.train import multiscale as tms
from deeplearning_tpu_torch.train.optim import build_optimizer
from deeplearning_tpu_torch.train.state import TrainState
from deeplearning_tpu_torch.train.steps import make_train_step
from deeplearning_tpu_torch.utils import convert

from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("batch,fraction", [(16, 0.5), (64, 0.25),
                                            (400, 0.5)])
def test_balanced_sample_counts_and_reach(batch, fraction):
    """Over 200 generator seeds: exactly min(candidates, int(batch ·
    fraction)) positives and min(candidates, batch − positives) negatives
    an image, a subset of each kind's candidates, BETWEEN never taken, and
    every candidate taken at least once; one seed, one sample."""
    rng = np.random.default_rng(batch)
    matches = _t(rng.choice([tmatcher.BETWEEN, tmatcher.BELOW_LOW, 0, 1, 2],
                            size=(2, 120), p=[0.2, 0.5, 0.1, 0.1, 0.1]))
    pos_c, neg_c = matches >= 0, matches == tmatcher.BELOW_LOW
    limit = int(batch * fraction)
    seen_pos, seen_neg = torch.zeros_like(pos_c), torch.zeros_like(neg_c)
    for seed in range(200):
        gen = torch.Generator().manual_seed(seed)
        pos, neg = tmatcher.balanced_sample(matches, gen, batch, fraction)
        n_pos = pos_c.sum(-1).clamp(max=limit)
        assert torch.equal(pos.sum(-1), n_pos)
        assert torch.equal(neg.sum(-1),
                           torch.minimum(neg_c.sum(-1), batch - n_pos))
        assert not (pos & ~pos_c).any() and not (neg & ~neg_c).any()
        seen_pos |= pos
        seen_neg |= neg
    assert torch.equal(seen_pos, pos_c) and torch.equal(seen_neg, neg_c)
    again = tmatcher.balanced_sample(
        matches, torch.Generator().manual_seed(199), batch, fraction)
    assert torch.equal(again[0], pos) and torch.equal(again[1], neg)


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


# ------------------------------------------------------ Faster R-CNN
def _gts(seed):
    """Seeded gts of ``_yolox_inputs`` with one tie built in: image 0's
    second gt is its first moved by 1 px (equal areas and sides)."""
    _, boxes, labels, valid = _yolox_inputs(seed)
    boxes[0, 1] = boxes[0, 0] + 1.0
    return boxes, labels, valid


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grads_close(mine, theirs, tol=1e-4):
    for g, w in zip(mine, theirs):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= tol * np.linalg.norm(w)


@pytest.mark.parametrize("seed", range(2))
def test_rpn_loss_and_grad_match_jax(seed):
    """Every candidate anchor sampled (batch_per_image above the anchor
    count), so no random draw enters either side."""
    anchors = jfrcnn.fasterrcnn_anchors((SIZE, SIZE))
    a = len(anchors)
    rng = np.random.default_rng(seed + 30)
    obj = rng.normal(0, 2, (B, a)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, a, 4)).astype(np.float32)
    boxes, _, valid = _gts(seed + 30)
    boxes[1, 0] = anchors[300 + seed]            # an exact anchor match
    kw = dict(batch_per_image=2 * a, positive_fraction=0.5)

    def jfn(o, d):
        out = jfrcnn.rpn_loss({"rpn_obj": o, "rpn_deltas": d},
                              jnp.asarray(anchors), jnp.asarray(boxes),
                              jnp.asarray(valid), jax.random.key(0), **kw)
        return out["rpn_obj_loss"] + out["rpn_reg_loss"], out
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(obj, deltas)
    o, d = _t(obj).requires_grad_(), _t(deltas).requires_grad_()
    got = tfrcnn.rpn_loss({"rpn_obj": o, "rpn_deltas": d}, _t(anchors),
                          _t(boxes), _t(valid),
                          torch.Generator().manual_seed(0), **kw)
    (got["rpn_obj_loss"] + got["rpn_reg_loss"]).backward()
    for k in ("rpn_obj_loss", "rpn_reg_loss"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, float(got[k]),
                                               float(want[k]))
    assert float(want["rpn_reg_loss"]) > 0
    _grads_close((o.grad, d.grad), jgrads)


def _proposals(seed, p=24):
    """Seeded proposals: the first six jittered from the gts, the rest
    anywhere; a fifth of them padded."""
    rng = np.random.default_rng(seed)
    boxes, labels, valid = _gts(seed)
    xy = rng.uniform(0, 48, (B, p, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 30, (B, p, 2))], -1)
    props[:, :G] = boxes + rng.normal(0, 2, (B, G, 4))
    pvalid = rng.uniform(size=(B, p)) < 0.8
    labels1 = np.where(valid, labels + 1, 0)
    return props.astype(np.float32), pvalid, boxes, labels1, valid


@pytest.mark.parametrize("seed", range(2))
def test_sample_rois_matches_jax(seed):
    """Every candidate sampled (batch_per_image above the RoI count): the
    RoIs, class targets, positives and samples equal JAX's exactly, the
    box targets within 1e-6; no padded proposal is sampled."""
    props, pvalid, boxes, labels1, valid = _proposals(seed + 40)
    kw = dict(batch_per_image=8 * props.shape[1], positive_fraction=0.5)
    want = jax.jit(lambda *a: jfrcnn.sample_rois(
        *a, jax.random.key(0), **kw))(props, pvalid, boxes, labels1, valid)
    got = tfrcnn.sample_rois(_t(props), _t(pvalid), _t(boxes), _t(labels1),
                             _t(valid), torch.Generator().manual_seed(0),
                             **kw)
    for k in ("rois", "cls_target", "pos", "sample"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    _close(got["reg_target"], want["reg_target"])
    all_valid = np.concatenate([pvalid, valid], 1)
    assert not (got["sample"].numpy() & ~all_valid).any()
    assert got["pos"].any() and (got["sample"] & ~got["pos"]).any()


@pytest.mark.parametrize("seed", range(2))
def test_roi_head_loss_and_grad_match_jax(seed):
    rng = np.random.default_rng(seed + 45)
    p, k = 40, C + 1
    scores = rng.normal(0, 2, (B, p, k)).astype(np.float32)
    deltas = rng.normal(0, 0.7, (B, p, k, 4)).astype(np.float32)
    pos = rng.uniform(size=(B, p)) < 0.3
    samples = {"cls_target": np.where(pos, rng.integers(1, k, (B, p)), 0),
               "reg_target": rng.normal(0, 0.5, (B, p, 4)).astype(
                   np.float32),
               "pos": pos, "sample": pos | (rng.uniform(size=(B, p)) < 0.5)}

    def jfn(sc, de):
        out = jfrcnn.roi_head_loss(sc, de, {key: jnp.asarray(v) for key, v
                                            in samples.items()})
        return out["roi_cls_loss"] + out["roi_reg_loss"], out
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(scores, deltas)
    sc, de = _t(scores).requires_grad_(), _t(deltas).requires_grad_()
    got = tfrcnn.roi_head_loss(sc, de, {key: _t(v) for key, v in
                                        samples.items()})
    (got["roi_cls_loss"] + got["roi_reg_loss"]).backward()
    for key in ("roi_cls_loss", "roi_reg_loss"):
        assert _rel(got[key], want[key]) <= 1e-4, key
    _grads_close((sc.grad, de.grad), jgrads)


# --------------------------------------------------------------- FCOS
@pytest.mark.parametrize("seed", range(2))
def test_fcos_targets_match_jax(seed):
    locs, lvl = jfcos.fcos_locations((SIZE, SIZE))
    boxes, labels, valid = _gts(seed + 50)
    want = jax.jit(jfcos.fcos_targets)(locs, lvl, boxes, labels, valid)
    got = tfcos.fcos_targets(_t(locs), _t(lvl), _t(boxes), _t(labels),
                             _t(valid))
    for k in ("cls", "pos"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("reg", "ctr"):
        _close(got[k], want[k])
    assert np.asarray(want["pos"]).sum() > 0


@pytest.mark.parametrize("seed", range(2))
def test_fcos_loss_and_grad_match_jax(seed):
    locs, lvl = jfcos.fcos_locations((SIZE, SIZE))
    n = len(locs)
    boxes, labels, valid = _gts(seed + 55)
    tgt = {k: np.asarray(v) for k, v in jax.jit(jfcos.fcos_targets)(
        locs, lvl, boxes, labels, valid).items()}
    rng = np.random.default_rng(seed + 55)
    cls = rng.normal(-2, 1.5, (B, n, C)).astype(np.float32)
    ctr = rng.normal(0, 1, (B, n)).astype(np.float32)
    ltrb = np.exp(rng.normal(1.5, 0.8, (B, n, 4))).astype(np.float32)

    def jfn(c, t, r):
        out = jfcos.fcos_loss({"cls_logits": c, "centerness": t, "ltrb": r},
                              {k: jnp.asarray(v) for k, v in tgt.items()})
        return out["cls_loss"] + out["ctr_loss"] + out["reg_loss"], out
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(cls, ctr, ltrb)
    ins = [_t(a).requires_grad_() for a in (cls, ctr, ltrb)]
    got = tfcos.fcos_loss(dict(zip(("cls_logits", "centerness", "ltrb"),
                                   ins)), {k: _t(v) for k, v in tgt.items()})
    (got["cls_loss"] + got["ctr_loss"] + got["reg_loss"]).backward()
    for k in ("cls_loss", "ctr_loss", "reg_loss"):
        assert _rel(got[k], want[k]) <= 1e-4, k
    _grads_close([x.grad for x in ins], jgrads)


# ------------------------------------------------------------- YOLOv5
def _v5_grid():
    return jyolov5.yolov5_grid((SIZE, SIZE))


@pytest.mark.parametrize("seed", range(2))
def test_yolov5_build_targets_match_jax(seed):
    grid = _v5_grid()
    boxes, labels, valid = _gts(seed + 60)
    want = jax.jit(jyolov5.build_targets)(
        {k: jnp.asarray(v) for k, v in grid.items()}, boxes, labels, valid)
    got = tyolov5.build_targets({k: _t(v) for k, v in grid.items()},
                                _t(boxes), _t(labels), _t(valid))
    for k in ("pos", "matched_gt"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert np.asarray(want["pos"]).sum() > 0


@pytest.mark.parametrize("seed", range(2))
def test_yolov5_loss_and_grad_match_jax(seed):
    grid = _v5_grid()
    boxes, labels, valid = _gts(seed + 65)
    raw = np.random.default_rng(seed + 65).normal(
        0, 1, (B, len(grid["stride"]), 5 + C)).astype(np.float32)

    def jfn(r):
        out = jyolov5.yolov5_loss(
            r, {k: jnp.asarray(v) for k, v in grid.items()},
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
            num_classes=C)
        return out["box_loss"] + out["obj_loss"] + out["cls_loss"], out
    (_, want), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(raw)
    r = _t(raw).requires_grad_()
    got = tyolov5.yolov5_loss(r, {k: _t(v) for k, v in grid.items()},
                              _t(boxes), _t(labels), _t(valid),
                              num_classes=C)
    (got["box_loss"] + got["obj_loss"] + got["cls_loss"]).backward()
    for k in ("box_loss", "obj_loss", "cls_loss"):
        assert _rel(got[k], want[k]) <= 1e-4, k
        assert float(want[k]) > 0
    _grads_close([r.grad], [jgrad])


def test_autoanchor_helpers_equal_jax():
    wh = np.random.default_rng(0).uniform(1, 120, (300, 2))
    for seed in (0, 1):
        np.testing.assert_array_equal(tyolov5.kmean_anchors(wh, seed=seed),
                                      jyolov5.kmean_anchors(wh, seed=seed))
    anchors = np.asarray(jyolov5.DEFAULT_ANCHORS, np.float64)
    for thr in (4.0, 2.0):
        assert tyolov5.check_anchors(wh, anchors, thr) == \
            jyolov5.check_anchors(wh, anchors, thr)
    with pytest.raises(ValueError, match="no valid gt"):
        tyolov5.check_anchors(np.zeros((3, 2)), anchors)


# ----------------------------------------------- three Adam steps each
FAMILIES = {"yolox_nano": 3, "retinanet_resnet18_fpn": 3,
            "fcos_resnet18_fpn": 3, "fasterrcnn_resnet18_fpn": 3,
            "yolov5s": 3}
ADAM_LR = 1e-4
# Faster R-CNN's proposals and sampled RoIs an image, cut from 256 and 128:
# its 12 544-wide box head dominates a CPU step
RCNN_KW = dict(post_nms_top_n=32, roi_batch=16)
# JAX's float32 FCOS gradient is 6e-3 from a float64 one (the error enters
# at its class tower's backward), the port's 2e-5: FCOS is held against
# JAX's steps in float64 (at step 2 the port is 2e-5 from them, 2e-3 from
# JAX's float32 ones)
JAX_FLOAT64 = ("fcos_resnet18_fpn",)
# Faster R-CNN with its backbone's BatchNorm frozen, as the reference
# trains it (FrozenBatchNorm2d): with batch statistics, layer4's BatchNorm
# normalises 8 values a channel at 64² and batch 2, and its backward
# cancels, so each float32 side is 1e-3 from float64 after two Adam steps
# (the other families cover BatchNorm's batch statistics)
FROZEN_BN = ("fasterrcnn_resnet18_fpn",)


def _fixed_keys(n):
    """A fixed permutation of 0..n-1 (7 919 is prime): the sampling keys
    of the test double below, spread over every pyramid level."""
    return (np.arange(n) * 7919) % n


def _sample_by_fixed_keys_jax(matches, rng, batch, fraction):
    """A deterministic stand-in for ``balanced_sample``: the candidates of
    lowest fixed key, with its counts."""
    key = jnp.asarray(_fixed_keys(matches.shape[-1]))

    def pick(cand, limit):
        score = jnp.where(cand, key, matches.shape[-1])
        rank = jnp.argsort(jnp.argsort(score, -1), -1)
        return cand & (rank < limit)
    pos = pick(matches >= 0, int(batch * fraction))
    neg = pick(matches == jmatcher.BELOW_LOW,
               batch - jnp.sum(pos, -1, keepdims=True))
    return pos, neg


def _sample_by_fixed_keys(matches, generator, batch, fraction):
    key = torch.from_numpy(_fixed_keys(matches.shape[-1]))

    def pick(cand, limit):
        score = torch.where(cand, key, matches.shape[-1])
        rank = torch.argsort(torch.argsort(score, -1), -1)
        return cand & (rank < limit)
    pos = pick(matches >= 0, int(batch * fraction))
    neg = pick(matches == tmatcher.BELOW_LOW,
               batch - pos.sum(-1, keepdim=True))
    return pos, neg


@functools.lru_cache(maxsize=None)
def _three_steps_jax(name):
    """JAX's build_task loss with optax Adam + clip, three steps (one
    jitted step reused): the start, the losses, the batch_stats after the
    first step, the batches."""
    with jax.enable_x64(name in JAX_FLOAT64):
        return _jax_steps(name)


def _jax_steps(name):
    from train_detection import build_task as jbuild_task
    nc = FAMILIES[name]
    dtype = jnp.float64 if name in JAX_FLOAT64 else jnp.float32
    jmodel = JMODELS.build(name, num_classes=head_classes(name, nc),
                           dtype=dtype, **_model_kw(name))
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, SIZE, SIZE, 3))), seed=len(name))
    loss_fn, _ = jbuild_task(jmodel, name, nc, 0.3, rcnn_kw=RCNN_KW)
    start = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    params, stats = start["params"], start["batch_stats"]
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
            params, opt_state, stats,
            {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None)
             for k, v in batch.items()})
        losses.append(float(total))
        first = first or jax.tree.map(np.asarray, stats)
    return variables, losses, first, batches


def _model_kw(name):
    return {"backbone_frozen_bn": True} if name in FROZEN_BN else {}


def _batches(nc):
    images, boxes, labels, valid = tdet.synthetic_boxes(6, SIZE, nc, 4,
                                                        seed=5)
    return [{"image": images[i:i + 2], "boxes": boxes[i:i + 2],
             "labels": labels[i:i + 2], "valid": valid[i:i + 2]}
            for i in (0, 2, 4)]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_three_adam_steps_match_jax(name, monkeypatch):
    """Faster R-CNN's samplers take the candidates of lowest fixed key on
    both sides (a test double of ``balanced_sample``): its draws are
    torch's in the port and jax.random's in JAX."""
    monkeypatch.setattr(jmatcher, "balanced_sample",
                        _sample_by_fixed_keys_jax)
    monkeypatch.setattr(tmatcher, "balanced_sample", _sample_by_fixed_keys)
    variables, want_losses, first_stats, batches = _three_steps_jax(name)
    nc = FAMILIES[name]
    model = TMODELS.build(name, num_classes=head_classes(name, nc),
                          dtype=torch.float32, **_model_kw(name))
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    loss_fn, _ = tdet.build_task(model, name, nc, 0.3, rcnn_kw=RCNN_KW)
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
        "running_var", "num_batches_tracked")]) == (
            0 if name in FROZEN_BN else 3)


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
    # MAE-B/16's widths on the meta device (no initialisation to pay for)
    with torch.device("meta"):
        mae = texp.get_exp(exp_name="mae_pretrain").get_model()
    from deeplearning_tpu_torch.models.ssl.mae import MAE
    assert isinstance(mae, MAE) and mae.enc_pos.shape == (1, 196, 768)
    assert (mae.depth, mae.decoder_depth) == (12, 8)
    assert mae.dec_pos.shape == (1, 196, 512)
    assert mae.enc_block0.attn.num_heads == 12
    assert mae.dec_block0.attn.num_heads == 16


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


@pytest.fixture
def fresh_thread_streams(monkeypatch):
    """Both packages' per-thread numpy streams restart their counters, so
    a source's first thread draws the same stream in each."""
    monkeypatch.setattr(jtransforms, "_THREAD_SEED", itertools.count())
    monkeypatch.setattr(ttransforms, "_THREAD_SEED", itertools.count())


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for x, y in zip(a, b):
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                np.testing.assert_array_equal(x, y)


PERSPECTIVES = [dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0),
                dict(degrees=10.0, translate=0.2, scale=0.3, shear=5.0)]


def test_coco_mosaic_source_matches_jax(tmp_path, fresh_thread_streams):
    """Mosaic samples (flip, perspective, tiles from a pool) equal JAX's
    from one seed."""
    path = _write_coco(str(tmp_path))
    kw = dict(image_size=32, max_gt=2, augment=True, seed=3, mosaic=True,
              perspective=PERSPECTIVES[0], mosaic_pool=[0, 2, 3, 5])
    jsrc, _ = jcoco.coco_detection_source(path, **kw)
    tsrc, _ = tcoco.coco_detection_source(path, **kw)
    got = [tsrc[i] for i in range(6)]
    _assert_samples_equal(got, [jsrc[i] for i in range(6)])
    assert got[0]["boxes"].shape == (8, 4)
    assert sum(int(g["valid"].sum()) for g in got) > 0


def _mosaic_inputs(seed):
    rng = np.random.default_rng(seed)
    imgs, boxes, labels = [], [], []
    for h, w in [(40, 50), (64, 30), (33, 33), (20, 70)]:
        imgs.append(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, [w / 2, h / 2], (n, 2))
        boxes.append(np.concatenate(
            [xy, xy + rng.uniform(4, [w / 2, h / 2], (n, 2))],
            1).astype(np.float32))
        labels.append(rng.integers(0, 3, n))
    return imgs, boxes, labels


def _augment_outputs(mixup, seed):
    """mosaic4 with and without perspective, random_perspective alone
    (affine and projective) and mosaic_array_source, from one seed."""
    imgs, boxes, labels = _mosaic_inputs(seed)
    out = []
    for persp in [None] + PERSPECTIVES:
        out.append(mixup.mosaic4(imgs, boxes, labels, 32,
                                 np.random.default_rng(seed), max_boxes=8,
                                 perspective=persp))
    for extra in (0.0, 1e-3):
        out.append(mixup.random_perspective(
            imgs[0], np.concatenate(boxes[:2]), np.concatenate(labels[:2]),
            np.random.default_rng(seed), perspective=extra, border=(4, 2),
            **PERSPECTIVES[1]))
    arrays = tdet.synthetic_boxes(6, 32, 3, 4, seed=seed)
    src = mixup.mosaic_array_source(*arrays, out_size=32, max_boxes=4,
                                    seed=seed, perspective=PERSPECTIVES[0])
    out += [src[i] for i in range(6)]
    return out


@pytest.mark.parametrize("cv2", ["as installed", "hidden"])
def test_mosaic_and_perspective_equal_jax(cv2, monkeypatch,
                                          fresh_thread_streams):
    """Canvases, boxes, labels and masks equal JAX's exactly, through cv2
    where it imports and through ``_warp_np`` and the numpy resize with it
    hidden on both sides."""
    if cv2 == "hidden":
        monkeypatch.setitem(sys.modules, "cv2", None)
    for seed in (0, 1):
        got = _augment_outputs(tmixup, seed)
        _assert_samples_equal(got, _augment_outputs(jmixup, seed))
        assert any(int(g[3].sum()) for g in got[:3])
    boxes = np.array([[0, 0, 10, 10], [0, 0, 1, 10], [0, 0, 30, 1]],
                     np.float32)
    np.testing.assert_array_equal(
        tmixup.box_candidates(boxes.T, boxes.T * 1.1),
        jmixup.box_candidates(boxes.T, boxes.T * 1.1))


def test_evolve_equals_jax(tmp_path):
    """The same generations, records and best hyperparameters as JAX's
    from one seed, resumed from the records; mutate and the fitness
    helpers too."""
    meta = {"lr": jevolve.DETECTION_META["lr"],
            "clip_grad_norm": (1.0, 0.1, 10.0), "fliplr": (0.0, 0.0, 1.0)}
    hyp0 = {"lr": 1e-3, "clip_grad_norm": 1.0, "fliplr": 0.5}

    def fitness(h):
        return -abs(math.log10(h["lr"]) + 2.5) - abs(h["clip_grad_norm"] - 2)
    for gens in (5, 3):                      # the second run resumes
        best = [mod.evolve(fitness, hyp0, meta, gens,
                           str(tmp_path / f"{name}.jsonl"), seed=gens)
                for mod, name in ((tevolve, "t"), (jevolve, "j"))]
        assert best[0] == best[1]
    recs = tevolve.load_records(str(tmp_path / "t.jsonl"))
    assert recs == jevolve.load_records(str(tmp_path / "j.jsonl"))
    assert len(recs) == 8 and all(r["hyp"]["fliplr"] == 0.5 for r in recs)
    assert tevolve.best_hyp(str(tmp_path / "t.jsonl")) == best[0]
    assert tevolve.best_hyp(str(tmp_path / "none.jsonl")) is None
    for seed in range(4):
        assert tevolve.mutate(hyp0, meta, np.random.default_rng(seed)) == \
            jevolve.mutate(hyp0, meta, np.random.default_rng(seed))
    assert tevolve.mutate({"fliplr": 0.5}, meta,
                          np.random.default_rng(0)) == {"fliplr": 0.5}
    summary = {"AP": 0.3, "AP50": 0.6}
    assert tevolve.det_fitness(summary) == jevolve.det_fitness(summary)
    assert tevolve.DETECTION_META == jevolve.DETECTION_META


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_map_equals_jax(use_07):
    """VOC AP of seeded gts (some difficult) and detections, over classes
    with and without detections."""
    cases = _coco_case(4, nc=4)
    gt, dets = {}, {}
    for i, c in enumerate(cases):
        for k in range(4):
            m = c["gt_labels"] == k
            gt.setdefault(k, {})[i] = {"boxes": c["gt_boxes"][m],
                                       "difficult": c["gt_crowd"][m]}
            d = c["det_labels"] == k
            dets.setdefault(k, []).append(np.concatenate(
                [np.full((d.sum(), 1), i), c["det_scores"][d, None],
                 c["det_boxes"][d]], 1))
    dets = {k: np.concatenate(v) for k, v in dets.items() if k != 3}
    want = jvoc.voc_map(gt, dets, 5, 0.5, use_07)
    got = tvoc.voc_map(gt, dets, 5, 0.5, use_07)
    assert got == want and 0 < want["mAP"] < 1
    for iou in (0.3, 0.7):
        assert tvoc.voc_eval_class(gt[0], dets[0], iou)["ap"] == \
            jvoc.voc_eval_class(gt[0], dets[0], iou)["ap"]


# ---------------------------------------------------------------- CLI
_BASE = ["train.device=cpu", "model.image_size=64", "data.batch=2",
         "data.n_train=4", "train.steps=2"]


@pytest.mark.parametrize("extra", [
    ["model.name=yolox_nano", "train.multiscale=true",
     "train.no_aug_steps=1"],
    [],                                    # the default: RetinaNet R18-FPN
    ["model.name=fcos_resnet18_fpn"],
    ["model.name=fasterrcnn_resnet18_fpn", "model.rcnn_post_nms_top_n=32",
     "model.rcnn_roi_batch=16"],
    ["model.name=yolov5s"],
    ["data.mosaic=true", "data.random_perspective=true",
     "train.no_aug_steps=1"],
])
def test_cli_trains_and_prints_the_summary(extra, capsys):
    assert tdet.main(_BASE + extra) == 0
    out = capsys.readouterr().out
    line = out.strip().splitlines()[-1]
    summary = eval(line)                   # noqa: S307 (our own dict repr)
    assert len(summary) == 12 and "'AP'" in out and "nan" not in out
    assert "step 0: loss=" in out
    assert ("closing mosaic/perspective" in out) == \
        ("train.no_aug_steps=1" in extra)
    assert ("adding L1 loss" in out) == ("model.name=yolox_nano" in extra)


def test_cli_evolve_writes_its_records(tmp_path, monkeypatch, capsys):
    """``--evolve 2``: two whole runs, their records under the working
    directory, the best hyperparameters printed."""
    monkeypatch.chdir(tmp_path)
    assert tdet.main(_BASE + ["model.name=yolox_nano", "--evolve", "2"]) == 0
    recs = tevolve.load_records(str(tmp_path / tdet.EVOLVE_RECORDS))
    assert len(recs) == 2
    assert recs[0]["hyp"] == {"lr": 1e-3, "clip_grad_norm": 1.0}
    assert all(set(r["hyp"]) == {"lr", "clip_grad_norm"} for r in recs)
    out = capsys.readouterr().out
    assert out.count("'AP'") == 2 and "evolve done: best hyp" in out


def test_cpu_training_repeats_itself():
    """Two CPU runs of one seed give bit-equal losses at four torch
    threads, as JAX's do: the step runs its convolutions without oneDNN,
    whose threaded convolutions gave 1.98, 17.93 or 7.48 for the second
    step from run to run."""
    cfg = load_config(tdet.DetConfig(), None, [
        "train.device=cpu", "model.image_size=64", "data.batch=4",
        "data.n_train=8", "model.num_classes=5", "train.steps=3",
        "train.lr=1e-3"])
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [[float(m["loss"]) for _, _, m in
                 tdet.train_steps(tdet.build(cfg))] for _ in range(2)]
    finally:
        torch.set_num_threads(n)
    assert runs[0] == runs[1] and len(runs[0]) == 3
    assert torch.backends.mkldnn.enabled       # restored after each step


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
    (["train.eval_tta=true"], "YOLOX family"),
])
def test_cli_later_items_raise(argv, item):
    with pytest.raises(ValueError, match=item):
        tdet.main(_BASE + argv)


def test_run_refuses_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.run(tdet.DetConfig())
