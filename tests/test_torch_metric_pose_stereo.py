"""Metric learning, pose and stereo in the port vs the JAX package, on the
CPU: the triplet / ArcFace / wnfc / heatmap losses, retrieval (CMC, mAP,
re-ranking), keypoint decoding, OKS / PCK / OKS-AP and heatmap targets,
the pose crops, ``batch_drop_block`` at a given position, BDB and ArcFace,
HRNet's keypoint head, MADNet with its warp, correlation and photometric
loss, ``MADSampler``'s picks over a loss sequence, and every new
factory's variable tree.

Weights are seeded flax trees (``seeded_tree``, nonzero BatchNorm scales)
converted with ``utils/convert``; float32 on both sides (JAX matmuls at
the highest precision). Tolerances: model outputs and losses 1e-4 (1e-5
for the losses on given inputs), decoded keypoints exact, numpy copies
exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.data import keypoint_transforms as jkt
from deeplearning_tpu.evaluation import keypoints as jkp
from deeplearning_tpu.evaluation import retrieval as jret
from deeplearning_tpu.models.metric import bdb as jbdb
from deeplearning_tpu.models.stereo import madnet as jmad
from deeplearning_tpu.ops import losses as jlosses
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.data import keypoint_transforms as tkt
from deeplearning_tpu_torch.evaluation import keypoints as tkp
from deeplearning_tpu_torch.evaluation import retrieval as tret
from deeplearning_tpu_torch.models.metric import bdb as tbdb
from deeplearning_tpu_torch.models.stereo import madnet as tmad
from deeplearning_tpu_torch.ops import losses as tlosses
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from test_torch_seg_ssl import _images, _np, _pair, _t, tree_matches
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- losses
def test_triplet_arcface_wnfc_match_jax():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(7, 6)).astype(np.float32)
    emb[3] = 0.0                            # a zero embedding: finite
    labels = np.array([0, 1, 0, 2, 1, 3, 0])   # id 2 and 3 lone: no pos
    centers = rng.normal(size=(6, 4)).astype(np.float32)
    for margin in (0.3, 5.0):
        want, wg = jax.value_and_grad(jlosses.triplet_loss)(
            jnp.asarray(emb), jnp.asarray(labels), margin)
        e = _t(emb).requires_grad_()
        got = tlosses.triplet_loss(e, _t(labels), margin)
        got.backward()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(_np(e.grad), np.asarray(wg), atol=1e-5)
    want = jlosses.arcface_logits(jnp.asarray(emb), jnp.asarray(centers),
                                  jnp.asarray(labels % 4))
    np.testing.assert_allclose(
        _np(tlosses.arcface_logits(_t(emb), _t(centers), _t(labels % 4))),
        np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        _np(tlosses.wnfc_logits(_t(emb), _t(centers))),
        np.asarray(jlosses.wnfc_logits(jnp.asarray(emb),
                                       jnp.asarray(centers))), atol=1e-5)
    pred = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    target = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    vis = np.array([[0, 1, 2], [1, 0, 0]], np.float32)
    np.testing.assert_allclose(
        _np(tlosses.heatmap_mse_loss(_t(pred), _t(target), _t(vis))),
        np.asarray(jlosses.heatmap_mse_loss(jnp.asarray(pred),
                                            jnp.asarray(target),
                                            jnp.asarray(vis))), rtol=1e-5)


# ------------------------------------------------------------- retrieval
def test_retrieval_is_the_jax_numpy():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 5)).astype(np.float32)
    g = rng.normal(size=(9, 5)).astype(np.float32)
    g[4] = g[2]                              # tied distances
    qi, gi = np.array([0, 1, 2, 0, 1, 3]), rng.integers(0, 3, 9)
    qc, gc = rng.integers(0, 2, 6), rng.integers(0, 2, 9)
    for metric in ("euclidean", "cosine"):
        np.testing.assert_array_equal(tret.pairwise_distances(q, g, metric),
                                      jret.pairwise_distances(q, g, metric))
    d = jret.pairwise_distances(q, g)
    for cams in ((None, None), (qc, gc)):
        a, b = tret.cmc_map(d, qi, gi, *cams, topk=5), \
            jret.cmc_map(d, qi, gi, *cams, topk=5)
        np.testing.assert_array_equal(a["cmc"], b["cmc"])
        assert (a["rank1"], a["mAP"]) == (b["rank1"], b["mAP"])
    np.testing.assert_array_equal(tret.k_reciprocal_rerank(q, g, 4, 3),
                                  jret.k_reciprocal_rerank(q, g, 4, 3))


# -------------------------------------------------------------- keypoints
def test_keypoint_decoding_and_scores_match_jax():
    rng = np.random.default_rng(2)
    heat = rng.normal(size=(3, 8, 6, 5)).astype(np.float32)
    heat[0, 3, 2, 0] = heat[0, 5, 4, 0] = 9.0     # a tie: the first
    heat[1, 0, 0, 1] = heat[1, 7, 5, 2] = 9.0     # peaks on the border
    want = jkp.decode_heatmaps(jnp.asarray(heat), stride=4)
    got = tkp.decode_heatmaps(_t(heat), stride=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    kps = rng.uniform(0, 30, (5, 2)).astype(np.float32)
    vis = np.array([1, 0, 2, 1, 1], np.float32)
    np.testing.assert_array_equal(
        tkp.make_heatmap_targets(kps, vis, (8, 6), stride=4),
        jkp.make_heatmap_targets(kps, vis, (8, 6), stride=4))
    pred = kps + rng.normal(size=kps.shape).astype(np.float32)
    assert tkp.oks(pred, kps, vis, 400.0) == jkp.oks(pred, kps, vis, 400.0)
    assert tkp.pck(pred, kps, vis, 1.5) == jkp.pck(pred, kps, vis, 1.5)
    preds = [{"keypoints": pred + i, "score": 1.0 - 0.1 * i}
             for i in range(4)]
    gts = [{"keypoints": kps, "visible": vis, "area": 300.0}] * 4
    assert tkp.oks_ap(preds, gts) == jkp.oks_ap(preds, gts)


def test_keypoint_transforms_are_the_jax_numpy():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 30, 3)).astype(np.float32)
    kps = rng.uniform(2, 28, (17, 2)).astype(np.float32)
    vis = (rng.uniform(size=17) > 0.2).astype(np.float32)
    box = (3.0, 4.0, 20.0, 30.0)
    for mod in (tkt, jkt):
        assert mod.COCO_FLIP_PAIRS == jkt.COCO_FLIP_PAIRS
    m = tkt.get_affine_matrix(box, (16, 12), 20.0)
    np.testing.assert_array_equal(m, jkt.get_affine_matrix(box, (16, 12),
                                                           20.0))
    np.testing.assert_array_equal(tkt.warp_affine(img, m, (16, 12)),
                                  jkt.warp_affine(img, m, (16, 12)))
    for a, b in zip(tkt.flip_keypoints_lr(kps, vis, 30),
                    jkt.flip_keypoints_lr(kps, vis, 30)):
        np.testing.assert_array_equal(a, b)
    tf = tkt.keypoint_train_transform((16, 12), seed=5)
    jf = jkt.keypoint_train_transform((16, 12), seed=5)
    for _ in range(3):
        a, b = tf(img, box, kps, vis), jf(img, box, kps, vis)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -------------------------------------------------------------- the models
@pytest.mark.parametrize("position", [(0, 0), (2, 1), (5, 3)])
def test_batch_drop_block_at_a_given_position(position):
    """JAX draws the position from its key; the port takes the same
    position and zeroes the same block."""
    x = _images(2, 8, 4, seed=4)
    rh, rw = max(int(round(8 * 0.33)), 1), 4
    y0, x0 = min(position[0], 8 - rh), min(position[1], 4 - rw)
    want = x.copy()
    want[:, y0:y0 + rh, x0:x0 + rw, :] = 0.0
    got = tbdb.batch_drop_block(_t(x), None, 0.33, 1.0, position=(y0, x0))
    np.testing.assert_array_equal(_np(got), want)
    # JAX's own draw: one whole block of rh rows, the same across the batch
    jout = np.asarray(jbdb.batch_drop_block(jnp.asarray(x),
                                            jax.random.key(position[0]),
                                            0.33, 1.0))
    rows = np.where((jout == 0).all(axis=(0, 2, 3)))[0]
    assert len(rows) == rh and rows[-1] - rows[0] == rh - 1
    tout = tbdb.batch_drop_block(_t(x), trng.step_key(0, position[0]),
                                 0.33, 1.0)
    rows = np.where((_np(tout) == 0).all(axis=(0, 2, 3)))[0]
    assert len(rows) == rh and rows[-1] - rows[0] == rh - 1
    with pytest.raises(ValueError, match="torch.Generator"):
        tbdb.batch_drop_block(_t(x), None, 0.33, 1.0)


def test_bdb_matches_jax_in_eval_and_train():
    """Every output in eval mode within 1e-4. In train mode (batch
    statistics, the part branch's block dropped at the position JAX drew)
    within 2e-2 of the largest value: flax's BatchNorm takes the batch
    variance in one pass, E[x²] − E[x]², whose float32 cancellation the
    16 train-mode blocks of ResNet-50 amplify (the port's two-pass
    variance: c5 already 5e-3 off JAX's at this size); the other block
    positions are off by ~4."""
    x = _images(4, 128, 64)
    jm, variables, tm = _pair("bdb_resnet50", (x,), dict(num_classes=5))
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    jwant, _ = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(7)}))(variables, jnp.asarray(x))
    # c5 is 4 x 2 at 128 x 64, the block one whole row
    tm.train()
    errs = []
    for y0 in range(4):
        with torch.no_grad():
            out = tm(_t(x), position=(y0, 0))
        errs.append(max(float(np.abs(_np(out[k]) - np.asarray(jwant[k])).max()
                              / np.abs(np.asarray(jwant[k])).max())
                        for k in jwant))
    assert sorted(errs)[0] <= 2e-2 and sorted(errs)[1] > 0.1, errs
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(_t(x))


def test_arcface_model_matches_jax():
    x = _images(3, 32)
    jm, variables, tm = _pair("arcface_resnet18", (x,), dict(num_classes=6))
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    for k in ("embedding", "centers"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL)


def test_hrnet_keypoints_match_jax():
    x = _images(2, 64, 48)
    jm, variables, tm = _pair("hrnet_w18_keypoints", (x,),
                              dict(num_classes=4, blocks_per_stage=1))
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    assert tuple(got.shape) == (2, 16, 12, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# -------------------------------------------------------------- stereo
def test_warp_correlation_photometric_match_jax():
    rng = np.random.default_rng(5)
    left = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    right = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    disp = rng.uniform(-2, 11, (2, 6, 9, 1)).astype(np.float32)  # out too
    disp[0, 0, :3, 0] = [0.0, 1.0, 3.0]                         # integers
    np.testing.assert_allclose(
        _np(tmad.warp_right_to_left(_t(right), _t(disp))),
        np.asarray(jmad.warp_right_to_left(jnp.asarray(right),
                                           jnp.asarray(disp))), atol=1e-6)
    np.testing.assert_allclose(
        _np(tmad.correlation_1d(_t(left), _t(right), 4)),
        np.asarray(jmad.correlation_1d(jnp.asarray(left),
                                       jnp.asarray(right), 4)), atol=1e-6)
    want, wg = jax.value_and_grad(jmad.photometric_loss, argnums=2)(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp))
    d = _t(disp).requires_grad_()
    got = tmad.photometric_loss(_t(left), _t(right), d)
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(d.grad), np.asarray(wg), atol=1e-6)


def test_madnet_matches_jax():
    left = _images(1, 64, seed=6)
    right = np.roll(left, -3, axis=2)
    jm = JMODELS.build("madnet", dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(left),
                            jnp.asarray(right))
    variables = seeded_tree(shapes)
    with torch.device("meta"):
        tm = TMODELS.build("madnet", dtype=torch.float32)
    tm.load_state_dict(from_flax_params(variables, like=tm), assign=True)
    want = jax.jit(jm.apply)(variables, jnp.asarray(left),
                             jnp.asarray(right))
    with torch.no_grad():
        got = tm.eval()(_t(left), _t(right))
    np.testing.assert_allclose(_np(got["disparity"]),
                               np.asarray(want["disparity"]), **TOL)
    for g, w in zip(got["pyramid"], want["pyramid"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    # flax's top-level order (its creation order, which list(params)
    # gives JAX's sampler; the online task's picks test it end to end)
    assert tm.block_names() == ["tower", "D6", "D5", "D4", "D3", "D2"]


@pytest.mark.parametrize("mode", ["probabilistic", "argmax", "random",
                                  "sequential", "full", "none"])
def test_mad_sampler_picks_as_jax_over_a_loss_sequence(mode):
    names = ["tower", "D6", "D5", "D4", "D3", "D2"]
    losses = [0.9, 0.7, 0.75, 0.5, 0.52, 0.4, 0.41, 0.3, 0.35, 0.2]
    a = tmad.MADSampler(names, sample_n=2, mode=mode, seed=3)
    b = jmad.MADSampler(names, sample_n=2, mode=mode, seed=3)
    for loss in losses:
        sa, sb = a.sample(), b.sample()
        assert sa == sb
        a.update(sa, loss)
        b.update(sb, loss)
    np.testing.assert_array_equal(a.scores, b.scores)
    params = {"tower.conv0a.weight": torch.zeros(1),
              "D6.c0.bias": torch.zeros(1), "D2.pred.weight": torch.zeros(1)}
    assert a.grad_mask(params, ["D6", "tower"]) == {
        "tower.conv0a.weight": 1.0, "D6.c0.bias": 1.0, "D2.pred.weight": 0.0}


# ---------------------------------------------------- every factory's tree
FACTORIES = [("bdb_resnet50", (384, 128)), ("arcface_resnet18", (112, 112)),
             ("hrnet_w18_keypoints", (256, 192)),
             ("hrnet_w48_keypoints", (256, 192)), ("madnet", (64, 64))]


@pytest.mark.parametrize("name,hw", FACTORIES, ids=[f[0] for f in FACTORIES])
def test_factory_tree_matches_jax(name, hw):
    x = jnp.zeros((1,) + hw + (3,))
    args = (x, x) if name == "madnet" else (x,)
    tree_matches(name, args, {})
