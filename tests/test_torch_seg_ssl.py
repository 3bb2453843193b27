"""Segmentation and self-supervised learning in the port vs the JAX package,
on the CPU: the resize helper (ops/resize.py) against ``jax.image.resize``,
the segmentation losses and metrics, U-Net, FCN / DeepLabV3 / V3+, HRNet's
segmentation head, SSPNet, MAE (its plain path, ``flash_hb``'s CPU
dispatch, and JAX's flash adapter in interpret mode), SupCon, SWA, LARS
against ``optax.lars``, and every new factory's variable tree.

Weights are seeded flax trees (``seeded_tree``: nonzero BatchNorm scales)
converted with ``utils/convert``; the port modules are built on the meta
device and take the converted tensors. float32 on both sides (JAX matmuls
at the highest precision, tests/conftest.py); the models at narrow,
shallow settings. Tolerances: logits and losses 1e-4, the resize helper
and the losses' inputs-to-outputs 1e-5, attention outputs 2e-5 (MAE's
predictions through each route against the other), LARS 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.evaluation import metrics as jmetrics
from deeplearning_tpu.models.segmentation import fewshot as jfewshot
from deeplearning_tpu.models.ssl import mae as jmae
from deeplearning_tpu.models.ssl import supcon as jsupcon
from deeplearning_tpu.ops import attention as jattention
from deeplearning_tpu.ops import losses as jlosses
from deeplearning_tpu.train import optim as joptim
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.evaluation import metrics as tmetrics
from deeplearning_tpu_torch.models.segmentation import fewshot as tfewshot
from deeplearning_tpu_torch.models.ssl import mae as tmae
from deeplearning_tpu_torch.models.ssl import supcon as tsupcon
from deeplearning_tpu_torch.ops import attention as tattention
from deeplearning_tpu_torch.ops import losses as tlosses
from deeplearning_tpu_torch.ops.resize import resize
from deeplearning_tpu_torch.train import optim as toptim
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(n, h, w=None, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, h, w or h, 3)).astype(np.float32)


def _pair(name, args, kw, port_kw=None, rngs=None):
    """(flax module, seeded numpy variables, the port module loaded with
    them, in eval mode)."""
    jm = JMODELS.build(name, dtype=jnp.float32, **kw)
    key = rngs or jax.random.key(0)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), key,
                            *[jnp.asarray(a) for a in args])
    variables = seeded_tree(shapes)
    with torch.device("meta"):
        tm = TMODELS.build(name, dtype=torch.float32, **kw,
                           **(port_kw or {}))
    tm.load_state_dict(from_flax_params(variables, like=tm), assign=True)
    return jm, variables, tm.eval()


# ----------------------------------------------------------- the resize
@pytest.mark.parametrize("src,dst", [((7, 5), (16, 9)), ((16, 9), (7, 5)),
                                     ((13, 17), (13, 4)), ((5, 5), (31, 2)),
                                     ((12, 20), (5, 7))])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_matches_jax_at_odd_ratios(src, dst, method):
    x = np.random.default_rng(0).normal(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), method)
    got = resize(_t(x), (2,) + dst + (3,), method)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if method == "nearest":      # exactly the same picks, any dtype
        ints = np.arange(np.prod(src)).reshape((1,) + src).astype(np.int32)
        np.testing.assert_array_equal(
            _np(resize(_t(ints), (1,) + dst, "nearest")),
            np.asarray(jax.image.resize(jnp.asarray(ints), (1,) + dst,
                                        "nearest")))


def test_nearest_is_not_torch_interpolate():
    """At 5 → 3 the half-pixel centres pick 0, 2, 4 where
    ``F.interpolate(mode="nearest")`` picks 0, 1, 3."""
    x = torch.arange(5.0).reshape(1, 1, 1, 5)
    assert resize(x, (1, 1, 1, 3), "nearest").flatten().tolist() == \
        [0.0, 2.0, 4.0]
    assert torch.nn.functional.interpolate(
        x, size=(1, 3), mode="nearest").flatten().tolist() == [0.0, 1.0, 3.0]


# ------------------------------------------------ losses and metrics
def _seg_case(seed=0, b=2, h=6, w=5, c=4, ignore=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, c)).astype(np.float32)
    labels = rng.integers(0, c, (b, h, w)).astype(np.int32)
    if ignore:
        labels[0, :2, :2] = -1
    return logits, labels


def test_dice_losses_match_jax():
    logits, labels = _seg_case()
    np.testing.assert_allclose(
        _np(tlosses.dice_loss(_t(logits), _t(labels))),
        np.asarray(jlosses.dice_loss(jnp.asarray(logits),
                                     jnp.asarray(labels))), rtol=1e-5)
    probs = np.random.default_rng(3).uniform(size=(2, 3, 6, 5)).astype(
        np.float32)
    onehot = (probs > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlosses.dice_coefficient(_t(probs), _t(onehot))),
        np.asarray(jlosses.dice_coefficient(jnp.asarray(probs),
                                            jnp.asarray(onehot))), rtol=1e-5)
    got = tmetrics.dice_counts(_t(probs), _t(onehot))
    want = jmetrics.dice_counts(jnp.asarray(probs), jnp.asarray(onehot))
    np.testing.assert_allclose([_np(g) for g in got],
                               [np.asarray(w) for w in want], rtol=1e-5)


@pytest.mark.parametrize("thresh,min_kept", [(0.7, 100000), (0.7, 3),
                                             (0.05, 5), (0.9, 1)])
def test_ohem_cross_entropy_matches_jax(thresh, min_kept):
    logits, labels = _seg_case(seed=1)
    logits[1, 0, :3] = 0.0              # tied probabilities at the cut
    want = jlosses.ohem_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), thresh, min_kept)
    got = tlosses.ohem_cross_entropy(_t(logits), _t(labels), thresh,
                                     min_kept)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)


def test_supcon_loss_matches_jax_with_gradient():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(6, 2, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = np.array([0, 1, 0, 2, 1, 3])
    want, wgrad = jax.value_and_grad(jlosses.supcon_loss)(
        jnp.asarray(f), jnp.asarray(labels))
    ft = _t(f).requires_grad_()
    got = tlosses.supcon_loss(ft, _t(labels))
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(ft.grad), np.asarray(wgrad), atol=1e-5)


def test_confusion_matrix_and_miou_match_jax():
    rng = np.random.default_rng(4)
    preds = rng.integers(0, 5, (3, 7, 6))
    labels = rng.integers(-1, 6, (3, 7, 6))     # -1 and 5 ignored
    want = np.asarray(jmetrics.confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), 5))
    got = tmetrics.confusion_matrix(_t(preds), _t(labels), 5)
    np.testing.assert_array_equal(_np(got), want)
    a, b = tmetrics.miou_from_confusion(got), \
        jmetrics.miou_from_confusion(want)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12)


# ------------------------------------------------------------ the models
def _seg_logits(name, kw, size=64, train_shapes=True):
    x = _images(2, size)
    jm, variables, tm = _pair(name, (x,), kw)
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                               err_msg=name)
    return tm, x


@pytest.mark.parametrize("bilinear", [True, False])
def test_unet_matches_jax(bilinear):
    _seg_logits("unet", dict(num_classes=3, base_features=8,
                             bilinear=bilinear), size=48)


@pytest.mark.parametrize("name", ["fcn_resnet50", "deeplabv3_resnet50",
                                  "deeplabv3plus_resnet50"])
def test_fcn_deeplab_match_jax(name):
    """Eval logits of a shallow ResNet-50 (one block a stage) under each
    head at 56² (an odd grid: c5 is 2×2, c2 14×14); in train mode the
    model returns (logits, aux logits), both at the input size."""
    tm, x = _seg_logits(name, dict(num_classes=3,
                                   backbone_sizes=(1, 1, 1, 1)), size=56)
    tm.train()
    out = tm(_t(x), rng=trng.step_key(0, 0))
    assert isinstance(out, tuple) and [tuple(o.shape) for o in out] == \
        [(2, 56, 56, 3)] * 2
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(_t(x))


def test_hrnet_seg_matches_jax():
    _seg_logits("hrnet_w18_seg", dict(num_classes=3, blocks_per_stage=1),
                size=64)


def test_sspnet_matches_jax_and_its_helpers():
    rng = np.random.default_rng(5)
    sup = rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 2, 64, 64)) > 0.5).astype(np.float32)
    query = _images(2, 64)
    kw = dict(backbone_sizes=(1, 1, 1, 1))
    jm, variables, tm = _pair("sspnet_resnet18", (sup, mask, query), kw)
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(sup), jnp.asarray(mask), jnp.asarray(query))
    with torch.no_grad():
        got = tm(_t(sup), _t(mask), _t(query))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    feats = rng.normal(size=(2, 5, 4, 6)).astype(np.float32)
    feats[0, 0, 0] = 0.0                 # a zero feature: finite
    m = (rng.uniform(size=(2, 5, 4)) > 0.4).astype(np.float32)
    proto = rng.normal(size=(2, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tfewshot.masked_average_pool(_t(feats), _t(m))),
        np.asarray(jfewshot.masked_average_pool(jnp.asarray(feats),
                                                jnp.asarray(m))), atol=1e-6)
    np.testing.assert_allclose(
        _np(tfewshot.cosine_similarity_map(_t(feats), _t(proto))),
        np.asarray(jfewshot.cosine_similarity_map(jnp.asarray(feats),
                                                  jnp.asarray(proto))),
        atol=1e-6)


# ------------------------------------------------------------------ MAE
MAE_KW = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4,
              decoder_dim=64, decoder_depth=2, decoder_heads=2)


def _mae_case(size=32, seed=6, b=2):
    x = _images(b, size, seed=seed)
    n = (size // MAE_KW["patch_size"]) ** 2
    noise = np.random.default_rng(seed + 1).uniform(size=(b, n)).astype(
        np.float32)
    return x, noise


def _mae_pair(size=32, attn=None):
    x, noise = _mae_case(size)
    jm, variables, tm = _pair(
        "mae_vit_small_patch16", (x,), MAE_KW,
        port_kw=dict(img_size=size), rngs={"params": jax.random.key(0),
                                           "masking": jax.random.key(1)})
    return jm, variables, tm, x, noise


def test_mae_helpers_match_jax():
    x, noise = _mae_case()
    tok = np.random.default_rng(0).normal(size=(2, 16, 5)).astype(np.float32)
    got = tmae.random_masking(_t(tok), 0.75, noise=_t(noise))
    want = jmae.random_masking(jnp.asarray(tok), 0.75, None,
                               noise=jnp.asarray(noise))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    p = jmae.patchify(jnp.asarray(x), 8)
    np.testing.assert_array_equal(_np(tmae.patchify(_t(x), 8)),
                                  np.asarray(p))
    np.testing.assert_array_equal(
        _np(tmae.unpatchify(tmae.patchify(_t(x), 8), 8, 32, 32)), x)
    with pytest.raises(ValueError, match="rng"):
        tmae.random_masking(_t(tok), 0.75)


def test_mae_matches_jax_plain_and_through_flash_hb_dispatch():
    """Loss, predictions and mask on the naive path and on ``flash_hb``'s
    CPU dispatch (the plain version behind K1's wrapper) against JAX's;
    the two port routes' predictions within 2e-5 and their gradients
    within 1e-5 of each other; ``norm_pix_loss`` takes the population
    variance."""
    jm, variables, tm, x, noise = _mae_pair()
    want = jax.jit(lambda v, a, n: jm.apply(v, a, train=True,
                                            mask_noise=n))(
        variables, jnp.asarray(x), jnp.asarray(noise))
    with torch.device("meta"):
        tflash = TMODELS.build("mae_vit_small_patch16", dtype=torch.float32,
                               img_size=32, **MAE_KW,
                               attn_fn=tattention.flash_hb_adapter)
    tflash.load_state_dict(from_flax_params(variables, like=tflash),
                           assign=True)
    outs, grads = [], []
    for model in (tm.train(), tflash.train()):
        loss, pred, mask = model(_t(x), mask_noise=_t(noise))
        for g, w in zip((loss, pred, mask), want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        model.zero_grad()
        loss.backward()
        outs.append(_np(pred))
        grads.append({n: _np(p.grad) for n, p in model.named_parameters()})
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-5)
    for n in grads[0]:
        np.testing.assert_allclose(grads[1][n], grads[0][n], atol=1e-5,
                                   err_msg=n)
    # the JAX gradient too, for the loss
    jgrad = jax.jit(jax.grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(x), train=True,
        mask_noise=jnp.asarray(noise))[0]))(variables["params"])
    want_g = from_flax_params({"params": jgrad}, like=tm)
    for n in grads[0]:
        np.testing.assert_allclose(grads[0][n], want_g[n].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_mae_against_jax_flash_in_interpret_mode():
    """One small case: JAX's MAE with its ``flash_hb`` adapter (the
    Pallas kernels in interpret mode on the CPU) against the port's
    ``flash_hb`` route."""
    x, noise = _mae_case(size=16, b=1)
    kw = dict(MAE_KW, depth=1, decoder_depth=1)
    jm = JMODELS.build("mae_vit_small_patch16", dtype=jnp.float32,
                       attn_fn=jattention.flash_hb_adapter, **kw)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            {"params": jax.random.key(0),
                             "masking": jax.random.key(1)}, jnp.asarray(x))
    variables = seeded_tree(shapes)
    with torch.device("meta"):
        tm = TMODELS.build("mae_vit_small_patch16", dtype=torch.float32,
                           img_size=16, attn_fn=tattention.flash_hb_adapter,
                           **kw)
    tm.load_state_dict(from_flax_params(variables, like=tm), assign=True)
    want = jm.apply(variables, jnp.asarray(x), train=False,
                    mask_noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tm.eval()(_t(x), mask_noise=_t(noise))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=2e-5)


def test_mae_reconstruct_matches_jax():
    """JAX's ``reconstruct`` draws its mask as ``uniform(rng, (B, N))``;
    the port's takes that noise."""
    jm, variables, tm, x, noise = _mae_pair()
    key = jax.random.key(3)
    want = jm.reconstruct(variables, jnp.asarray(x), key)
    got = tm.train().reconstruct(_t(x), mask_noise=_t(np.asarray(
        jax.random.uniform(key, noise.shape))))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert tm.training             # put back as it was


def test_mae_factories_and_attention_option():
    kw = hub.model_kwargs("mae_vit_base_patch16", "flash_hb", 224)
    assert kw == {"img_size": 224,
                  "attn_fn": tattention.flash_hb_adapter}
    assert hub.model_kwargs("mae_vit_small_patch16", "naive") == \
        {"attn_fn": None}
    with torch.device("meta"):
        base = TMODELS.build("mae_vit_base_patch16")
    assert base.enc_pos.shape == (1, 196, 768)
    assert base.enc_block0.attn.num_heads == 12
    assert base.dec_block7.attn.num_heads == 16
    assert base.mask_token.shape == (1, 1, 512)


# --------------------------------------------------------------- SupCon
def test_supcon_model_matches_jax_in_every_mode():
    x = _images(3, 32)
    jm, variables, tm = _pair("supcon_resnet18", (x,), dict(num_classes=5))
    for mode in ("projection", "features", "classify"):
        want = jax.jit(functools.partial(jm.apply, train=False, mode=mode))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = tm(_t(x), mode=mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                   err_msg=mode)
    with torch.device("meta"):
        plain = TMODELS.build("supcon_resnet50")
    with pytest.raises(ValueError, match="num_classes"):
        plain(torch.zeros(1, 32, 32, 3, device="meta"), mode="classify")


def test_swa_update_matches_jax():
    rng = np.random.default_rng(7)
    steps = [{"a": rng.normal(size=(3, 2)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
             for _ in range(3)]
    jswa = tswa = None
    n_j = n_t = 0
    for p in steps:
        jswa, n_j = jsupcon.swa_update(jswa, p, n_j)
        tswa, n_t = tsupcon.swa_update(tswa, {k: _t(v) for k, v in p.items()},
                                       n_t)
    assert n_j == n_t == 3
    for k in jswa:
        np.testing.assert_allclose(_np(tswa[k]), np.asarray(jswa[k]),
                                   rtol=1e-6)


# ----------------------------------------------------------------- LARS
def test_lars_matches_optax_over_three_steps():
    """``build_optimizer("lars", ...)`` against JAX's (``optax.lars`` with
    ``decay_mask``) on a tree with kernels, biases, a norm scale and a
    position table, weight decay 0.05, momentum 0.9: three steps."""
    rng = np.random.default_rng(8)
    flax_params = {
        "dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)},
        "norm": {"scale": (1 + rng.normal(size=(3,))).astype(np.float32)},
        "enc_pos": rng.normal(size=(1, 4, 3)).astype(np.float32),
        "zero": {"kernel": np.zeros((2, 2), np.float32)}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), flax_params) for _ in range(3)]
    jtx = joptim.build_optimizer("lars", 0.1, params=flax_params,
                                 weight_decay=0.05)
    jp, js = jax.tree.map(jnp.asarray, flax_params), None
    js = jtx.init(jp)
    tp = from_flax_params(flax_params)
    ttx = toptim.build_optimizer("lars", 0.1, params=tp, weight_decay=0.05)
    ts = ttx.init(tp)
    for g in grads:
        up, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        tup, ts = ttx.update(from_flax_params(g), ts, tp)
        toptim.apply_updates(tp, tup)
    want = from_flax_params(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(_np(tp[k]), want[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert not toptim.decay_mask(tp)["dense.bias"]
    assert toptim.decay_mask(tp)["enc_pos"]


# ------------------------------------------------- every factory's tree
FACTORIES = [
    ("unet", (64,), {}), ("fcn_resnet50", (64,), {}),
    ("deeplabv3_resnet50", (64,), {}), ("deeplabv3plus_resnet50", (64,), {}),
    ("hrnet_w18_seg", (64,), {}), ("hrnet_w48_seg", (64,), {}),
    ("sspnet_resnet18", None, {}),
    ("mae_vit_base_patch16", (224,), {"img_size": 224}),
    ("mae_vit_small_patch16", (224,), {"img_size": 224}),
    ("supcon_resnet18", (32,), {}), ("supcon_resnet50", (32,), {}),
]


def tree_matches(name, args, port_kw, rngs=None):
    """The port's parameters and BatchNorm statistics, name for name and
    shape for shape, are the converted flax tree's (``jax.eval_shape``:
    no JAX compute)."""
    jm = JMODELS.build(name)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            rngs or jax.random.key(0), *args)
    with torch.device("meta"):
        tm = TMODELS.build(name, **port_kw)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = from_flax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes), like=tm)
    assert {k: tuple(v.shape) for k, v in got.items()} == want, name


@pytest.mark.parametrize("name,size,port_kw", FACTORIES,
                         ids=[f[0] for f in FACTORIES])
def test_factory_tree_matches_jax(name, size, port_kw):
    if name == "sspnet_resnet18":
        args = (jnp.zeros((1, 1, 64, 64, 3)), jnp.zeros((1, 1, 64, 64)),
                jnp.zeros((1, 64, 64, 3)))
    else:
        args = (jnp.zeros((1,) + size * 2 + (3,)),)
    rngs = ({"params": jax.random.key(0), "masking": jax.random.key(1)}
            if name.startswith("mae") else None)
    tree_matches(name, args, port_kw, rngs)


def test_registry_lacks_only_the_zoo_extra_families():
    """The zoo_extra families (models/classification/zoo_extra.py) are in
    the port now too, so its registry holds every one of JAX's names."""
    assert sorted(set(JMODELS.keys()) - set(TMODELS.keys())) == []
    assert len(JMODELS.keys()) == 100
    assert set(TMODELS.keys()) == set(JMODELS.keys())
