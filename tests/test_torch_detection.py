"""The detection slice's building blocks in the port vs the JAX package,
on the CPU: the ResNet backbones and their attention blocks, the FPN, the
anchors and grids, RoIAlign, the stable top-k, and every new factory's
parameter tree.

Weights are seeded flax trees converted with ``utils/convert`` (kernels
N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1²), biases and means
N(0, 0.1²), variances U(0.5, 1.5)): the BatchNorm scales are nonzero, so
the zero-initialised residual branches of a fresh ResNet cannot hide a
wrong 3×3 conv. float32 on both sides; tests/conftest.py sets JAX matmuls
to the highest precision.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.classification import resnet as jresnet
from deeplearning_tpu.models.detection import faster_rcnn as jfrcnn
from deeplearning_tpu.models.detection import fcos as jfcos
from deeplearning_tpu.models.detection import fpn as jfpn
from deeplearning_tpu.models.detection import retinanet as jretina
from deeplearning_tpu.models.detection import yolov5 as jyolov5
from deeplearning_tpu.ops import anchors as janchors
from deeplearning_tpu.ops import roi_align as jroi
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.classification import resnet as tresnet
from deeplearning_tpu_torch.models.detection import faster_rcnn as tfrcnn
from deeplearning_tpu_torch.models.detection import fcos as tfcos
from deeplearning_tpu_torch.models.detection import fpn as tfpn
from deeplearning_tpu_torch.models.detection import retinanet as tretina
from deeplearning_tpu_torch.models.detection import yolov5 as tyolov5
from deeplearning_tpu_torch.ops import anchors as tanchors
from deeplearning_tpu_torch.ops import roi_align as troi
from deeplearning_tpu_torch.ops.padding import conv_padding, torch_pad
from deeplearning_tpu_torch.ops.topk import topk_stable
from deeplearning_tpu_torch.utils import convert

TOL = dict(atol=1e-4, rtol=1e-4)


def seeded_tree(shapes, seed=0):
    """A flax variable tree of numpy arrays over ``shapes`` (an
    ``eval_shape`` result): kernels N(0, 1/fan_in), biases N(0, 0.1²),
    scales 1 + N(0, 0.1²), means N(0, 0.1²), variances U(0.5, 1.5)."""
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


def _images(n, size, seed=1, channels=3):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, channels)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ------------------------------------------------------------ ResNet
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_features_match_jax(name):
    """c2..c5 of the backbone (return_features), 64², two images."""
    jmodel = JMODELS.build(name, dtype=jnp.float32, return_features=True)
    x = _images(2, 64)
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, 64, 64, 3))))
    want = jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(x))
    model = TMODELS.build(name, dtype=torch.float32, return_features=True)
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert list(got) == ["c2", "c3", "c4", "c5"]
    for key, value in got.items():
        np.testing.assert_allclose(value.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("name", ["resnet18", "se_resnet18"])
def test_resnet_classifier_logits_match_jax(name):
    jmodel = JMODELS.build(name, num_classes=10, dtype=jnp.float32)
    x = _images(2, 64, seed=2)
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, 64, 64, 3))), seed=3)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(x))
    model = TMODELS.build(name, num_classes=10, dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(variables, like=model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attention,groups", [("se", 1), ("sk", 1),
                                              ("splat", 1), (None, 4)])
def test_bottleneck_attention_blocks_match_jax(attention, groups):
    """One stride-2 Bottleneck with a downsample branch: SE, SK, ResNeSt
    split attention, and a grouped (ResNeXt) 3×3."""
    norm = functools.partial(fnn.BatchNorm, use_running_average=True,
                             momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    wpg = 64 if groups == 1 else 16                # width 32 either way
    jblock = jresnet.Bottleneck(features=32, stride=2, groups=groups,
                                width_per_group=wpg,
                                norm=norm, attention=attention,
                                dtype=jnp.float32)
    x = _images(2, 9, seed=4, channels=48)
    variables = seeded_tree(jax.eval_shape(
        jblock.init, jax.random.key(0), jnp.zeros((1, 9, 9, 48))), seed=5)
    want = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x)))
    block = tresnet.Bottleneck(48, 32, 2, groups, wpg,
                               tresnet.norm_layer(torch.float32), attention,
                               torch.float32)
    block.load_state_dict(convert.from_flax_params(variables, like=block))
    with torch.no_grad():
        got = block.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5, 5, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_padding_is_torch_symmetric():
    assert torch_pad(3) == [(1, 1), (1, 1)] and torch_pad(3, 2) == [
        (2, 2), (2, 2)]
    assert [conv_padding(k) for k in (1, 3, 7)] == [0, 1, 3]


# -------------------------------------------------------------- FPN
@pytest.mark.parametrize("extra", ["pool", "p6p7"])
def test_fpn_matches_jax_at_odd_levels(extra):
    """72² through a ResNet gives c2..c5 of 18, 9, 5, 3: the top-down
    resizes 3 → 5 and 5 → 9 are not 2×, and the extra levels halve odd
    sizes."""
    sizes = {"c2": 18, "c3": 9, "c4": 5, "c5": 3}
    chans = {"c2": 8, "c3": 16, "c4": 24, "c5": 32}
    if extra == "p6p7":
        sizes.pop("c2")
        chans.pop("c2")
    rng = np.random.default_rng(6)
    feats = {k: rng.normal(size=(2, s, s, chans[k])).astype(np.float32)
             for k, s in sizes.items()}
    jfp = jfpn.FPN(16, extra_levels=extra, dtype=jnp.float32)
    variables = seeded_tree(jax.eval_shape(
        jfp.init, jax.random.key(0),
        {k: jnp.zeros(v.shape) for k, v in feats.items()}), seed=7)
    want = jax.jit(jfp.apply)(variables, {k: jnp.asarray(v)
                                          for k, v in feats.items()})
    fpn = tfpn.FPN(chans, 16, extra, torch.float32)
    fpn.load_state_dict(convert.from_flax_params(variables, like=fpn))
    with torch.no_grad():
        got = fpn({k: _nchw(v) for k, v in feats.items()})
    assert list(got) == sorted(want, key=lambda k: int(k[1:]))
    for key, value in got.items():
        np.testing.assert_allclose(value.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("src,dst", [(38, 75), (3, 5), (5, 9), (13, 25),
                                     (19, 38), (25, 50)])
def test_upsample_nearest_is_jax_resize(src, dst):
    x = np.random.default_rng(src).normal(size=(1, src, src + 1, 2)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, dst, dst + 2, 2), "nearest")
    got = tfpn.upsample_nearest(_nchw(x), (dst, dst + 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


# ------------------------------------------------- anchors and grids
ANCHOR_SIZES = [(64, 64), (72, 100), (800, 800)]


@pytest.mark.parametrize("hw", ANCHOR_SIZES)
@pytest.mark.parametrize("which", ["retinanet", "fasterrcnn", "fcos",
                                   "yolov5"])
def test_anchors_and_grids_are_bit_equal(which, hw):
    if which == "retinanet":
        pairs = [(jretina.retinanet_anchors(hw),
                  tretina.retinanet_anchors(hw))]
    elif which == "fasterrcnn":
        pairs = [(jfrcnn.fasterrcnn_anchors(hw),
                  tfrcnn.fasterrcnn_anchors(hw))]
    elif which == "fcos":
        pairs = list(zip(jfcos.fcos_locations(hw),
                         tfcos.fcos_locations(hw)))
    else:
        want, got = jyolov5.yolov5_grid(hw), tyolov5.yolov5_grid(hw)
        assert list(want) == list(got)
        pairs = [(want[k], got[k]) for k in want]
    for want, got in pairs:
        assert want.dtype == got.dtype and want.shape == got.shape
        np.testing.assert_array_equal(got, want)


def test_pyramid_anchor_helpers_are_bit_equal():
    shapes = {"p3": (5, 7), "p4": (3, 4)}
    strides = {"p3": 8, "p4": 16}
    sizes = janchors.retinanet_sizes((3, 4))
    assert sizes == tanchors.retinanet_sizes((3, 4))
    for ratios in ((0.5, 1.0, 2.0), (1.0,)):
        w, wc = janchors.pyramid_anchors(shapes, strides, sizes, ratios)
        g, gc = tanchors.pyramid_anchors(shapes, strides, sizes, ratios)
        assert wc == gc
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tanchors.base_anchors((32, 64), (0.5, 2)),
                                  janchors.base_anchors((32, 64), (0.5, 2)))
    # the Faster R-CNN RPN's candidates at 800²: 1 000 of each level, p6's
    # 507 (13 × 13 × 3) whole
    counts = tanchors.pyramid_anchors(
        {f"p{l}": (-(-800 // 2 ** l),) * 2 for l in range(2, 7)},
        {f"p{l}": 2 ** l for l in range(2, 7)},
        {f"p{l}": (2 ** (l + 3),) for l in range(2, 7)})[1]
    assert sum(min(c, 1000) for c in counts) == 4507


# ------------------------------------------------------------ RoIAlign
def _rois(rng, n, size):
    """Random RoIs plus RoIs across the image border, of zero area, and
    tiny."""
    xy = rng.uniform(-4, size, (n, 2))
    wh = rng.uniform(0, size / 2, (n, 2))
    rois = np.concatenate([xy, xy + wh], 1)
    extra = np.array([[-8, -8, 6, 6], [size - 3, size - 3, size + 9,
                                       size + 9], [10, 10, 10, 10],
                      [0, 0, 0, 0], [5, 7, 5.25, 7.5],
                      [0, 0, size, size]], np.float64)
    return np.concatenate([rois, extra]).astype(np.float32)


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_matches_jax(aligned):
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(13, 17, 5)).astype(np.float32)
    rois = _rois(rng, 20, 64)
    want = jroi.roi_align(jnp.asarray(feats), jnp.asarray(rois), 7,
                          spatial_scale=0.25, sampling_ratio=2,
                          aligned=aligned)
    got = troi.roi_align(torch.from_numpy(feats), torch.from_numpy(rois), 7,
                         spatial_scale=0.25, sampling_ratio=2,
                         aligned=aligned)
    assert got.shape == (26, 7, 7, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["onepass", "masked"])
def test_multiscale_roi_align_matches_jax(impl):
    """p2..p5 of a 100² image (25, 13, 7, 4): RoIs of every level, across
    the border and of zero area."""
    rng = np.random.default_rng(9)
    pyr = {f"p{l}": rng.normal(size=(-(-100 // 2 ** l),) * 2 + (6,)).astype(
        np.float32) for l in (2, 3, 4, 5)}
    # canonical levels: sqrt(area) < 112 → p2, < 224 → p3, < 448 → p4
    rois = np.concatenate([_rois(rng, 30, 100), np.array(
        [[0, 0, 90, 95], [3, 4, 150, 160], [-20, 10, 90, 140],
         [1, 1, 300, 250], [-50, -60, 400, 380], [0, 0, 500, 480]],
        np.float32)])
    want = jroi.multiscale_roi_align({k: jnp.asarray(v) for k, v in
                                      pyr.items()}, jnp.asarray(rois),
                                     impl=impl)
    tpyr = {k: torch.from_numpy(v) for k, v in pyr.items()}
    got = troi.multiscale_roi_align(tpyr, torch.from_numpy(rois), impl=impl)
    levels = troi.assign_levels(sorted(pyr), torch.from_numpy(rois))
    assert len(set(levels.tolist())) == 4            # every level is used
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    other = troi.multiscale_roi_align(
        tpyr, torch.from_numpy(rois),
        impl="masked" if impl == "onepass" else "onepass")
    np.testing.assert_allclose(got.numpy(), other.numpy(), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="onepass"):
        troi.multiscale_roi_align(tpyr, torch.from_numpy(rois), impl="x")


def test_roi_align_promotes_bf16_features_to_float32():
    rng = np.random.default_rng(10)
    pyr = {f"p{l}": torch.from_numpy(rng.normal(
        size=(-(-64 // 2 ** l),) * 2 + (4,)).astype(np.float32)).to(
        torch.bfloat16) for l in (2, 3, 4, 5)}
    rois = torch.from_numpy(_rois(rng, 8, 64))
    got = troi.multiscale_roi_align(pyr, rois)
    assert got.dtype == torch.float32
    want = troi.multiscale_roi_align({k: v.float() for k, v in pyr.items()},
                                     rois)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------- stable top-k
@pytest.mark.parametrize("k", [1, 7, 300, 1000])
def test_topk_stable_keeps_jax_tie_order(k):
    """bf16-rounded scores: hundreds of exact ties, which ``lax.top_k``
    orders by index."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(3, 1000)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    x[1, ::3] = 0.5                                  # a block of equal values
    assert len(np.unique(x[0])) < 1000 - 100
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------ parameter trees
TREE_CASES = [
    ("resnet18", {}), ("resnet50", {}), ("resnext50_32x4d", {}),
    ("se_resnet50", {}), ("sknet50", {}), ("resnest50", {}),
    ("retinanet_resnet50_fpn", {}), ("fcos_resnet50_fpn", {}),
    ("fasterrcnn_resnet50_fpn", {}), ("yolov5s", {}), ("yolov5m", {}),
    ("yolov5_from_spec", {}),
]


def _flax_shapes(tree):
    """``{"collection/path": shape}`` of a flax variable tree."""
    return {"/".join([coll] + [str(p.key) for p in path]): tuple(leaf.shape)
            for coll in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree[coll])[0]}


def _jax_tree_shapes(name, num_classes=7, **kw):
    jmodel = JMODELS.build(name, num_classes=num_classes, **kw)
    return _flax_shapes(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, 64, 64, 3))))


@pytest.mark.parametrize("name,kw", TREE_CASES)
def test_state_dict_is_the_flax_tree(name, kw):
    """Names and shapes of every parameter and BatchNorm statistic against
    the flax tree (the port model built on the meta device: no weights are
    drawn)."""
    want = {k.split("/", 1)[1]: v
            for k, v in _jax_tree_shapes(name, **kw).items()}
    with torch.device("meta"):
        model = TMODELS.build(name, num_classes=7, **kw)
    got = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        shape = tuple(t.shape)
        if len(shape) == 4:                               # OIHW -> HWIO
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif len(shape) == 2:                             # (out, in) -> (in, out)
            shape = shape[::-1]
        got[convert.flax_path(key, t.dim())] = shape
    assert got == want


@pytest.mark.parametrize("name", ["fasterrcnn_resnet18_fpn",
                                  "fcos_resnet18_fpn"])
def test_seeded_detector_loads_a_jax_shaped_tree(name):
    """The weights the card serves with: ``seeded_flax_tree`` has the JAX
    model's paths and shapes, the converter carries it in unchanged, and
    every scale (BatchNorm's, FCOS's level scales) is nonzero, so no
    residual branch is left out."""
    from deeplearning_tpu_torch.models.detection.predict import head_classes
    from deeplearning_tpu_torch.serve.profile import (SCALE_RANGE,
                                                      seeded_detector,
                                                      seeded_flax_tree)
    classes = head_classes(name, 3)
    with torch.device("meta"):
        meta = TMODELS.build(name, num_classes=classes)
    tree = seeded_flax_tree(meta, seed=3)
    assert _flax_shapes(tree) == _jax_tree_shapes(name, classes)
    model = seeded_detector(name, 3, seed=0, size=64, device="cpu")
    state = model.state_dict()
    for key, value in convert.from_flax_params(tree, like=meta).items():
        if not key.endswith(("running_mean", "running_var")):
            assert torch.equal(state[key], value), key
    scales = [v for k, v in state.items()
              if k.endswith("weight") and v.dim() <= 1]
    assert scales and all(bool(((v >= SCALE_RANGE[0])
                                & (v < SCALE_RANGE[1])).all())
                          for v in scales)


def test_serve_profile_sorts_detection_kernels_by_kind():
    """The serving profiler's kinds: K3, convolutions, RoIAlign's gathers
    and the top-k sorts each apart; attention and GEMMs as in training."""
    from deeplearning_tpu_torch.serve.profile import (detector_defaults,
                                                      kind_of)
    assert kind_of("nms_greedy_sweep") == "nms (K3)"
    assert kind_of("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == \
        "conv"
    assert kind_of("void at::native::index_elementwise_kernel<128, 4>") == \
        "gather / index"
    assert kind_of("void at::native::radixSortKVInPlace<...>") == \
        "sort / top-k"
    assert kind_of("void (anonymous namespace)::fwd_bf16_wgmma<64, 4>") == \
        "flash attention"
    assert kind_of("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == \
        "gemm"
    assert kind_of("void at::native::vectorized_elementwise_kernel") == \
        "elementwise / other"
    assert detector_defaults("fasterrcnn_resnet50_fpn") == (20, 0.05)
    assert detector_defaults("yolov5s") == (80, 0.0)


def test_serve_profile_wraps_each_batchnorm_call_in_a_range():
    """The profiler's BatchNorm attribution: one ``BatchNorm`` range a
    BatchNorm call, holding its ops, and no hook left behind."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_tpu_torch.serve.profile import _batchnorm_ranges
    model = tresnet.resnet18(num_classes=3).eval()
    calls = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    handles = _batchnorm_ranges(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    for h in handles:
        h.remove()
    ranges = [e for e in prof.events() if e.name == "BatchNorm"]
    assert len(ranges) == calls
    assert all({c.name for c in r.cpu_children} & {"aten::mul", "aten::sub"}
               for r in ranges)
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())
