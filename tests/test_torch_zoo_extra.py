"""The port's Happy-Whale backbones and mask-crop pipeline
(deeplearning_tpu_torch/models/classification/zoo_extra.py and
models/metric/mask_crop.py) vs the JAX package, on the CPU, and the train
CLI on the new factories.

Each factory is built in float32 at the small configs of JAX's own tests
(tests/test_zoo_extra.py: fewer blocks a stage, full width) at 64²; the
weights are a numpy-made flax tree (``seeded_tree``) converted by
``utils/convert.from_flax_params``. Tolerances: eval logits rtol / atol
1e-4 (JAX matmuls at highest precision, tests/conftest.py); the
BatchNorm running statistics after one train-mode forward rtol / atol
1e-4; the variable trees (names and shapes) equal, at the small configs
and, from ``jax.eval_shape`` against the port built on the meta device,
at the full default ones. The mask predictor's sigmoid within 1e-6, its
binarized masks equal wherever the probability is at least 1e-4 from the
threshold.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.metric import mask_crop as jmask
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.metric.mask_crop import (
    crop_by_mask, make_mask_predictor, mask_crop_source, mask_to_bbox,
    write_masks)
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_zoo_extra.py's shrunk configs (JAX's own test runs them at 96²)
SMALL = {
    "xception": {},
    "inception_v4": {"blocks": (1, 1, 1)},
    "dpn68": {"k_sec": (1, 1, 1, 1)},
    "dpn92": {"k_sec": (1, 1, 1, 1)},
    "nasnet_a_mobile": {"n_normal": 1},
    "polynet": {"stage_blocks": (3, 3, 3)},
    "senet154": {"blocks": (1, 1, 1, 1)},
}
SIZE = 64
CONFIGS = ["dpn92", "inception_v4", "nasnet_a_mobile", "polynet",
           "senet154", "xception"]


def _images(n, size=SIZE, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree.items()
            if not k.endswith("num_batches_tracked")}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _jax_shapes(name, kw, size=SIZE):
    jm = JMODELS.build(name, num_classes=7, dtype=jnp.float32, **kw)
    return jm, jax.eval_shape(functools.partial(jm.init, train=False),
                              jax.random.key(0),
                              jnp.zeros((1, size, size, 3)))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_factory_matches_jax(name):
    """Eval logits, the variable tree, and the BatchNorm running
    statistics after one train-mode forward (PolyNet's shared poly-2
    units move theirs twice) against JAX's."""
    jm, shapes = _jax_shapes(name, SMALL[name])
    variables = seeded_tree(shapes)
    with torch.device("meta"):
        tm = TMODELS.build(name, num_classes=7, dtype=torch.float32,
                           **SMALL[name])
    want_sd = from_flax_params(variables, like=tm)
    assert _shapes(want_sd) == _shapes(tm.state_dict())
    tm.load_state_dict(want_sd, assign=True)
    tm.eval()
    x = _images(2)

    def both(v, images):       # one compile: eval logits, train stats
        return (jm.apply(v, images, train=False),
                jm.apply(v, images, train=True,
                         mutable=["batch_stats"])[1])
    want, mutated = jax.jit(both)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    _close(got, want, 1e-4, f"{name} logits")
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x), rng=trng.step_key(0, 0))
    want_sd = from_flax_params({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]},
                               like=tm)
    got_sd = tm.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert stats
    for k in stats:
        _close(got_sd[k], want_sd[k], 1e-4, f"{name} {k}")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_full_size_variables_equal_jaxs(name):
    """At the full default configs (SENet-154: 93 M parameters) the
    port's parameters and statistics are the converted flax tree's, name
    for name and shape for shape; nothing is allocated on either side."""
    _, shapes = _jax_shapes(name, {})
    with torch.device("meta"):
        tm = TMODELS.build(name, num_classes=7, dtype=torch.float32)
    want = from_flax_params(jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes), like=tm)
    assert _shapes(want) == _shapes(tm.state_dict())


def test_nasnet_refuses_an_input_below_its_least_size():
    with torch.device("meta"):
        tm = TMODELS.build("nasnet_a_mobile", num_classes=7, n_normal=1)
    with pytest.raises(ValueError, match="at least 17"):
        tm(torch.zeros((1, 16, 16, 3), device="meta"))


# ------------------------------------------------------------- mask crop
def test_mask_to_bbox_and_crop():
    mask = np.zeros((64, 64), np.float32)
    mask[10:30, 20:50] = 1.0
    x0, y0, x1, y1 = mask_to_bbox(mask, pad_frac=0.0)
    assert (x0, y0, x1, y1) == (20, 10, 50, 30)
    # padding stays inside the image
    x0, y0, x1, y1 = mask_to_bbox(mask, pad_frac=0.5)
    assert x0 >= 0 and y0 >= 0 and x1 <= 64 and y1 <= 64
    # empty mask → whole image
    assert mask_to_bbox(np.zeros((32, 48))) == (0, 0, 48, 32)
    img = np.random.default_rng(0).normal(size=(64, 64, 3)).astype(
        np.float32)
    crop = crop_by_mask(img, mask, out_hw=(24, 24), pad_frac=0.0)
    assert crop.shape == (24, 24, 3)
    np.testing.assert_array_equal(
        crop, jmask.crop_by_mask(img, mask, out_hw=(24, 24), pad_frac=0.0))


def test_crop_by_mask_resolution_mismatch():
    """Stage-1 masks are predicted at a fixed size; the bbox must be
    rescaled into image space, not applied in mask coordinates."""
    img = np.zeros((128, 256, 3), np.float32)
    img[64:96, 128:192] = 7.0          # object in image space
    mask = np.zeros((64, 64), np.float32)
    mask[32:48, 32:48] = 1.0           # same object in 64x64 mask space
    crop = crop_by_mask(img, mask, pad_frac=0.0)
    assert crop.shape == (32, 64, 3)   # 16/64 of 128, 16/64 of 256
    assert (crop == 7.0).all()
    # empty mask falls back to the FULL image, not the mask extent
    full = crop_by_mask(img, np.zeros((64, 64)), pad_frac=0.0)
    assert full.shape == img.shape


def _unet_pair():
    kw = dict(num_classes=1, base_features=8)
    jm = JMODELS.build("unet", dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = seeded_tree(shapes, seed=4)
    with torch.device("meta"):
        tm = TMODELS.build("unet", dtype=torch.float32, **kw)
    tm.load_state_dict(from_flax_params(variables, like=tm), assign=True)
    return jm, variables, tm


def test_mask_predictor_matches_jax():
    """The 1-logit path: the port's sigmoid masks against JAX's jitted
    predictor on the same U-Net weights; binarized, equal wherever the
    probability is not within 1e-4 of the threshold. The K-logit path
    takes argmax != background."""
    jm, variables, tm = _unet_pair()
    x = _images(2, seed=6)
    want = jmask.make_mask_predictor(jm, variables)(x)
    predict = make_mask_predictor(tm.train())
    got = predict(x)
    assert not tm.training and predict.threshold == 0.5
    assert got.shape == (2, SIZE, SIZE) and got.dtype == np.float32
    _close(got, want, 1e-6, "sigmoid masks")
    clear = np.abs(want - 0.5) >= 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal((got > 0.5)[clear], (want > 0.5)[clear])

    class ThreeLogits(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([0.0, 1.0, 0.5]))

        def forward(self, images):
            return {"out": images[..., :1] * self.w}
    masks = make_mask_predictor(ThreeLogits())(x)
    np.testing.assert_array_equal(masks, (x[..., 0] > 0).astype(np.float32))


def test_staged_mask_crop_pipeline(tmp_path):
    """Stage 1 writes masks from a (random-weight) U-Net head; stage 2's
    source crops by them; the retrieval model embeds the crops."""
    from PIL import Image
    imgs_dir = tmp_path / "imgs"
    imgs_dir.mkdir()
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(4):
        arr = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        arr[16:48, 16:48] = 255  # bright square the mask should find
        p = imgs_dir / f"w{i}.jpg"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
        labels.append(i % 2)

    seg = TMODELS.build("unet", num_classes=1, base_features=8,
                        generator=torch.Generator().manual_seed(0))
    predictor = make_mask_predictor(seg)
    n = write_masks(predictor, paths, str(tmp_path / "masks"),
                    image_size=(64, 64), batch=2)
    assert n == 4
    assert sorted(p.name for p in (tmp_path / "masks").iterdir()) == [
        f"w{i}.png" for i in range(4)]
    src = mask_crop_source(paths, labels, str(tmp_path / "masks"),
                           out_hw=(32, 32))
    sample = src[0]
    assert sample["image"].shape == (32, 32, 3)
    assert int(sample["label"]) == 0

    retr = TMODELS.build("arcface_resnet18", num_classes=2,
                         generator=torch.Generator().manual_seed(1))
    batch = np.stack([src[i]["image"] for i in range(4)])
    with torch.no_grad():
        emb = retr.eval()(torch.from_numpy(batch))["embedding"]
    assert emb.shape == (4, 512) and torch.isfinite(emb).all()


# ------------------------------------------------------------ the CLI
def test_train_cli_takes_every_new_factory(tmp_path, monkeypatch):
    """The six configs name models of the port's registry (dpn68 is in it
    too), and nasnet_a_mobile.yaml builds through the train CLI's
    ``build`` on the CPU and takes one step at global batch 2."""
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.train import __main__ as cli
    # the logger's TensorBoard backend off: importing it takes seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    names = [config_cli(cli.Config(), ["--cfg", f"configs/{c}.yaml"]
                        ).model.name for c in CONFIGS]
    assert names == CONFIGS
    assert set(SMALL) <= set(TMODELS.keys())
    cfg = config_cli(cli.Config(), [
        "--cfg", "configs/nasnet_a_mobile.yaml", "train.device=cpu",
        "data.n_train=2", "data.global_batch=2", "train.epochs=1",
        "train.precompile=false", f"train.workdir={tmp_path}"])
    assert cfg.data.image_size == SIZE and cfg.data.channels == 3
    trainer = cli.build(cfg)
    assert type(trainer.state.model).__name__ == "NASNetA"
    trainer.train()
    assert trainer.state.step == 1
    assert all(torch.isfinite(p).all()
               for p in trainer.state.params.values())
