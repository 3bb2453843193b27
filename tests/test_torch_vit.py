"""Port ViT (deeplearning_tpu_torch/models/classification/vit.py) vs the
JAX ViT, on the same weights through utils/convert.from_flax_params.

Tiny config (img 32, patch 8, embed 64, depth 2, 4 heads, float32), inputs
made from a seed with numpy. Naive and flash_hb attention, tanh and erf
GELU; logits within 1e-4 (tests/conftest.py sets JAX matmuls to highest
precision, and PyTorch's CPU float32 matmuls are full precision).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core import numerics as jnumerics
from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.ops.attention import get_attn_fn as j_get_attn_fn
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch.core import numerics as tnumerics
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.ops.attention import get_attn_fn as t_get_attn_fn
from deeplearning_tpu_torch.utils.convert import from_flax_params, load_npz

TINY = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
            depth=2, num_heads=4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Force pallas interpret mode on CPU (the JAX flash_hb path)."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


@pytest.fixture(scope="module")
def jax_variables():
    model = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
    return model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                      train=False)


def _images(n=3, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


def _port(attn, variables):
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                   attn_fn=t_get_attn_fn(attn))
    model.load_state_dict(from_flax_params(variables))
    return model.eval()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("attn", ["naive", "flash_hb"])
def test_logits_match_jax(jax_variables, attn, exact):
    x = _images()
    jmodel = jvit.VisionTransformer(**TINY, dtype=jnp.float32,
                                    attn_fn=j_get_attn_fn(attn))
    with jnumerics.exact_numerics(exact):
        want = np.asarray(jmodel.apply(jax_variables, jnp.asarray(x),
                                       train=False))
    with tnumerics.exact_numerics(exact), torch.no_grad():
        got = _port(attn, jax_variables)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_head_dim_80_matches_jax():
    """ViT-H/14's head dim (1 280 wide, 16 heads: D = 80) at small width:
    two heads of 80 in a 160-wide, one-block ViT through flash_hb, against
    the JAX model on the same weights. On the card the kernels run it
    zero-padded to D = 128 (tests/test_torch_kernels_card.py)."""
    cfg = dict(TINY, embed_dim=160, num_heads=2, depth=1)
    jmodel = jvit.VisionTransformer(**cfg, dtype=jnp.float32,
                                    attn_fn=j_get_attn_fn("flash_hb"))
    x = _images(2, seed=3)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)),
                            train=False)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = tvit.VisionTransformer(**cfg, dtype=torch.float32,
                                   attn_fn=t_get_attn_fn("flash_hb"))
    model.load_state_dict(from_flax_params(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_gelu_modes_differ_and_restore():
    x = torch.linspace(-4, 4, 101)
    fast = tnumerics.gelu(x)
    with tnumerics.exact_numerics():
        assert tnumerics.exact_enabled()
        exact = tnumerics.gelu(x)
    assert not tnumerics.exact_enabled()
    assert 0 < (fast - exact).abs().max() < 2e-3
    torch.testing.assert_close(exact, torch.nn.functional.gelu(x))


def test_converted_names_cover_the_port_exactly(jax_variables):
    state = from_flax_params(jax_variables)
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32)
    assert set(state) == set(model.state_dict())
    # (in, out) Dense kernels become (out, in); HWIO patch kernel flattens
    qkv = np.asarray(jax_variables["params"]["blocks_0"]["attn"]["qkv"]
                     ["kernel"])
    np.testing.assert_array_equal(state["blocks.0.attn.qkv.weight"].numpy(),
                                  qkv.T)
    proj = np.asarray(jax_variables["params"]["patch_embed"]["proj"]
                      ["kernel"])
    assert state["patch_embed.proj.weight"].shape == (64, 8 * 8 * 3)
    np.testing.assert_array_equal(state["patch_embed.proj.weight"].numpy(),
                                  proj.reshape(-1, 64).T)


def test_load_npz_and_hub_weights(jax_variables, tmp_path):
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_variables)}
    path = tmp_path / "tiny.npz"
    np.savez(path, **flat)
    state = load_npz(str(path))
    ref = from_flax_params(jax_variables)
    assert set(state) == set(ref)
    for key in ref:
        torch.testing.assert_close(state[key], ref[key], atol=0, rtol=0)
    model, hub_state = hub.load("vit_base_patch16_224", device="cpu",
                                weights=str(path), **{**TINY,
                                                      "num_classes": 10})
    for key in ref:
        torch.testing.assert_close(hub_state[key], ref[key], atol=0, rtol=0)
    assert not model.training


def test_factories_mirror_the_jax_registry():
    # list_models filters by substring, as JAX's hub does: the MAE
    # factories (mae_vit_*) are among its "vit_" names
    jax_vits = sorted(n for n in JMODELS.keys() if "vit_" in n)
    assert hub.list_models("vit_") == jax_vits
    assert set(jax_vits) <= set(TMODELS.keys())
    b16 = TMODELS.build("vit_base_patch16_224", num_classes=1000,
                        depth=1)   # full width, one block
    assert b16.pos_embed.shape == (1, 197, 768)
    assert b16.blocks[0].attn.num_heads == 12


def test_seeded_init_is_deterministic():
    a, _ = hub.load("vit_micro_patch4_56", device="cpu", seed=3, depth=1)
    b, _ = hub.load("vit_micro_patch4_56", device="cpu", seed=3, depth=1)
    c, _ = hub.load("vit_micro_patch4_56", device="cpu", seed=4, depth=1)
    torch.testing.assert_close(a.pos_embed, b.pos_embed, atol=0, rtol=0)
    assert not torch.equal(a.pos_embed, c.pos_embed)
    # flax's head init: trunc-normal(0.01) within two sigma
    assert a.head.weight.abs().max() <= 0.02 + 1e-7


def test_default_dtype_is_bf16_compute_with_f32_logits():
    model, _ = hub.load("vit_micro_patch4_56", device="cpu", depth=1,
                        num_classes=7)
    assert model.pos_embed.dtype == torch.float32
    with torch.no_grad():
        out = model(torch.from_numpy(np.random.default_rng(0).normal(
            size=(2, 56, 56, 3)).astype(np.float32)))
    assert out.dtype == torch.float32 and out.shape == (2, 7)
    assert torch.isfinite(out).all()


# ------------------------------------------- explicit randomness and remat
def _train_grads(model, x, rng):
    model.train()
    loss = model(x, rng=rng).square().sum()
    return torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("attn", ["naive", "flash_hb"])
def test_remat_gives_the_same_gradients(jax_variables, attn):
    """remat=True (non-reentrant checkpoint per Block) against remat=False
    on the same weights and generator state, with drop-path on: the
    recompute replays the forward's masks."""
    from deeplearning_tpu_torch.core import rng as trng
    x = torch.from_numpy(_images(4, seed=1))
    grads = []
    for remat in (False, True):
        model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                       drop_path_rate=0.3, remat=remat,
                                       attn_fn=t_get_attn_fn(attn))
        model.load_state_dict(from_flax_params(jax_variables))
        gen = trng.step_key(trng.root_key(0), 5)
        grads.append(_train_grads(model, x, gen))
        # the stream ends where it would without remat
        grads[-1] = grads[-1] + (torch.rand(3, generator=gen),)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_registry_accepts_remat():
    model = TMODELS.build("vit_micro_patch4_56", num_classes=7, depth=1,
                          remat=True)
    assert model.remat
    jmodel = JMODELS.build("vit_micro_patch4_56", num_classes=7, depth=1,
                           remat=True)
    assert jmodel.remat


def test_masks_follow_the_step_key():
    """Same step key -> same drop-path masks; another step -> others."""
    from deeplearning_tpu_torch.core import rng as trng
    x = torch.ones(64, 3, 8)
    key = trng.root_key(3)
    a = tvit.drop_path(x, 0.5, False, trng.step_key(key, 1))
    b = tvit.drop_path(x, 0.5, False, trng.step_key(key, 1))
    c = tvit.drop_path(x, 0.5, False, trng.step_key(key, 2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    d = tvit.dot_product_attention(
        *(torch.ones(2, 5, 2, 4) for _ in range(3)), dropout_rate=0.5,
        deterministic=False, rng=trng.step_key(key, 1))
    assert d.shape == (2, 5, 2, 4)


def test_train_mode_randomness_needs_a_generator():
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                   drop_path_rate=0.1).train()
    x = torch.from_numpy(_images(2))
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    with pytest.raises(ValueError, match="Generator"):
        tvit.dropout(x, 0.1, False)
    with torch.no_grad():               # eval mode draws nothing
        assert model.eval()(x).shape == (2, 10)
