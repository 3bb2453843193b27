"""Port window attention (deeplearning_tpu_torch/ops/window_utils.py and
ops/window_attention.py) vs the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both frameworks. The
JAX fused kernel runs interpreted, as its own tests run it. Tolerances:
the integer and mask tables and the partition/merge copies are exact; the
kernel's plain version against JAX's fused kernel 2e-5 (float32, the TPU
kernel's numerics on both sides); the unfused references 2e-5; gradients of
the differentiable form 5e-5 (both recompute through the unfused
reference, whose q is scaled before the product).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.ops import window_utils as jwu
from deeplearning_tpu.ops.pallas import window_attention as jwa
from deeplearning_tpu_torch.ops import window_attention as twa
from deeplearning_tpu_torch.ops import window_utils as twu


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _inputs(bw=8, n=49, heads=3, d=32, mask=(14, 14, 7, 3), seed=0):
    """numpy qkv (BW, N, 3, heads, d), bias (heads, N, N) and the shift mask
    of (h, w, window, shift), or None."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 0.5, (bw, n, 3, heads, d)).astype(np.float32)
    bias = rng.normal(0, 0.5, (heads, n, n)).astype(np.float32)
    m = jwu.shift_window_mask(*mask) if mask is not None else None
    return qkv, bias, m


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ------------------------------------------------------------- window utils
@pytest.mark.parametrize("h,w,window,shift", [(14, 14, 7, 3), (28, 28, 7, 3),
                                              (16, 16, 8, 4), (6, 6, 3, 1),
                                              (8, 16, 4, 2)])
def test_shift_mask_is_the_jax_table(h, w, window, shift):
    got = twu.shift_window_mask(h, w, window, shift)
    want = jwu.shift_window_mask(h, w, window, shift)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [1, 2, 3, 4, 6, 7, 8])
def test_relative_position_index_is_the_jax_table(window):
    got = twu.relative_position_index(window)
    want = jwu.relative_position_index(window)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_partition_and_merge_are_the_jax_copies():
    x = np.random.default_rng(1).normal(size=(2, 14, 21, 5)).astype(
        np.float32)
    wins = twu.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(
        jwu.window_partition(jnp.asarray(x), 7)))
    back = twu.window_merge(wins, 7, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("mask", [(14, 14, 7, 3), None])
def test_unfused_reference_matches_jax(mask):
    qkv, bias, m = _inputs(mask=mask)
    got = twu.windowed_attention_reference(_t(qkv), _t(bias), _t(m))
    want = jwu.windowed_attention_reference(_j(qkv), _j(bias), _j(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------- the kernel's function
@pytest.mark.parametrize("bw,n,heads,d,mask,wb", [
    (8, 49, 3, 32, (14, 14, 7, 3), 8),     # masked, nW = 4 < wb
    (8, 49, 3, 32, None, 8),               # unmasked
    (16, 49, 2, 16, (14, 14, 7, 3), 8),    # nW divides BW, tiled mask
    (12, 49, 3, 32, (14, 21, 7, 3), 4),    # nW = 6 not a multiple of wb
    (8, 9, 4, 16, (6, 6, 3, 1), 8),        # N = 9
    (6, 16, 2, 64, None, 2),               # N = 16, d = 64
    (8, 144, 2, 24, (24, 24, 12, 6), 4),   # window 12 (N = 144), d = 24
])
def test_plain_version_matches_jax_fused_kernel(bw, n, heads, d, mask, wb):
    qkv, bias, m = _inputs(bw, n, heads, d, mask, seed=bw + n)
    before = twa.launch_counts()
    got = twa.window_attention(_t(qkv), _t(bias), _t(m),
                               windows_per_block=wb)
    want = jwa.window_attention(_j(qkv), _j(bias), _j(m),
                                windows_per_block=wb)
    assert got.shape == (bw, n, heads * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # a CPU tensor takes the plain version: no launch
    assert twa.launch_counts() == before
    torch.testing.assert_close(
        got, twa.window_attention_plain(_t(qkv), _t(bias), _t(m)),
        atol=0, rtol=0)


def test_plain_version_of_a_strided_fused_projection():
    """qkv as the model hands it over: a view of one (BW, N, 3C)
    projection; bf16 rounds P before P·V, as the kernel does."""
    qkv, bias, m = _inputs(bw=8)
    proj = torch.from_numpy(qkv.reshape(8, 49, 3 * 96))
    view = proj.view(8, 49, 3, 3, 32)
    got = twa.window_attention(view, _t(bias), _t(m))
    want = twa.window_attention_plain(_t(qkv), _t(bias), _t(m))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    bf = twa.window_attention(view.bfloat16(), _t(bias), _t(m))
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), want, atol=2e-2, rtol=2e-2)


def test_checkpointed_gradients_match_jax():
    qkv, bias, m = _inputs(bw=8, seed=3)
    g = np.random.default_rng(4).normal(
        size=(qkv.shape[0], 49, 96)).astype(np.float32)

    def jloss(a, b):
        out = jwa.window_attention_checkpointed(a, b, _j(m))
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1))(_j(qkv), _j(bias))
    a = _t(qkv).requires_grad_()
    b = _t(bias).requires_grad_()
    out = twa.window_attention_checkpointed(a, b, _t(m))
    got = torch.autograd.grad(out, (a, b), _t(g))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("d,d_kernel", [(24, 32), (48, 64), (80, 128),
                                        (160, 192)])
def test_head_dim_pad_is_exact_with_the_true_scale(d, d_kernel):
    """The card runs a d the kernel lacks zero-padded to the next one it
    has: the wrapper's pad-and-slice around the plain version, with the
    true d's scale, equals the plain version on the unpadded qkv. The
    padded d's own default scale would not. Above 128, d runs on the wide
    SIMT kernel at the next multiple of 64."""
    assert [twa._kernel_head_dim(x) for x in (1, 16, 17, 33, 64, 65, 128,
                                              129, 160, 192, 256, 300)] \
        == [16, 16, 32, 64, 64, 128, 128, 192, 192, 192, 256, 320]
    with pytest.raises(ValueError, match="1 or more"):
        twa._kernel_head_dim(0)
    qkv, bias, m = (_t(x) for x in _inputs(bw=8, heads=2, d=d, seed=d))
    seen = []

    def run(x, scale):
        seen.append((x.shape[-1], scale))
        assert not x[..., d:].any()
        return twa.window_attention_plain(x, bias, m, scale=scale)

    got = twa._at_kernel_head_dim(qkv, run)
    assert seen == [(d_kernel, d ** -0.5)] and got.shape == (8, 49, 2 * d)
    want = twa.window_attention_plain(qkv, bias, m)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    padded = torch.nn.functional.pad(qkv, (0, d_kernel - d))
    wrong = twa.window_attention_plain(padded, bias, m)
    assert (wrong.view(8, 49, 2, d_kernel)[..., :d].reshape(8, 49, 2 * d)
            - want).abs().max() > 1e-3


def test_bad_arguments_raise():
    qkv, bias, m = (_t(x) for x in _inputs(bw=8))
    with pytest.raises(ValueError, match="bias"):
        twa.window_attention(qkv, bias[:2], m)
    with pytest.raises(ValueError, match="mask"):
        twa.window_attention(qkv[:6], bias, m)      # nW = 4 does not divide 6
    with pytest.raises(ValueError, match="qkv"):
        twa.window_attention(qkv[:, :, :2], bias, m)
    with pytest.raises(TypeError):
        twa.window_attention_checkpointed(qkv, bias, m, block=4)


def test_nvcc_builds_the_window_source():
    """K2 is one source of a wgmma kernel fed by TMA (the hopper.cuh
    helpers) and a float32 SIMT kernel; no mma.sync design is left."""
    from deeplearning_tpu_torch.ops.kernels import build
    src = build.CSRC_DIR / "window_attn_fwd.cu"
    assert src in build.sources()
    text = src.read_text()
    assert "_attn_kernel" in text      # the TPU kernel it replaces
    assert '#include "hopper.cuh"' in text
    assert "win_bf16_wgmma" in text and "win_f32_simt" in text
    assert "mma.sync" not in text and "win_bf16_mma" not in text
    assert build.library_path(src).name.startswith("libwindow_attn_fwd-")


def test_bound_of_swin_t_stage_1_at_batch_128():
    """bf16: qkv read and O written once, plus the bias and the mask."""
    nbytes = twa.min_bytes(128 * 64, 49, 3, 32, 2, nw=64)
    assert nbytes == pytest.approx(309e6, rel=2e-3)
    assert twa.flops(128 * 64, 49, 3, 32) == pytest.approx(7.55e9, rel=1e-3)
