"""Port flash-attention backward (deeplearning_tpu_torch/ops/flash_attention.py)
vs the JAX Pallas backward kernels it replaces.

On the CPU the port's autograd function takes its plain backward,
``flash_attention_bwd_reference``; the JAX side runs ``jax.grad`` through
its custom VJP with the Pallas kernels in interpret mode, as
tests/test_flash_attention.py does. Inputs and the output cotangent are
made from a seed with numpy and handed to both. Tolerance 1e-5 (float32;
the JAX tests hold their own backward to 5e-4).

The CUDA kernels are held against the plain version on the card by
tests/test_torch_kernels_card.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.ops.pallas import flash_attention as jfa
from deeplearning_tpu_torch.ops import attention as tattn
from deeplearning_tpu_torch.ops import flash_attention as tfa
from deeplearning_tpu_torch.ops.kernels import build

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(197, 64), (49, 32), (17, 16)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Force pallas interpret mode on CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _arrays(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(count)]


def _torch_grads(fn, q, k, v, do, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt, **kw)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))


def _jax_grads(fn, q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_hb"])
def test_grads_match_jax(entry, n, d, causal):
    q, k, v, do = _arrays((1, 4, n, d), 4, seed=n + d + causal)
    want = _jax_grads(getattr(jfa, entry), q, k, v, do, causal=causal)
    got = _torch_grads(getattr(tfa, entry), q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (1, 4, n, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bnhd_grads_match_jax():
    q, k, v, do = _arrays((2, 49, 4, 32), 4, seed=11)
    want = _jax_grads(jfa.flash_attention_bnhd, q, k, v, do)
    got = _torch_grads(tfa.flash_attention_bnhd, q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_bwd_matches_autograd_of_reference(causal):
    """The plain backward (FlashAttention-2 formulas, P recomputed from the
    LSE) against torch autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _arrays((2, 3, 33, 16), 4, seed=5))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_reference(qr, kr, vr, causal=causal)
    want = torch.autograd.grad(o, (qr, kr, vr), do)
    got = tfa.flash_attention_bwd_reference(q, k, v, o.detach(),
                                            lse.detach(), do, causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_hb"])
def test_gradcheck_float64(entry, causal):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 9, 16, dtype=torch.float64, generator=g,
                           requires_grad=True) for _ in range(3))
    fn = functools.partial(getattr(tfa, entry), causal=causal)
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("n,d", [(49, 32), (17, 16), (17, 80)])
def test_chunk_grads_match_jax(n, d):
    """Ring attention's building block: global LSE/delta given, float32
    gradients."""
    q, k, v, do = _arrays((2, 3, n, d), 4, seed=3 * n)
    rng = np.random.default_rng(n)
    lse = rng.normal(2.0, 0.3, (2, 3, n)).astype(np.float32)
    delta = rng.normal(0.0, 0.5, (2, 3, n)).astype(np.float32)
    want = jfa.flash_chunk_grads(*map(jnp.asarray, (q, k, v, do, lse, delta)))
    got = tfa.flash_chunk_grads(*map(torch.from_numpy,
                                     (q, k, v, do, lse, delta)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_pad_is_exact_with_the_true_scale(causal):
    """The card runs D = 80 (ViT-H/14) zero-padded to the 128 kernel and
    D = 160 to the 256 one: the plain version on padded operands, with
    sm_scale from the true D, equals the unpadded plain version in the
    output, the LSE and the gradients. The padded D's own default scale
    would not. Above 256, D runs on the wide SIMT kernels at the next
    multiple of 64 (D = 300 at 320)."""
    assert [tfa._kernel_head_dim(d) for d in (16, 17, 64, 80, 128, 129,
                                              160, 256, 257, 300, 320,
                                              512)] == [
        16, 32, 64, 128, 128, 256, 256, 256, 320, 320, 320, 512]
    with pytest.raises(ValueError, match="1 or more"):
        tfa._kernel_head_dim(0)
    for d, d_kernel in ((80, 128), (160, 256), (300, 320)):
        q, k, v, do = (torch.from_numpy(x) for x in
                       _arrays((2, 2, 19, d), 4, seed=d + causal))
        qp, kp, vp, dop = tfa._pad_head_dim((q, k, v, do), d_kernel)
        assert qp.shape == (2, 2, 19, d_kernel) and not qp[..., d:].any()
        scale = d ** -0.5
        o, lse = tfa.flash_attention_reference(q, k, v, causal=causal)
        op, lsep = tfa.flash_attention_reference(qp, kp, vp, sm_scale=scale,
                                                 causal=causal)
        torch.testing.assert_close(op[..., :d], o, atol=1e-6, rtol=1e-6)
        assert not op[..., d:].any()
        torch.testing.assert_close(lsep, lse, atol=1e-6, rtol=1e-6)
        wrong, _ = tfa.flash_attention_reference(qp, kp, vp, causal=causal)
        assert (wrong[..., :d] - o).abs().max() > 1e-2
        want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal=causal)
        got = tfa.flash_attention_bwd_reference(qp, kp, vp, op, lsep, dop,
                                                sm_scale=scale,
                                                causal=causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[..., :d], w, atol=1e-5, rtol=1e-5)
            assert not g[..., d:].any()


def test_head_dim_256_matches_jax():
    """The widest instantiated head dim, forward and gradients, against
    the JAX kernels (interpret mode) at a small N."""
    q, k, v, do = _arrays((1, 2, 9, 256), 4, seed=256)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip(_torch_grads(tfa.flash_attention, q, k, v, do),
                    _jax_grads(jfa.flash_attention, q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_chunk_grads_need_equal_chunks():
    q, k, v, do = (torch.zeros(1, 2, 8, 16) for _ in range(4))
    lse = delta = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        tfa.flash_chunk_grads(q, k[:, :, :4], v[:, :, :4], do, lse, delta)


def test_with_lse_stays_forward_only():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays((1, 2, 17, 16), 3, seed=2))
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    assert not out.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("h,head_block", [(6, 4), (3, 4), (12, 4)])
def test_head_block_rule_in_backward(h, head_block):
    """flash_attention_hb halves head_block until it divides H; the
    gradients equal the per-head path's whatever it lands on."""
    q, k, v, do = _arrays((1, h, 17, 16), 4, seed=h)
    got = _torch_grads(tfa.flash_attention_hb, q, k, v, do,
                       head_block=head_block)
    want = _torch_grads(tfa.flash_attention, q, k, v, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    jwant = _jax_grads(jfa.flash_attention_hb, q, k, v, do,
                       head_block=head_block)
    for g, w in zip(got, jwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["flash", "flash_hb"])
def test_adapter_grads_through_fused_qkv(name):
    """The ViT path: q, k, v are strided slices of one fused qkv; the
    gradient of the fused tensor equals the naive attention's."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 17, 3, 4, 16)).astype(
        np.float32)).requires_grad_()
    dout = torch.from_numpy(rng.normal(size=(2, 17, 4, 16)).astype(
        np.float32))
    (got,) = torch.autograd.grad(tattn.get_attn_fn(name)(*qkv.unbind(2)),
                                 qkv, dout)
    from deeplearning_tpu_torch.models.classification.vit import (
        dot_product_attention)
    (want,) = torch.autograd.grad(dot_product_attention(*qkv.unbind(2)),
                                  qkv, dout)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_backward_never_builds_or_counts(monkeypatch):
    def refuse(name):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(build, "load", refuse)
    tfa.reset_launch_counts()
    q, k, v, do = _arrays((1, 4, 17, 16), 4, seed=9)
    _torch_grads(tfa.flash_attention, q, k, v, do)
    _torch_grads(tfa.flash_attention_hb, q, k, v, do)
    assert set(tfa.launch_counts()) == {
        "flash_attn_fwd", "flash_attn_fwd_hb", "flash_attn_bwd_dq",
        "flash_attn_bwd_dkv", "flash_attn_bwd_dq_hb", "flash_attn_bwd_dkv_hb"}
    assert not any(tfa.launch_counts().values())


def test_nvcc_builds_the_backward_source():
    src = build.CSRC_DIR / "flash_attn_bwd.cu"
    assert src in build.sources()
    text = src.read_text()
    for kernel in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_bwd_dq_kernel_hb",
                   "_bwd_dkv_kernel_hb"):
        assert kernel in text          # the TPU kernels it replaces
    # dQ and dK/dV are both wgmma kernels; no mma.sync design is left
    assert "bwd_dq_bf16_wgmma" in text and "bwd_dkv_bf16_wgmma" in text
    assert "mma.sync" not in text
    assert build.library_path(src).name.startswith("libflash_attn_bwd-")


def test_bwd_bound_helpers():
    # ViT-B/16 training shape: one (B*H*N*D) bf16 tensor is 38.73 MB
    b, h, n, d = 128, 12, 197, 64
    # dQ reads q, k, v, dO, O and LSE, writes dQ and delta; dK/dV reads
    # q, k, v, dO, LSE and delta, writes dK and dV: 6 tensors, 2 rows each
    assert tfa.bwd_min_bytes(b, h, n, d, 2, "dq") == pytest.approx(234.8e6,
                                                                   rel=1e-3)
    assert tfa.bwd_min_bytes(b, h, n, d, 2, "dkv") == pytest.approx(
        234.8e6, rel=1e-3)
    # the whole backward: q, k, v, dO, O, LSE in; dQ, dK, dV out
    assert tfa.bwd_min_bytes(b, h, n, d, 2) == pytest.approx(311.05e6,
                                                             rel=1e-3)
    unit = 2.0 * b * h * n * n * d
    assert unit == pytest.approx(7.63e9, rel=1e-3)
    assert tfa.bwd_flops(b, h, n, d, kernel="dq") == 3 * unit
    assert tfa.bwd_flops(b, h, n, d, kernel="dkv") == 4 * unit
    assert tfa.bwd_flops(b, h, n, d) == 5 * unit
