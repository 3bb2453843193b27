"""Port flash attention (deeplearning_tpu_torch/ops/flash_attention.py) vs
the JAX Pallas kernels it replaces.

On the CPU the port's entry points take their plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does. Inputs are made from a seed with
numpy and handed to both. Tolerance 2e-5 (float32), the JAX tests' own.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_card.py and by chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.ops.pallas import flash_attention as jfa
from deeplearning_tpu_torch.ops import attention as tattn
from deeplearning_tpu_torch.ops import flash_attention as tfa
from deeplearning_tpu_torch.ops.kernels import build

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Force pallas interpret mode on CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _qkv(b, h, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, h, n, d)).astype(np.float32)
            for _ in range(3)]


SHAPES = [(197, 64), (49, 32), (17, 16)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_hb"])
def test_port_matches_jax(entry, n, d, causal):
    q, k, v = _qkv(1, 4, n, d, seed=n + d)
    want = getattr(jfa, entry)(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = getattr(tfa, entry)(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.shape == (1, 4, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,d", SHAPES)
def test_port_with_lse_matches_jax(n, d, causal):
    q, k, v = _qkv(2, 3, n, d, seed=7 * n + d)
    want_o, want_lse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal)
    got_o, got_lse = tfa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got_lse.shape == (2, 3, n) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_bnhd_layout_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = [rng.normal(size=(2, 49, 4, 32)).astype(np.float32)
               for _ in range(3)]
    want = jfa.flash_attention_bnhd(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention_bnhd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["flash", "flash_hb"])
def test_adapters_read_fused_qkv_views(name):
    """The ViT adapter path: q/k/v are strided slices of one fused qkv
    tensor (B, N, 3, H, D); the result equals the contiguous call."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 17, 3, 4, 16)).astype(
        np.float32))
    q, k, v = qkv.unbind(2)
    got = tattn.get_attn_fn(name)(q, k, v)
    want = tfa.flash_attention(*(x.transpose(1, 2).contiguous()
                                 for x in (q, k, v)))
    torch.testing.assert_close(got, want.transpose(1, 2), atol=0, rtol=0)


def test_cpu_path_never_builds_or_counts(monkeypatch):
    def refuse(name):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(build, "load", refuse)
    tfa.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 17, 16))
    tfa.flash_attention(q, k, v)
    tfa.flash_attention_hb(q, k, v)
    counts = tfa.launch_counts()
    assert counts["flash_attn_fwd"] == counts["flash_attn_fwd_hb"] == 0
    assert not any(counts.values())


def test_rejects_mismatched_inputs():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 17, 16))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :, :9], v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k.double(), v)


def test_head_block_rule_matches_jax():
    # flash_attention_hb halves head_block until it divides H
    assert [tfa._head_block(h, 4) for h in (12, 6, 3, 16)] == [4, 2, 1, 4]


def test_nvcc_command_targets_sm90a():
    src = build.CSRC_DIR / "flash_attn_fwd.cu"
    assert src.exists()
    cmd = build.nvcc_command(src, build.library_path(src))
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
    # the library name carries the source hash: an edit forces a rebuild
    assert build.library_path(src).parent == build.BUILD_DIR
    assert build.library_path(src).name.startswith("libflash_attn_fwd-")


def test_library_name_hashes_the_shared_headers(monkeypatch, tmp_path):
    # a source that includes csrc/*.cuh must rebuild when only a header
    # changes: every header is hashed into every library's name
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = tmp_path / "kernel.cu"
    src.write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    first = build.library_path(src)
    assert build.headers() == [header]
    assert build.library_path(src) == first          # stable when unchanged
    header.write_text("// v2\n")
    second = build.library_path(src)
    assert second != first and second.name.startswith("libkernel-")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.library_path(src) not in (first, second)


def test_bound_helpers():
    # ViT-B/16 layer at batch 32: ~119 MFLOP and ~1.22 MB an image
    assert tfa.flops(32, 12, 197, 64) / 32 == pytest.approx(119.2e6,
                                                            rel=1e-3)
    assert tfa.min_bytes(32, 12, 197, 64, 2) / 32 == pytest.approx(
        1.22e6, rel=1e-2)
