"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no card is
visible: a CUDA kernel has no CPU mode. On a machine with a card:

    python -m pytest tests/test_torch_kernels_card.py -m cuda -q

This file imports only torch and the port (no JAX), so it runs where the
JAX package is not installed.
"""

import math

import pytest
import torch

from deeplearning_tpu_torch.ops import flash_attention as fa
from deeplearning_tpu_torch.ops import nms as nms_ops
from deeplearning_tpu_torch.ops import window_attention as wa
from deeplearning_tpu_torch.ops import window_utils as wu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernel has no CPU mode")
    return torch.device("cuda")


# the tile edges of the kernels' 64-row query and key tiles, and ViT's N
# (197 at 224², 577 at 384²: a last key tile of one row)
EDGE_N = [1, 17, 49, 63, 64, 65, 128, 129, 197, 256, 300, 577]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("hpc", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("n", EDGE_N)
def test_flash_attn_fwd_matches_plain(cuda_device, n, d, causal, hpc,
                                      dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    q, k, v = (torch.randn(2, 4, n, d, device=cuda_device,
                           generator=g).to(dtype) for _ in range(3))
    before = fa.launch_counts()[fa.KERNEL_NAMES[hpc]]
    out, lse = fa._attention(q, k, v, sm_scale=None, causal=causal,
                             heads_per_cta=hpc)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts()[fa.KERNEL_NAMES[hpc]] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["flash", "flash_hb"])
@pytest.mark.parametrize("n,d", [(197, 64), (65, 32), (129, 128), (63, 16)])
def test_vit_adapter_fused_qkv_views_match_plain(cuda_device, attn, n, d):
    """The adapters hand the kernels q, k, v as strided views of one fused
    (B, N, 3, H, D) projection (k and v at byte offsets H*D*2 and 2*H*D*2)
    and take the output as a (B, N, H, D) tensor."""
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(3, n, 3, 12, d, device=cuda_device,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = get_attn_fn(attn)(q, k, v)
    ref = fa.flash_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)))[0].transpose(1, 2)
    torch.cuda.synchronize()
    assert out.shape == (3, n, 12, d)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_vit_adapter_reads_strided_qkv_and_raises_on_bad_input(cuda_device):
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(4, 197, 3, 12, 64, device=cuda_device,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = get_attn_fn("flash_hb")(q, k, v)
    ref = fa.flash_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)))[0].transpose(1, 2)
    torch.cuda.synchronize()
    assert out.shape == (4, 197, 12, 64)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    # D = 320, past the tensor-core kernels: the wide SIMT kernel runs it
    wide = torch.randn(1, 2, 8, 320, device=cuda_device, generator=g)
    torch.testing.assert_close(fa.flash_attention(wide, wide, wide),
                               fa.flash_attention_reference(wide, wide,
                                                            wide)[0],
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):          # dtype the kernel lacks
        fa.flash_attention(*(torch.zeros(1, 2, 8, 64, device=cuda_device,
                                         dtype=torch.float16)
                             for _ in range(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
def test_flash_attn_fwd_head_dim_80(cuda_device, n, causal, hpc, dtype, tol):
    """ViT-H/14's D = 80 runs zero-padded to the D = 128 kernel, with the
    scale of D = 80, from fused-qkv views into a (B, N, H, D) output."""
    _check_padded_fwd(cuda_device, 80, n, causal, hpc, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
def test_flash_attn_fwd_head_dim_160(cuda_device, n, causal, hpc, dtype,
                                     tol):
    """D = 160 runs zero-padded to the D = 256 kernel (two column CTAs a
    row block), with the scale of D = 160."""
    _check_padded_fwd(cuda_device, 160, n, causal, hpc, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
@pytest.mark.parametrize("d", [300, 320, 512])
def test_flash_attn_fwd_wide_head_dim(cuda_device, d, n, causal, hpc, dtype,
                                      tol):
    """D above 256 runs on the wide SIMT kernel (D = 300 zero-padded to
    320, with the scale of D = 300), from fused-qkv views."""
    _check_padded_fwd(cuda_device, d, n, causal, hpc, dtype, tol)


def _check_padded_fwd(cuda_device, d, n, causal, hpc, dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(2, n, 3, 4, d, device=cuda_device,
                      generator=g).to(dtype)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    before = fa.launch_counts()[fa.KERNEL_NAMES[hpc]]
    out = fa.attention_bnhd(*qkv.unbind(2), heads_per_cta=hpc,
                            causal=causal)
    _, lse = fa._attention(q, k, v, sm_scale=None, causal=causal,
                           heads_per_cta=hpc)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts()[fa.KERNEL_NAMES[hpc]] == before + 2
    assert out.shape == (2, n, 4, d)
    torch.testing.assert_close(out.transpose(1, 2).float(), ref.float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hpc", [1, 4])
def test_flash_attn_grid_past_65535_head_groups(cuda_device, hpc):
    """B*H/heads_per_cta = 65 536: the head groups are on grid.x, so the
    grid takes them; forward and both backward kernels match the plain
    version on every head (the last ones included)."""
    b, h, n, d = 65536 * hpc // 16, 16, 17, 16
    g = torch.Generator(device=cuda_device).manual_seed(hpc)
    q, k, v, do = (torch.randn(b, h, n, d, device=cuda_device,
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa._attention(q, k, v, sm_scale=None, causal=False,
                             heads_per_cta=hpc)
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    got = fa._attention_bwd(q, k, v, ref, ref_lse, do, sm_scale=None,
                            causal=False, heads_per_cta=hpc)
    want = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert _close(x, w) and _close(x[-1], w[-1])


def _bwd_inputs(device, b, h, n, d, dtype, causal, seed=0):
    """Fused-qkv slices (the training layout), the forward's O and LSE
    from the plain version, and a random dO."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, device=device, generator=g).to(dtype)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    do = torch.randn(b, n, h, d, device=device,
                     generator=g).to(dtype).transpose(1, 2)
    return q, k, v, o, lse, do


def _close(got, want, rtol=1e-2, floor=1e-4):
    """Norm-relative error within ``rtol``, with an RMS floor of ``floor``
    for gradients that are exactly zero in the plain version (N = 1: one
    key, so dS = P (dP - delta) = 0 up to summation order)."""
    err = (got.float() - want.float()).norm().item()
    return err <= rtol * want.float().norm().item() + floor * want.numel() ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hpc", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("n", EDGE_N)
def test_flash_attn_bwd_matches_plain(cuda_device, n, d, causal, hpc, dtype):
    """dQ, dK, dV of both backward kernels against the plain version:
    norm-relative 1e-2 in bf16 (P and dS are rounded to bf16 before their
    products, as on the TPU; RMS floor 1e-4), max-abs 1e-4 in float32."""
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 2, 4, n, d, dtype, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    before = fa.launch_counts()
    got = fa._attention_bwd(q, k, v, o, lse, do, sm_scale=None,
                            causal=causal, heads_per_cta=hpc)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    for which in ("dq", "dkv"):
        name = fa.BWD_KERNEL_NAMES[which][hpc]
        assert after[name] == before[name] + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        if dtype == torch.bfloat16:
            assert _close(g, w)
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
def test_flash_attn_bwd_head_dim_80(cuda_device, n, causal, hpc, dtype):
    """D = 80 through the D = 128 backward kernels, zero-padded, with the
    scale of D = 80 (bf16: the dQ kernel computes delta from the padded
    O), from fused-qkv views, as test_flash_attn_bwd_matches_plain."""
    _check_padded_bwd(cuda_device, 80, n, causal, hpc, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
def test_flash_attn_bwd_head_dim_160(cuda_device, n, causal, hpc, dtype):
    """D = 160 through the D = 256 backward kernels (two column CTAs a
    row block), zero-padded, with the scale of D = 160."""
    _check_padded_bwd(cuda_device, 160, n, causal, hpc, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hpc", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 65, 257])
@pytest.mark.parametrize("d", [300, 320, 512])
def test_flash_attn_bwd_wide_head_dim(cuda_device, d, n, causal, hpc, dtype):
    """dQ, dK, dV above D = 256 through the wide SIMT kernels (bf16: the
    dQ kernel sums delta from O over all D columns)."""
    _check_padded_bwd(cuda_device, d, n, causal, hpc, dtype)


def _check_padded_bwd(cuda_device, d, n, causal, hpc, dtype):
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 2, 4, n, d, dtype,
                                      causal, seed=n)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    got = fa._attention_bwd(q, k, v, o, lse, do, sm_scale=None,
                            causal=causal, heads_per_cta=hpc)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        if dtype == torch.bfloat16:
            assert _close(g, w)
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hpc", [1, 4])
def test_dq_kernel_writes_delta(cuda_device, hpc):
    """Given O, the bf16 dQ kernel writes rowsum(dO * O) for the dK/dV
    kernel; rows past N are left alone."""
    b, h, n, d = 2, 4, 197, 64
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, b, h, n, d,
                                      torch.bfloat16, False, seed=7)
    delta = torch.full((b * h, n), float("nan"), device=cuda_device)
    grads = [torch.empty_like(q) for _ in range(3)]
    fa._launch_bwd(q, k, v, do, lse, delta, *grads, d ** -0.5, False, hpc,
                   kernels=("dq",), o=o)
    want = (do.float() * o.float()).sum(-1).reshape(b * h, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("n", [1, 49, 64, 65, 113, 197])
def test_flash_chunk_grads_float32_out(cuda_device, n, d, dtype):
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 2, 4, n, d, dtype,
                                      False, seed=3)
    delta = (do.float() * o.float()).sum(-1)
    got = fa.flash_chunk_grads(q, k, v, do, lse, delta)
    want = fa.flash_attention_bwd_reference(q, k, v, None, lse, do,
                                            delta=delta,
                                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if dtype == torch.bfloat16:
            assert _close(g, w)
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_vit_adapter_trains_through_the_kernels(cuda_device):
    """Autograd through the flash_hb adapter on fused-qkv views: one
    forward and one dQ, one dK/dV launch; gradients match the plain
    version's autograd."""
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(4, 197, 3, 12, 64, device=cuda_device,
                      generator=g).to(torch.bfloat16).requires_grad_()
    q, k, v = qkv.unbind(2)
    before = fa.launch_counts()
    out = get_attn_fn("flash_hb")(q, k, v)
    dout = torch.randn_like(out)
    (grad,) = torch.autograd.grad(out, qkv, dout)
    after = fa.launch_counts()
    assert after["flash_attn_fwd_hb"] == before["flash_attn_fwd_hb"] + 1
    assert after["flash_attn_bwd_dq_hb"] == before["flash_attn_bwd_dq_hb"] + 1
    assert after["flash_attn_bwd_dkv_hb"] == before["flash_attn_bwd_dkv_hb"] + 1
    ref = fa.flash_attention_reference(
        *(x.transpose(1, 2) for x in qkv.float().unbind(2)))[0].transpose(1, 2)
    (want,) = torch.autograd.grad(ref, qkv, dout.float())
    torch.cuda.synchronize()
    assert _close(grad, want)


@pytest.fixture
def one_rank_mesh(cuda_device):
    """A world of one (gloo) and its mesh on the card: the ring and
    Ulysses over one seq rank issue no collective."""
    import torch.distributed as dist
    from deeplearning_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                      initialize_distributed)
    started = initialize_distributed(device="cpu")
    try:
        yield build_mesh(MeshConfig(data=1, seq=1), device=cuda_device)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [113, 197])
@pytest.mark.parametrize("flavor", ["ring", "ulysses"])
def test_seq_parallel_on_k1_matches_plain(one_rank_mesh, flavor, n, dtype):
    """The ring and Ulysses on K1 (use_flash / the flash inner attention)
    at ViT-B/16's chunk lengths (113 = 226 / 2 at 240², 197 at 224²):
    one forward, one dQ and one dK/dV launch a call, and the output and
    dq/dk/dv against the same flavor's plain path (bf16 norm-relative
    1e-2, float32 max-abs 1e-4)."""
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attention)
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attention
    mesh = one_rank_mesh
    q, k, v, _, _, do = _bwd_inputs(mesh.device, 2, 12, n, 64, dtype, False,
                                    seed=n)
    if flavor == "ring":
        kernel, plain = (make_ring_attention(mesh, use_flash=True),
                         make_ring_attention(mesh))
    else:
        kernel, plain = (make_ulysses_attention(mesh,
                                                attn_fn=fa.flash_attention),
                         make_ulysses_attention(mesh))

    def run(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*xs)
        return out, torch.autograd.grad(out, xs, do)
    before = fa.launch_counts()
    got = run(kernel)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    want = run(plain)
    torch.cuda.synchronize()
    assert fa.launch_counts() == after      # the plain path launches none
    for g, w in zip((got[0],) + got[1], (want[0],) + want[1]):
        assert g.dtype == dtype and torch.isfinite(g).all()
        if dtype == torch.bfloat16:
            assert _close(g, w)
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("attn", ["flash", "flash_hb"])
@pytest.mark.parametrize("h,n", [(6, 197), (3, 197), (6, 113)])
def test_tensor_parallel_heads_on_k1_match_plain(cuda_device, h, n, attn,
                                                 dtype):
    """K1 through the ViT's adapters at the local heads of ViT-B/16's
    Megatron blocks: 6 heads a rank at model 2, 3 at model 4 (flash_hb
    falls to one head a CTA), 6 heads of 113-token ring chunks. q, k, v
    are strided views of the rank's fused qkv slice; one forward, one dQ
    and one dK/dV launch (the head block's kernels), the output and the
    gradients against the plain version (bf16 norm-relative 1e-2,
    float32 max-abs 1e-4)."""
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    g = torch.Generator(device=cuda_device).manual_seed(h * n)
    qkv = torch.randn(2, n, 3, h, 64, device=cuda_device,
                      generator=g).to(dtype).requires_grad_()
    dout = torch.randn(2, n, h, 64, device=cuda_device, generator=g).to(dtype)
    hpc = fa._head_block(h, 4) if attn == "flash_hb" else 1
    before = fa.launch_counts()
    out = get_attn_fn(attn)(*qkv.unbind(2))
    (grad,) = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    names = [fa.KERNEL_NAMES[hpc], fa.BWD_KERNEL_NAMES["dq"][hpc],
             fa.BWD_KERNEL_NAMES["dkv"][hpc]]
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict.fromkeys(names, 1)
    ref_in = qkv.detach().float().requires_grad_()
    ref = fa.flash_attention_reference(
        *(x.transpose(1, 2) for x in ref_in.unbind(2)))[0].transpose(1, 2)
    (want,) = torch.autograd.grad(ref, ref_in, dout.float())
    for got, w in ((out, ref), (grad, want)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        if dtype == torch.bfloat16:
            assert _close(got, w)
        else:
            torch.testing.assert_close(got, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_k1_launches_from_a_fresh_thread(cuda_device):
    """The first K1 launch of a thread that has run no CUDA work yet (as
    autograd's worker, before its first kernel) still encodes its tensor
    maps: the forward and both backward kernels, from fresh threads."""
    import threading
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 2, 12, 197, 64,
                                      torch.bfloat16, False, seed=9)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    ref = fa.flash_attention_reference(q, k, v)[0]
    got, errors = {}, []

    def run(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc}")
    for name, fn in (
            ("fwd", lambda: fa._attention(q, k, v, sm_scale=None,
                                          causal=False, heads_per_cta=4)[0]),
            ("bwd", lambda: fa._attention_bwd(q, k, v, o, lse, do,
                                              sm_scale=None, causal=False,
                                              heads_per_cta=4))):
        t = threading.Thread(target=run, args=(name, fn))
        t.start()
        t.join()
    assert not errors, errors
    torch.testing.assert_close(got["fwd"].float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert all(_close(g, w) for g, w in zip(got["bwd"], want))


# ---------------------------------------------- fused window attention (K2)
def _window_inputs(device, bw, n, heads, d, dtype, nw, diag=False, seed=0):
    """qkv as strided slices of one (BW, N, 3C) projection, the bias, and
    a shift mask of nW windows (or None for nw == 0); ``diag``: a mask of
    whole rows of -1e9 except the diagonal."""
    g = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn(bw, n, 3 * heads * d, device=device, generator=g)
    qkv = proj.to(dtype).view(bw, n, 3, heads, d)
    bias = torch.randn(heads, n, n, device=device, generator=g)
    mask = None
    if nw:
        side = int(round(n ** 0.5))
        if diag:
            mask = torch.full((nw, n, n), -1e9, device=device)
            mask[:, torch.arange(n), torch.arange(n)] = 0.0
        else:
            # the squarest grid of nW windows
            rows = max(r for r in range(1, nw + 1)
                       if nw % r == 0 and r * r <= nw)
            mask = torch.from_numpy(wu.shift_window_mask(
                rows * side, nw // rows * side, side, side // 2)).to(device)
    return qkv, bias, mask


WINDOW_CASES = [  # bw, n, heads, d, nW, windows_per_block, diagonal mask
    (2048, 49, 3, 32, 64, 8, False),     # Swin-T stages at batch 32
    (512, 49, 6, 32, 16, 8, False),
    (128, 49, 12, 32, 4, 8, False),
    (32, 49, 24, 32, 0, 8, False),
    (24, 9, 4, 32, 4, 8, False),         # N = 9
    (16, 16, 4, 32, 4, 8, False),        # N = 16
    (64, 49, 4, 16, 4, 8, False),        # d = 16
    (64, 49, 2, 64, 16, 8, False),       # d = 64
    (36, 49, 3, 32, 6, 4, False),        # nW not a multiple of wb
    (16, 49, 3, 32, 8, 8, True),         # whole rows masked but the diagonal
    (10, 64, 2, 32, 0, 3, False),        # an 8x8 window, ragged last block
    (64, 49, 2, 128, 4, 8, False),       # d = 128
    (32, 49, 3, 24, 4, 8, False),        # d = 24, padded to 32
    (8, 144, 2, 24, 4, 4, False),        # window 12: N = 144, two tiles
    (8, 144, 2, 128, 4, 3, False),       # N = 144, d = 128
    (8, 144, 3, 32, 4, 8, True),         # N = 144, rows masked but diagonal
    (4, 81, 2, 48, 0, 2, False),         # window 9, unmasked, d = 48
    (320, 49, 3, 32, 64, 3, False),      # nW = 64, 5 images, 3 a CTA
    (8, 49, 2, 160, 4, 3, False),        # d = 160: the wide kernel at 192
    (8, 49, 2, 256, 4, 8, False),        # d = 256, two column CTAs
    (16, 49, 3, 160, 8, 8, True),        # wide, rows masked but diagonal
    (8, 144, 2, 160, 4, 3, False),       # wide, N = 144: two key tiles
    (8, 144, 3, 256, 0, 2, False),       # wide, N = 144, unmasked
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("bw,n,heads,d,nw,wb,diag", WINDOW_CASES)
def test_window_attn_fwd_matches_plain(cuda_device, bw, n, heads, d, nw, wb,
                                       diag, dtype, tol):
    qkv, bias, mask = _window_inputs(cuda_device, bw, n, heads, d, dtype, nw,
                                     diag)
    before = wa.launch_counts()[wa.KERNEL_NAME]
    out = wa.window_attention(qkv, bias, mask, windows_per_block=wb)
    ref = wa.window_attention_plain(qkv, bias, mask)
    torch.cuda.synchronize()
    assert wa.launch_counts()[wa.KERNEL_NAME] == before + 1
    assert out.shape == (bw, n, heads * d) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_window_attn_trains_through_the_reference(cuda_device):
    """The checkpointed form: forward through the kernel, gradients those
    of the unfused reference."""
    qkv, bias, mask = _window_inputs(cuda_device, 64, 49, 3, 32,
                                     torch.float32, 4, seed=2)
    a, b = qkv.detach().requires_grad_(), bias.requires_grad_()
    before = wa.launch_counts()[wa.KERNEL_NAME]
    out = wa.window_attention_checkpointed(a, b, mask)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (a, b), g)
    want = torch.autograd.grad(wu.windowed_attention_reference(a, b, mask),
                               (a, b), g)
    torch.cuda.synchronize()
    assert wa.launch_counts()[wa.KERNEL_NAME] == before + 1
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_window_attn_raises_on_what_the_kernel_does_not_take(cuda_device):
    def call(n=49, d=32, dtype=torch.bfloat16):
        qkv = torch.zeros(4, n, 3, 2, d, device=cuda_device, dtype=dtype)
        return wa.window_attention(qkv, torch.zeros(2, n, n,
                                                    device=cuda_device))
    out = call(d=160)                     # the wide SIMT kernel
    assert out.shape == (4, 49, 320) and not out.float().any()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(dtype=torch.float16)
    assert call(n=81, d=48).shape == (4, 81, 96)   # any N, a padded d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_window_attn_reads_strided_qkv_slices(cuda_device, dtype, tol):
    """qkv as a slice of a wider projection (rows 3C + 32 apart) and every
    second window of it; the result does not depend on windows_per_block
    (bitwise)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    bw, n, heads, d = 64, 49, 3, 32
    proj = torch.randn(2 * bw, n, 3 * heads * d + 32, device=cuda_device,
                       generator=g).to(dtype)
    qkv = proj[::2, :, :3 * heads * d].unflatten(-1, (3, heads, d))
    assert not qkv.is_contiguous()
    bias = torch.randn(heads, n, n, device=cuda_device, generator=g)
    mask = torch.from_numpy(wu.shift_window_mask(28, 28, 7, 3)).to(
        cuda_device)
    ref = wa.window_attention_plain(qkv, bias, mask)
    outs = [wa.window_attention(qkv, bias, mask, windows_per_block=wpb)
            for wpb in (1, 3, 16)]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                               rtol=tol)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.cuda
def test_window_attn_launches_from_a_fresh_thread(cuda_device):
    """K2's first launch from a thread that has run no CUDA work yet still
    encodes its tensor maps (as test_k1_launches_from_a_fresh_thread)."""
    import threading
    qkv, bias, mask = _window_inputs(cuda_device, 128, 49, 3, 32,
                                     torch.bfloat16, 4, seed=6)
    ref = wa.window_attention_plain(qkv, bias, mask)
    got, errors = [], []

    def run():
        try:
            got.append(wa.window_attention(qkv, bias, mask))
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(str(exc))
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    torch.testing.assert_close(got[0].float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


# ----------------------------------------------------- blocked NMS (K3)
def _nms_cases(device, cases, n, span=64.0, wh_max=24.0, nan_frac=0.0,
               seed=0):
    """Overlap-heavy boxes (cases, n, 4) and scores (cases, n), the JAX
    tests' recipe, made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    ctr = torch.rand(cases, n, 2, device=device, generator=g) * span
    wh = 2.0 + torch.rand(cases, n, 2, device=device,
                          generator=g) * (wh_max - 2.0)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.rand(cases, n, device=device, generator=g)
    if nan_frac:
        nan = torch.rand(cases, n, device=device, generator=g) < nan_frac
        scores = torch.where(nan, torch.full_like(scores, float("nan")),
                             scores)
    return boxes, scores


def _same_keeps(ref, got):
    (i1, v1), (i2, v2) = ref, got
    return torch.equal(v1, v2) and bool(((i1 == i2) | ~v1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,classes,th,st,mo", [
    (8, 4_507, 0, 0.7, -1e8, 256),        # Faster R-CNN's RPN at 800²
    (8, 5_120, 20, 0.5, 0.05, 100),       # its box stage, 20 classes
    (4, 25_200, 80, 0.45, 0.0, 100),      # YOLOv5-S at 640², 80 classes
    (8, 1_000, 20, 0.5, 0.0, 100)])       # RetinaNet / FCOS top-1 000
def test_nms_kernel_at_the_detectors_shapes(cuda_device, b, n, classes, th,
                                            st, mo):
    """K3 at the served detectors' candidate sets, class-aware where they
    are (offsets up to 80 × (max coordinate + 1)), against the plain
    blocked sweep and, on the first image, the greedy oracle."""
    boxes, scores = _nms_cases(cuda_device, b, n, span=640.0, wh_max=160.0,
                               seed=n)
    if classes:
        cls = torch.arange(n, device=cuda_device).remainder(classes)[
            None].expand(b, -1)
        def call(impl, k=b):
            return nms_ops.batched_nms(boxes[:k], scores[:k], cls[:k], th,
                                       mo, st, impl=impl)
    else:
        def call(impl, k=b):
            return nms_ops.nms(boxes[:k], scores[:k], th, mo, st, impl=impl)
    before = nms_ops.launch_counts()["nms_greedy_sweep"]
    got = call("auto")
    torch.cuda.synchronize()
    assert nms_ops.launch_counts()["nms_greedy_sweep"] == before + 1
    assert _same_keeps(call("blocked"), got)
    assert _same_keeps(call("greedy", 1), tuple(x[:1] for x in got))
    assert int(got[1].sum(1).min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("th,st,mo", [(0.5, float("-inf"), 64),
                                      (0.3, 0.25, 32), (0.7, 0.5, 16),
                                      (0.45, 0.05, 100)])
@pytest.mark.parametrize("n", [200, 1000])
def test_nms_kernels_match_plain(cuda_device, n, th, st, mo):
    """K3 (both kernels, one launch each a batch) against the plain blocked
    sweep and, at n = 200, the greedy oracle: equal keep sets."""
    boxes, scores = _nms_cases(cuda_device, 64, n,
                               nan_frac=0.02 if mo == 64 else 0.0)
    before = nms_ops.launch_counts()
    got = nms_ops.nms(boxes, scores, th, mo, st, impl="auto")
    plain = nms_ops.nms(boxes, scores, th, mo, st, impl="blocked",
                        block_size=64)
    torch.cuda.synchronize()
    after = nms_ops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in nms_ops.KERNEL_NAMES)
    assert _same_keeps(plain, got)
    if n == 200:
        assert _same_keeps(nms_ops.nms(boxes, scores, th, mo, st,
                                       impl="greedy"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("th,mo,wh_max", [(0.5, 400, 12.0),
                                          (0.7, 5000, 6.0)])
def test_nms_kernel_max_out_past_n_live(cuda_device, th, mo, wh_max):
    """max_out >= n_live, over a batch whose images have different live
    counts (score thresholds cut each at another place), NaN and -inf
    scores among them: the walk runs to each image's last live candidate
    and the keep sets equal the plain sweep's and the greedy oracle's."""
    boxes, scores = _nms_cases(cuda_device, 6, 3000, span=400.0,
                               wh_max=wh_max, nan_frac=0.01, seed=mo)
    scores[1, :50] = float("-inf")
    cut = torch.linspace(0.0, 0.9, 6, device=cuda_device)[:, None]
    scores = torch.where(scores < cut, torch.full_like(scores, -math.inf),
                         scores)                  # NaN scores stay NaN
    live = [int(x) for x in (scores > -math.inf).sum(dim=1)]
    assert len(set(live)) == 6 and min(live) < mo
    before = nms_ops.launch_counts()
    got = nms_ops.nms(boxes, scores, th, mo, impl="auto")
    plain = nms_ops.nms(boxes, scores, th, mo, impl="blocked",
                        block_size=64)
    torch.cuda.synchronize()
    assert nms_ops.launch_counts()["nms_greedy_sweep"] == \
        before["nms_greedy_sweep"] + 1
    assert _same_keeps(plain, got)
    assert _same_keeps(nms_ops.nms(boxes[:2], scores[:2], th, mo,
                                   impl="greedy"),
                       tuple(x[:2] for x in got))


@pytest.mark.cuda
def test_nms_kernel_kept_list_past_shared_memory(cuda_device):
    """12 000 keeps an image, past the 10 240 kept boxes the kernel holds in
    shared memory, and 1 000 copies that only boxes kept past it suppress:
    keep sets equal the plain sweep's."""
    from deeplearning_tpu_torch.ops.nms_bench import past_shared_memory
    g = torch.Generator(device=cuda_device).manual_seed(11)
    boxes, scores = past_shared_memory(g, 2)
    mo = boxes.shape[1]
    got = nms_ops.nms(boxes, scores, 0.5, mo, impl="auto")
    plain = nms_ops.nms(boxes, scores, 0.5, mo, impl="blocked", block_size=64)
    torch.cuda.synchronize()
    assert got[1].sum(dim=1).tolist() == [12_000, 12_000]
    assert _same_keeps(plain, got)


@pytest.mark.cuda
def test_nms_kernels_edge_cases(cuda_device):
    boxes = torch.tensor([[10., 10., 20., 20.]],
                         device=cuda_device).repeat(64, 1)
    scores = torch.linspace(0.1, 0.9, 64, device=cuda_device)
    idx, valid = nms_ops.nms(boxes, scores, 0.5, 10, impl="pallas")
    assert int(valid.sum()) == 1 and int(idx[0]) == 63  # identical boxes
    for n, mo in ((1, 5), (7, 32), (63, 16), (65, 16), (130, 200)):
        b, s = _nms_cases(cuda_device, 8, n, span=80.0, seed=n)
        s[:, ::4] = s[:, :1].clone()                      # tied scores
        assert _same_keeps(nms_ops.nms(b, s, 0.5, mo, impl="greedy"),
                           nms_ops.nms(b, s, 0.5, mo, impl="auto"))
    # class-aware at 640² coordinates with 80 classes
    b, s = _nms_cases(cuda_device, 4, 3000, span=640.0, wh_max=120.0)
    cls = torch.randint(0, 80, (4, 3000), device=cuda_device,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(3))
    assert _same_keeps(nms_ops.batched_nms(b, s, cls, 0.65, 100,
                                           impl="blocked"),
                       nms_ops.batched_nms(b, s, cls, 0.65, 100,
                                           impl="auto"))
    with pytest.raises(ValueError, match="float32"):
        nms_ops.nms_sweep(b.half(), s > 0, 0.5, 10)
    with pytest.raises(ValueError, match="multiple of 64"):
        nms_ops.nms_sweep(b[:, :100], s[:, :100] > 0, 0.5, 10)


# ------------------------------------------- the feed and the Trainer loop
def _digest(x):
    """Exact, order-free digest of a float32 tensor or array: the int64 sum
    of its bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).to(torch.int64).sum()
    return int(x.view("int32").astype("int64").sum())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_hands_batches_over_safely(cuda_device, depth):
    """Batches copied on the prefetcher's side stream are read on the
    consumer's stream behind queued work, then dropped (the allocator may
    reuse them): every read sees its host batch, under sync debug mode
    "error" (the feed makes no synchronising call)."""
    import numpy as np
    from deeplearning_tpu_torch.data import (ArraySource, DataLoader,
                                             DevicePrefetcher)
    rng = np.random.default_rng(depth)
    images = rng.normal(size=(96, 64, 64, 3)).astype(np.float32)
    source = ArraySource(image=images,
                         label=np.arange(96, dtype=np.int32))
    pf = DevicePrefetcher(DataLoader(source, 16, seed=1, device=cuda_device),
                          depth=depth)
    busy = torch.randn(2048, 2048, device=cuda_device)
    digests, labels = [], []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in pf:
            for _ in range(4):
                torch.mm(busy, busy)
            digests.append(_digest(batch["image"]))
            labels.append(batch["label"].clone())
            del batch
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = list(DataLoader(source, 16, seed=1))
    assert [d.item() for d in digests] == [_digest(h["image"]) for h in host]
    assert all(torch.equal(got.cpu(), torch.from_numpy(h["label"]))
               for got, h in zip(labels, host))
    assert pf.stats()["batches_fed"] == 6


@pytest.mark.cuda
def test_prefetch_to_device_equals_the_host_batches(cuda_device):
    """``prefetch_to_device`` pins each host leaf and copies it without
    blocking on the current stream, two batches ahead; read behind
    queued work, every batch equals its host batch bit for bit."""
    import numpy as np
    from deeplearning_tpu_torch.data import (ArraySource, DataLoader,
                                             prefetch_to_device)
    rng = np.random.default_rng(7)
    source = ArraySource(
        image=rng.normal(size=(96, 64, 64, 3)).astype(np.float32),
        label=np.arange(96, dtype=np.int32))
    host = DataLoader(source, 16, seed=1)
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for batch in prefetch_to_device(host, 2, device=cuda_device):
        for _ in range(4):
            torch.mm(busy, busy)
        assert all(v.device.type == "cuda" for v in batch.values())
        got.append({k: v.cpu() for k, v in batch.items()})
    want = list(host)
    assert len(got) == len(want) == 6
    assert all(torch.equal(g[k], torch.from_numpy(h[k]))
               for g, h in zip(got, want) for k in h)


@pytest.mark.cuda
@pytest.mark.parametrize("switch_prob", [0.0, 1.0])
def test_mixup_cutmix_stays_on_the_card(cuda_device, switch_prob):
    """The train CLI's mixup path draws from a CUDA generator and makes no
    synchronising call; one seed gives one batch, rows sum to 1."""
    from deeplearning_tpu_torch.data.mixup import mixup_cutmix
    g = torch.Generator(device=cuda_device).manual_seed(3)
    batch = {"image": torch.randn(8, 32, 32, 3, device=cuda_device,
                                  generator=g),
             "label": torch.randint(0, 10, (8,), device=cuda_device,
                                    generator=g, dtype=torch.int32)}
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            outs.append(mixup_cutmix(
                batch, torch.Generator(device=cuda_device).manual_seed(5),
                10, switch_prob=switch_prob))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(outs[0]["image"], outs[1]["image"])
    torch.testing.assert_close(outs[0]["label"].sum(-1),
                               torch.ones(8, device=cuda_device))


@pytest.mark.cuda
def test_trainer_loop_makes_no_sync_between_log_points(cuda_device):
    """A small ViT through the train CLI's ``build`` on the card: every step
    of two epochs runs under sync debug mode "error", lifted only inside
    the lagged metric fetches (the designed sync a log point); the
    Trainer's losses equal a hand loop of its step over the same batches."""
    import dataclasses
    from deeplearning_tpu_torch.obs import flight
    from deeplearning_tpu_torch.train import __main__ as cli
    cfg = cli.Config(
        model=cli.ModelCfg(name="vit_micro_patch4_56", num_classes=10),
        data=cli.DataCfg(image_size=56, channels=3, n_train=64,
                         global_batch=16),
        optim=cli.OptimCfg(name="adamw", lr=1e-3, weight_decay=0.05),
        train=cli.TrainCfg(epochs=2, label_smoothing=0.1))
    trainer = cli.build(cfg, obs=True)
    armed = {"on": False, "steps": 0}

    def arm(on):
        armed["on"] = on
        torch.cuda.set_sync_debug_mode("error" if on else 0)

    def unguarded(fn):
        def call():
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("error" if armed["on"] else 0)
        return call
    trainer.callbacks.register("before_epoch", lambda t: arm(True))
    trainer.callbacks.register("after_epoch", lambda t: arm(False))
    trainer.callbacks.register(
        "after_iter", lambda t, metrics: armed.__setitem__(
            "steps", armed["steps"] + int(armed["on"])))
    for name in ("poll", "drain"):
        setattr(trainer.deferred, name,
                unguarded(getattr(trainer.deferred, name)))
    flight.get_recorder().clear()
    try:
        trainer.train()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert armed["steps"] == 8
    logged = [e["metrics"]["loss"]
              for e in flight.get_recorder().events("step")]
    ref = cli.build(dataclasses.replace(cfg))
    hand = []
    for epoch in range(2):
        ref.train_loader.set_epoch(epoch)
        for batch in ref.train_loader:
            ref.state, m = ref.train_step(ref.state, batch, ref.rng)
            hand.append(m["loss"].item())
    assert logged == hand


def _micro_trainer(strict, device="cuda", **kw):
    from deeplearning_tpu_torch.train import __main__ as cli
    cfg = cli.Config(
        model=cli.ModelCfg(name="vit_micro_patch4_56", num_classes=10),
        data=cli.DataCfg(image_size=56, channels=3, n_train=64,
                         global_batch=16),
        optim=cli.OptimCfg(name="adamw", lr=1e-3, weight_decay=0.05),
        train=cli.TrainCfg(epochs=1, label_smoothing=0.1, strict=strict,
                           device=device))
    return cli.build(cfg, **kw)


@pytest.mark.cuda
def test_strict_section_raises_on_a_card_fetch_not_on_the_lagged_one(
        cuda_device):
    """Inside a strict section ``.item()`` of a card tensor raises; a
    Trainer with ``strict="transfers"`` runs its epoch (the lagged fetch
    sits outside the sections) with one section a step."""
    from deeplearning_tpu_torch.analysis import strict
    x = torch.ones(4, device=cuda_device)
    assert strict.guard_enforced() and strict.guard_enforced(
        "host_to_device")
    with pytest.raises(RuntimeError):
        with strict.strict_section(frozenset({"transfers"})):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0   # restored on exit
    trainer = _micro_trainer("transfers")
    trainer.train()
    assert trainer.strict_sections == 4 and trainer.state.step == 4
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_async_snapshot_survives_the_next_in_place_step(cuda_device,
                                                        tmp_path):
    """``save`` queues the device copy before the next optimizer step is
    queued: the written step equals the state at its own step, though the
    parameters were updated in place while the writer ran; under the sync
    guard nothing in ``save`` or the writer synchronises."""
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    trainer = _micro_trainer("")
    state, step_fn = trainer.state, trainer.train_step
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in next(
        iter(trainer.train_loader.loader.host_batches())).items()}
    state, _ = step_fn(state, batch, trainer.rng)
    want = {n: p.detach().clone() for n, p in state.params.items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        mgr.save(state.step, state)
        for _ in range(3):
            state, _ = step_fn(state, batch, trainer.rng)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    mgr.close()
    assert mgr.verify_step(1)
    got = torch.load(str(tmp_path / "1" / "state.pt"))
    assert got["step"] == 1 and set(got["params"]) == set(want)
    assert all(torch.equal(got["params"][n].to(cuda_device), p)
               for n, p in want.items())
    assert any(not torch.equal(state.params[n], p) for n, p in want.items())


@pytest.mark.cuda
def test_nan_hook_under_transfers_and_nans_keeps_the_guard(cuda_device):
    """``strict="transfers,nans"``: the NaN hook lifts the sync guard for
    its own check, so a clean epoch runs; a NaN raises
    ``FloatingPointError`` naming the module, not the guard's error."""
    from deeplearning_tpu_torch.analysis import strict
    trainer = _micro_trainer("transfers,nans")
    trainer.train()
    assert trainer.state.step == 4 and trainer.strict_sections == 4
    model = trainer.state.model
    with torch.no_grad():
        model.norm.weight[0] = float("nan")
    x = torch.randn(2, 56, 56, 3, device=cuda_device)
    with strict.debug_nans(model=model):
        with strict.strict_section(frozenset({"transfers"})):
            with pytest.raises(FloatingPointError, match="'norm'"):
                model(x)
    assert torch.cuda.get_sync_debug_mode() == 0


# ------------------------------------------- one-stage detection training
def _det_loss_inputs(seed, family, size=320, classes=80, b=4, g=20):
    """Seeded raw head outputs and padded gts (numpy), as the CPU would
    see them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if family == "yolox":
        from deeplearning_tpu_torch.models.detection.yolox import yolox_grid
        centers, strides = yolox_grid((size, size))
        raw = {"raw": rng.normal(0, 1, (b, len(strides), 5 + classes))}
        consts = {"centers": centers, "strides": strides}
    else:
        from deeplearning_tpu_torch.models.detection.retinanet import (
            retinanet_anchors)
        anchors = retinanet_anchors((size, size))
        raw = {"cls_logits": rng.normal(-2, 1.5, (b, len(anchors), classes)),
               "bbox_deltas": rng.normal(0, 0.5, (b, len(anchors), 4))}
        consts = {"anchors": anchors}
    wh = rng.uniform(8, size / 2, (b, g, 2))
    xy = rng.uniform(0, size / 2, (b, g, 2))
    gts = {"boxes": np.concatenate([xy, xy + wh], -1),
           "labels": rng.integers(0, classes, (b, g)),
           "valid": np.arange(g)[None] < rng.integers(1, g, (b, 1))}
    as_t = {**{k: v.astype(np.float32) for k, v in raw.items()},
            **{k: np.asarray(v, np.float32) for k, v in consts.items()},
            **gts, "boxes": gts["boxes"].astype(np.float32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in as_t.items()}


def _det_loss(family, t):
    from deeplearning_tpu_torch.models.detection import retinanet, yolox
    if family == "yolox":
        assign = yolox.simota_assign(
            yolox.decode_outputs(t["raw"], t["centers"], t["strides"]),
            t["centers"], t["strides"], t["boxes"], t["labels"],
            t["valid"], 80)
        out = yolox.yolox_loss(t["raw"], t["centers"], t["strides"],
                               t["boxes"], t["labels"], t["valid"], 80,
                               use_l1=True)
        return out, assign
    out = retinanet.retinanet_loss(
        {"cls_logits": t["cls_logits"], "bbox_deltas": t["bbox_deltas"]},
        t["anchors"], t["boxes"], t["labels"], t["valid"])
    return out, {}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["yolox", "retinanet"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detection_losses_on_the_card_equal_the_cpu(cuda_device, family,
                                                    seed):
    """The same raw outputs on the card and on the CPU: SimOTA's
    assignment exact, every loss term within 1e-5 relative."""
    cpu = _det_loss_inputs(seed, family)
    want, want_assign = _det_loss(family, cpu)
    got, got_assign = _det_loss(family, {k: v.to(cuda_device)
                                         for k, v in cpu.items()})
    torch.cuda.synchronize()
    for k in want_assign:
        assert torch.equal(got_assign[k].cpu(), want_assign[k]) or (
            k == "matched_iou" and torch.allclose(
                got_assign[k].cpu(), want_assign[k], atol=1e-6)), k
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(abs(float(v)),
                                                           1e-12), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolox_nano", "retinanet_resnet18_fpn",
                                  "fcos_resnet18_fpn",
                                  "fasterrcnn_resnet18_fpn", "yolov5s"])
def test_detection_step_never_syncs(cuda_device, name):
    """``build_task``'s loss through ``make_train_step`` with Adam and the
    clip, the batch resident on the card and resized there to a new
    bucket: steps under sync debug mode "error" raise nothing."""
    import numpy as np
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.models.detection.predict import head_classes
    from deeplearning_tpu_torch.train.detection import (build_task,
                                                        synthetic_boxes)
    from deeplearning_tpu_torch.train.multiscale import (
        resize_detection_batch)
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.state import TrainState
    from deeplearning_tpu_torch.train.steps import make_train_step
    model, _ = hub.load(name, num_classes=head_classes(name, 3), seed=0,
                        device=cuda_device)
    loss_fn, _ = build_task(model, name, 3, 0.3)
    tx = build_optimizer("adam", 1e-3, clip_grad_norm=1.0,
                         params=dict(model.named_parameters()))
    state = TrainState.create(model=model, tx=tx)
    step = make_train_step(loss_fn, device=cuda_device)
    arrays = synthetic_boxes(4, 128, 3, 4, seed=1)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in zip(
        ("image", "boxes", "labels", "valid"), arrays)}
    small = resize_detection_batch(batch, 96)
    for b in (batch, small):          # warm: anchors and grids cached
        state, _ = step(state, b, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, batch, 0)
            state, metrics = step(state, resize_detection_batch(batch, 96),
                                  0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 6 and np.isfinite(float(metrics["loss"]))


# ------------------------------------------- Faster R-CNN's train step
@pytest.mark.cuda
@pytest.mark.parametrize("size", [128, 800])
def test_train_mode_proposals_through_k3_equal_the_plain_sweep(cuda_device,
                                                               size):
    """``generate_proposals`` on a train-mode forward's outputs, which
    require grad (the step runs it under ``no_grad``; here it runs
    without): one K3 launch, the proposals of the plain sweep exactly. At
    800² the RPN has 4 507 candidates an image."""
    from deeplearning_tpu_torch import hub
    from deeplearning_tpu_torch.models.detection import faster_rcnn
    model, _ = hub.load("fasterrcnn_resnet18_fpn", num_classes=4, seed=0,
                        device=cuda_device)
    model.train()
    g = torch.Generator(device=cuda_device).manual_seed(size)
    x = torch.randn(2, size, size, 3, device=cuda_device, generator=g)
    out = model(x)
    assert out["rpn_obj"].requires_grad and out["rpn_deltas"].requires_grad
    anchors = torch.from_numpy(faster_rcnn.fasterrcnn_anchors(
        (size, size))).to(cuda_device)
    before = nms_ops.launch_counts()["nms_greedy_sweep"]
    props, valid = faster_rcnn.generate_proposals(out, anchors, (size, size),
                                                  nms_impl="auto")
    torch.cuda.synchronize()
    assert nms_ops.launch_counts()["nms_greedy_sweep"] == before + 1
    with torch.no_grad():
        plain, plain_valid = faster_rcnn.generate_proposals(
            out, anchors, (size, size), nms_impl="blocked")
    assert torch.equal(props.detach(), plain)
    assert torch.equal(valid, plain_valid) and valid.any()
    if size == 800:
        assert sum(min(1000, c) for c in out["level_counts"]) == 4507


@pytest.mark.cuda
@pytest.mark.parametrize("batch,fraction", [(256, 0.5), (128, 0.25)])
def test_balanced_sample_keeps_its_counts_on_the_card(cuda_device, batch,
                                                      fraction):
    """Matches drawn over 8 images of 4 507 slots, the generator on the
    card: exactly min(candidates, int(batch · fraction)) positives and the
    negatives filling to the batch, a subset of each kind, never
    BETWEEN, and no sync under sync debug mode "error"."""
    from deeplearning_tpu_torch.ops import matcher
    g = torch.Generator(device=cuda_device).manual_seed(batch)
    u = torch.rand(8, 4507, device=cuda_device, generator=g)
    matches = torch.where(u < 0.02, 3, torch.where(
        u < 0.1, matcher.BETWEEN, matcher.BELOW_LOW))
    matches[0, 40:] = matcher.BETWEEN           # fewer candidates than asked
    pos_c, neg_c = matches >= 0, matches == matcher.BELOW_LOW
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pos, neg = matcher.balanced_sample(matches, g, batch, fraction)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_pos = pos_c.sum(-1).clamp(max=int(batch * fraction))
    assert torch.equal(pos.sum(-1), n_pos)
    assert torch.equal(neg.sum(-1), torch.minimum(neg_c.sum(-1),
                                                  batch - n_pos))
    assert not (pos & ~pos_c).any() and not (neg & ~neg_c).any()



# --------------------------------------------------- the serving zoo (item 6)
def _micro_engine(device, alias, quant="fp32", precompile=True):
    """A float32 micro ViT (flash_hb) or micro Swin (the fused K2) engine,
    weights from seed 0."""
    from deeplearning_tpu_torch import models  # noqa: F401  (registry)
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.serve import InferenceEngine
    name, size, kw = {
        "vit": ("vit_micro_patch4_56", 56, {"attn_fn": get_attn_fn("flash_hb")}),
        "vit_plain": ("vit_micro_patch4_56", 56, {}),
        "swin": ("swin_micro_patch2_window7", 28, {"use_pallas": True}),
        "swin_plain": ("swin_micro_patch2_window7", 28, {})}[alias]
    model = MODELS.build(name, num_classes=10, dtype=torch.float32,
                         img_size=size,
                         generator=torch.Generator().manual_seed(0), **kw)
    return InferenceEngine(name, model=model, image_size=size,
                           batch_buckets=(1, 4), device=device,
                           weight_quant=quant, precompile=precompile)


@pytest.mark.cuda
def test_int8_dequantize_on_the_card_equals_the_cpu(cuda_device):
    """The card's int8 payloads, scales and dequantized weights equal the
    plain CPU engine's bit for bit (one launch: q * s), and its answers
    stay within 1e-4 of the float32 engine's on the same card."""
    card = _micro_engine(cuda_device, "vit", "int8")
    cpu = _micro_engine("cpu", "vit", "int8", precompile=False)
    assert torch.equal(card._int8.q.cpu(), cpu._int8.q)
    assert torch.equal(card._int8.s.cpu(), cpu._int8.s)
    want = cpu.dequantized_state_dict()
    got = card.dequantized_state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
    x = torch.randn(4, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    fp32 = _micro_engine(cuda_device, "vit")
    np_x = x.numpy()
    assert abs(card.infer(np_x) - fp32.infer(np_x)).max() < 5e-2
    assert card.variables_nbytes() * 3.5 < fp32.variables_nbytes()


@pytest.mark.cuda
def test_eviction_gives_the_memory_back(cuda_device):
    """A zoo eviction drops the engine and empties the allocator's cache:
    the card's used bytes (mem_get_info) fall by at least 90% of the
    tenant's variables_nbytes()."""
    from deeplearning_tpu_torch.serve import ModelZoo
    zoo = ModelZoo()
    zoo.register("vit", "vit_base_patch16_224", attn="flash_hb",
                 batch_buckets=(1,), device=cuda_device)
    assert zoo.load("vit", wait=True) == "warm", zoo.load_errors
    nbytes = zoo.engine("vit").variables_nbytes()
    torch.cuda.synchronize()
    free_before, _ = torch.cuda.mem_get_info()
    assert zoo.evict("vit")
    free_after, _ = torch.cuda.mem_get_info()
    assert free_after - free_before >= 0.9 * nbytes


@pytest.mark.cuda
def test_k1_and_k2_from_a_zoo_load_thread_match_plain(cuda_device):
    """Engines built and warmed on the zoo's ``zoo-load-*`` threads launch
    K1 and K2 there (their counters rise during the load) and answer as
    the plain-attention engines on the same weights."""
    import functools
    import numpy as np
    from deeplearning_tpu_torch.serve import MicroBatcher, ModelZoo
    zoo = ModelZoo()
    for alias, size in (("vit", 56), ("swin", 28)):
        zoo.register(alias, engine_factory=functools.partial(
            _micro_engine, cuda_device, alias), batch_buckets=(1, 4),
            image_size=size)
    before = {**fa.launch_counts(), **wa.launch_counts()}
    for alias in ("vit", "swin"):
        assert zoo.load(alias, wait=True) == "warm", zoo.load_errors
    torch.cuda.synchronize()
    after = {**fa.launch_counts(), **wa.launch_counts()}
    assert after["flash_attn_fwd_hb"] > before["flash_attn_fwd_hb"]
    assert after[wa.KERNEL_NAME] > before[wa.KERNEL_NAME]
    g = torch.Generator().manual_seed(2)
    with MicroBatcher(zoo=zoo, max_wait_ms=1.0) as mb:
        for alias, size in (("vit", 56), ("swin", 28)):
            x = torch.randn(4, size, size, 3, generator=g).numpy()
            got = [mb.submit(im, model=alias).result(60.0) for im in x]
            want = _micro_engine(cuda_device, f"{alias}_plain").infer(x)
            assert abs(np.stack(got) - want).max() < 1e-4


@pytest.mark.cuda
def test_hbm_snapshot_adds_no_sync(cuda_device):
    """The zoo reads the card's memory before every load and the sampler
    every interval: neither may synchronise (work in flight on the
    stream)."""
    from deeplearning_tpu_torch.obs.xla import HbmWatermark, hbm_snapshot
    x = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = x @ x                                  # in flight
        snap = hbm_snapshot(alert_frac=0.99)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dev = snap["devices"][0]
    assert 0 < dev["bytes_in_use"] <= dev["bytes_limit"]
    assert dev["peak_bytes_in_use"] >= x.numel() * 4
    assert snap["live_arrays"]["nbytes"] >= 2 * x.numel() * 4
    wm = HbmWatermark(interval_s=0.01).start()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(20):
            y = y @ x
        import time
        time.sleep(0.05)
    finally:
        wm.stop()
        torch.cuda.set_sync_debug_mode(0)
    assert wm.samples >= 2 and wm.peak_bytes_in_use >= dev["bytes_in_use"]


@pytest.mark.cuda
def test_moe_layer_on_the_card_is_deterministic(cuda_device):
    """The MoE layer (plain torch: its routing, the slot-table scatter
    whose dropped tokens share a dummy row, the gathers) at Swin-MoE-T's
    stage-1 width: with tokens dropped, two identical forwards and
    backwards on the card are bit-equal; with none dropped, its forward
    equals the CPU's within bf16 rounding on every token the two float32
    routers send to the same expert (a near-tie may flip; at most 0.1 %)."""
    from deeplearning_tpu_torch.parallel.moe import MoEMlp, collect_moe
    x = torch.randn(4, 3136, 96, generator=torch.Generator().manual_seed(1))

    def run(moe, device):
        m = moe.to(device)
        xb = x.to(device, torch.bfloat16).requires_grad_()
        with collect_moe() as sown:
            out, aux = m(xb)
        out.float().square().sum().add(aux).backward()
        grads = [xb.grad] + [p.grad.clone() for p in m.parameters()]
        m.zero_grad()
        choice = torch.argmax(torch.nn.functional.linear(
            xb.detach().float(), m.router.weight, m.router.bias), -1)
        return [out.detach(), aux.detach()] + grads, \
            sown["moe_metrics"][0], choice

    for cf in (1.25, 8.0):
        torch.manual_seed(0)
        moe = MoEMlp(96, num_experts=8, capacity_factor=cf)
        moe.experts.init_weights(torch.Generator().manual_seed(0))
        first, metrics, choice = run(moe, cuda_device)
        if cf < 2:
            second, _, _ = run(moe, cuda_device)
            for a, b in zip(first, second):
                assert torch.equal(a, b)
            assert 0 < float(metrics["drop_rate"]) < 1
            continue
        assert float(metrics["drop_rate"]) == 0
        cpu, _, cpu_choice = run(moe, "cpu")
        same = (choice.cpu() == cpu_choice).reshape(-1)
        assert same.float().mean() >= 0.999
        got = first[0].float().cpu().reshape(-1, 96)[same]
        want = cpu[0].float().reshape(-1, 96)[same]
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
