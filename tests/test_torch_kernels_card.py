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
EDGE_N = [1, 17, 49, 63, 64, 65, 128, 129, 197, 256, 300]


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
    with pytest.raises(ValueError):          # head dim past the kernels'
        fa.flash_attention(*(torch.zeros(1, 2, 8, 160, device=cuda_device)
                             for _ in range(3)))
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
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(2, n, 3, 4, 80, device=cuda_device,
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
    assert out.shape == (2, n, 4, 80)
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
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 2, 4, n, 80, dtype,
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
@pytest.mark.parametrize("n", [1, 49, 64, 65, 197])
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
    with pytest.raises(ValueError, match="head dim"):
        call(d=48)
    with pytest.raises(ValueError, match="N <="):
        call(n=81)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(dtype=torch.float16)


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
