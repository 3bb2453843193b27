"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no card is
visible: a CUDA kernel has no CPU mode. On a machine with a card:

    python -m pytest tests/test_torch_kernels_card.py -m cuda -q

This file imports only torch and the port (no JAX), so it runs where the
JAX package is not installed.
"""

import pytest
import torch

from deeplearning_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("hpc", [1, 2, 4])
@pytest.mark.parametrize("n,d,causal", [(197, 64, False), (49, 32, False),
                                        (128, 32, True), (1, 64, False),
                                        (300, 128, False), (17, 16, True)])
def test_flash_attn_fwd_matches_plain(cuda_device, n, d, causal, hpc,
                                      dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
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
    with pytest.raises(ValueError):          # head dim the kernel lacks
        fa.flash_attention(*(torch.zeros(1, 2, 8, 48, device=cuda_device)
                             for _ in range(3)))
    with pytest.raises(ValueError):          # dtype the kernel lacks
        fa.flash_attention(*(torch.zeros(1, 2, 8, 64, device=cuda_device,
                                         dtype=torch.float16)
                             for _ in range(3)))
