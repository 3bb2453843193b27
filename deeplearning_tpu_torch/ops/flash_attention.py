"""Flash attention forward on Hopper: the port of
``deeplearning_tpu/ops/pallas/flash_attention.py``'s forward kernels.

Entry points keep the JAX signatures and the (B, H, N, D) layout:
``flash_attention`` (one head per CTA, the ``_fwd_kernel`` port),
``flash_attention_hb`` (``head_block`` heads per CTA, the
``_fwd_kernel_hb`` port), ``flash_attention_with_lse`` and
``flash_attention_bnhd``. All reach one CUDA source,
``csrc/flash_attn_fwd.cu``, built with nvcc at first use.

Dispatch is by where the tensors lie, nothing else: a CUDA tensor
launches the kernel or raises (a card below sm_90, a build failure, a
launch error, a shape the kernel does not take); a CPU tensor takes the
plain PyTorch version, ``flash_attention_reference``. There is no
fallback from one to the other.

``block_q`` / ``block_k`` are accepted so calls written against the JAX
entry points run unchanged; they set the TPU kernel's tiling and do not
change the result, and the Hopper kernel picks its own tiles.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_hb", "flash_attention_with_lse",
           "flash_attention_bnhd", "flash_attention_reference",
           "attention_bnhd", "launch_counts", "reset_launch_counts",
           "flops", "min_bytes", "KERNEL_NAMES", "HEAD_DIMS"]

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128)
HEADS_PER_CTA = (1, 2, 4)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# one counter per instantiation: bumped right after a successful launch,
# nowhere else — a run proves it went through the kernel by reading them
KERNEL_NAMES = {1: "flash_attn_fwd", 2: "flash_attn_fwd_hb",
                4: "flash_attn_fwd_hb"}
_LAUNCHES: Dict[str, int] = {"flash_attn_fwd": 0, "flash_attn_fwd_hb": 0}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
_CAPABILITY: Dict[int, Tuple[int, int]] = {}


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


# ---------------------------------------------------------- plain version
def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              sm_scale: Optional[float] = None,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(Q Kᵀ · sm_scale, causal mask) · V in float32, plus the row
    log-sum-exp. (B, H, N, D) in; returns (out in q's dtype, lse (B, H, N)
    float32). Runs on any device: the CPU path of the wrappers, and the
    yardstick the kernel is held against on the card."""
    d, n = q.shape[-1], q.shape[2]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


# ------------------------------------------------------------ the kernel
def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .kernels import build
            lib = build.load("flash_attn_fwd")
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.flash_attn_fwd.argtypes = (
                [vp] * 5 + [i32] * 4 + [i64] * 12
                + [ctypes.c_float, i32, i32, i32, vp])
            lib.flash_attn_fwd.restype = i32
            lib.flash_attn_error_string.argtypes = [i32]
            lib.flash_attn_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check_card(device: torch.device) -> None:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cap = _CAPABILITY.get(index)
    if cap is None:
        cap = _CAPABILITY[index] = torch.cuda.get_device_capability(index)
    if cap < (9, 0):
        raise RuntimeError(
            f"flash_attn_fwd is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} is sm_{cap[0]}{cap[1]}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel moves 16-byte vectors: base and strides must be 16-byte
    multiples. A tensor that is not gets a fresh (aligned) copy."""
    vec = 16 // x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            s % vec for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _launch(q, k, v, out, sm_scale: float, causal: bool,
            heads_per_cta: int) -> torch.Tensor:
    """Run the kernel on CUDA tensors q, k, v, writing ``out`` (all
    (B, H, N, D), any strides); returns the (B*H, N) float32 LSE."""
    b, h, n, d = q.shape
    _check_card(q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd takes head dim in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attn_fwd takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if heads_per_cta not in HEADS_PER_CTA or h % heads_per_cta:
        raise ValueError(f"heads_per_cta={heads_per_cta} must be in "
                         f"{HEADS_PER_CTA} and divide H={h}")
    if b * h // heads_per_cta > 65535:
        raise ValueError(f"B*H/heads_per_cta = {b * h // heads_per_cta} "
                         f"exceeds the grid's 65535 rows")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if _aligned(out) is not out:
        raise ValueError("output view must be 16-byte aligned with a "
                         "contiguous last dim")
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _lib()
        rc = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, n, d, *strides, float(sm_scale),
            int(bool(causal)), heads_per_cta, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed ({rc}): "
            f"{lib.flash_attn_error_string(rc).decode()}")
    with _COUNT_LOCK:
        _LAUNCHES[KERNEL_NAMES[heads_per_cta]] += 1
    return lse


def _attention(q, k, v, *, sm_scale, causal, heads_per_cta, out=None):
    """(out, lse (B, H, N)) for (B, H, N, D) q, k, v on one device.
    ``out``: an optional (B, H, N, D) view to write the result into."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    b, h, n, d = q.shape
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, sm_scale=scale,
                                           causal=causal)
        if out is not None:
            out.copy_(o)
            o = out
        return o, lse
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if n == 0 or b * h == 0:
        return out, torch.empty((b, h, n), dtype=torch.float32,
                                device=q.device)
    lse = _launch(q, k, v, out, scale, causal, heads_per_cta)
    return out, lse.view(b, h, n)


def _head_block(h: int, head_block: int) -> int:
    """The JAX rule: halve ``head_block`` until it divides H."""
    while head_block > 1 and h % head_block:
        head_block //= 2
    return max(head_block, 1)


# ---------------------------------------------------------- entry points
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: Optional[float] = None, causal: bool = False,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Fused attention, one head per CTA. q, k, v: (B, H, N, D), any N."""
    del block_q, block_k
    return _attention(q, k, v, sm_scale=sm_scale, causal=causal,
                      heads_per_cta=1)[0]


def flash_attention_hb(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       sm_scale: Optional[float] = None, causal: bool = False,
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K,
                       head_block: int = 4) -> torch.Tensor:
    """Head-batched fused attention: ``head_block`` heads (halved until it
    divides H) share one CTA — the short-N path (ViT's N = 197)."""
    del block_q, block_k
    return _attention(q, k, v, sm_scale=sm_scale, causal=causal,
                      heads_per_cta=_head_block(q.shape[1], head_block))[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             sm_scale: Optional[float] = None,
                             causal: bool = False,
                             block_q: int = DEFAULT_BLOCK_Q,
                             block_k: int = DEFAULT_BLOCK_K
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, N, D), lse (B, H, N) float32): the hook ring attention
    merges per-chunk results with."""
    del block_q, block_k
    return _attention(q, k, v, sm_scale=sm_scale, causal=causal,
                      heads_per_cta=1)


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   heads_per_cta: int = 1,
                   sm_scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """(B, N, H, D) in and out, with no transposes: the kernel reads the
    strided (B, H, N, D) views of its inputs (e.g. slices of a fused qkv)
    and writes a (B, N, H, D) tensor through the matching view."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    _attention(t(q), t(k), t(v), sm_scale=sm_scale, causal=causal,
               heads_per_cta=heads_per_cta, out=t(out))
    return out


def flash_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """(B, N, H, D) layout convenience wrapper (the models' layout)."""
    kw.pop("block_q", None)
    kw.pop("block_k", None)
    return attention_bnhd(q, k, v, heads_per_cta=1, **kw)


def flops(b: int, h: int, n: int, d: int, causal: bool = False) -> float:
    """Multiply-adds of the two products, counted as 2 operations each
    (the causal mask halves the work the kernel must do, to first order)."""
    full = 4.0 * b * h * n * n * d
    return full * (n + 1) / (2 * n) if causal else full


def min_bytes(b: int, h: int, n: int, d: int, itemsize: int) -> int:
    """q, k, v read once, O written once, LSE (float32) written once."""
    return 4 * b * h * n * d * itemsize + b * h * n * 4

