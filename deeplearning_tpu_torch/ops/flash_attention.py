"""Flash attention on Hopper: the port of
``deeplearning_tpu/ops/pallas/flash_attention.py``, forward and backward.

Entry points keep the JAX signatures and the (B, H, N, D) layout:
``flash_attention`` (one head per CTA, the ``_fwd_kernel`` and
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` ports), ``flash_attention_hb``
(``head_block`` heads per CTA, the ``_hb`` ports), ``flash_attention_bnhd``
and ``attention_bnhd``. Each kernel entry is a ``torch.library`` op
(``dltpu::``) with a fake implementation, so ``torch.export`` and fake-mode traces show
each launch as one node: ``dltpu::flash_fwd`` (O and the row log-sum-exp)
is differentiable through ``register_autograd`` (the counterpart of the
JAX ``custom_vjp``); its backward is ``dltpu::flash_bwd_dq`` (which, for
bf16, computes ``delta = rowsum(dO * O)`` from O and returns it) and then
``dltpu::flash_bwd_dkv``, which reads that delta.
``flash_attention_with_lse`` is forward-only, as in JAX;
``flash_chunk_grads`` (ring attention's
backward) reaches the same backward kernels with caller-supplied global
statistics. The kernels are ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``, built with nvcc at first use.

Dispatch is by where the tensors lie, nothing else: a CUDA tensor
launches the kernel or raises (a card below sm_90, a build failure, a
launch error, a shape the kernel does not take); a CPU tensor takes the
plain PyTorch versions, ``flash_attention_reference`` and
``flash_attention_bwd_reference``. There is no fallback from one to the
other.

The tensor-core kernels are instantiated for D in ``HEAD_DIMS``; any
other D up to 256 (ViT-H/14's 80, or 160) is zero-padded to the next of
them on the card, with ``sm_scale`` taken from the true D, and the
outputs and gradients are sliced back. The pad is exact: zero columns add
nothing to Q Kᵀ, dO Vᵀ or rowsum(dO · O). At D = 256 each kernel splits
its output columns over two CTAs (each recomputes the scores), so its
registers stay those of D = 128. Above 256, D is zero-padded to a
multiple of 64 and runs on SIMT kernels of the same sources (one head a
CTA, 128 output columns a CTA, the scores summed over 64-column chunks
streamed through shared memory: ``csrc/wide_attn.cuh``), in either dtype
and direction, with the same rounding.

``block_q`` / ``block_k`` are accepted so calls written against the JAX
entry points run unchanged; they set the TPU kernel's tiling and do not
change the result, and the Hopper kernel picks its own tiles.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernels import WIDE_GRANULE, define_op, kernel_head_dim

__all__ = ["flash_attention", "flash_attention_hb", "flash_attention_with_lse",
           "flash_attention_bnhd", "flash_attention_reference",
           "flash_attention_bwd_reference", "flash_chunk_grads",
           "attention_bnhd", "launch_counts", "reset_launch_counts",
           "flops", "min_bytes", "bwd_flops", "bwd_min_bytes",
           "KERNEL_NAMES", "BWD_KERNEL_NAMES", "HEAD_DIMS"]

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128, 256)
HEADS_PER_CTA = (1, 2, 4)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# one counter per instantiation: bumped right after a successful launch,
# nowhere else — a run proves it went through the kernel by reading them
KERNEL_NAMES = {1: "flash_attn_fwd", 2: "flash_attn_fwd_hb",
                4: "flash_attn_fwd_hb"}
BWD_KERNEL_NAMES = {
    "dq": {1: "flash_attn_bwd_dq", 2: "flash_attn_bwd_dq_hb",
           4: "flash_attn_bwd_dq_hb"},
    "dkv": {1: "flash_attn_bwd_dkv", 2: "flash_attn_bwd_dkv_hb",
            4: "flash_attn_bwd_dkv_hb"}}
_LAUNCHES: Dict[str, int] = dict.fromkeys(
    ["flash_attn_fwd", "flash_attn_fwd_hb", "flash_attn_bwd_dq",
     "flash_attn_bwd_dkv", "flash_attn_bwd_dq_hb", "flash_attn_bwd_dkv_hb"],
    0)
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
_BWD_LIB = None
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
    ct = _compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(n, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(ct))
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: Optional[torch.Tensor],
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  sm_scale: Optional[float] = None,
                                  causal: bool = False,
                                  out_dtype: Optional[torch.dtype] = None,
                                  delta: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The FlashAttention-2 gradients in float32, on any device: the CPU
    path of the backward, and the yardstick the backward kernels are held
    against on the card. (B, H, N, D) q, k, v, o, do; ``lse`` (B, H, N)
    from the forward; ``delta`` (B, H, N) = rowsum(dO * O) when given (ring
    attention passes the global one), else computed from ``o``. Returns
    (dq, dk, dv) in ``out_dtype`` (default q's dtype)."""
    d, n = q.shape[-1], q.shape[2]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    ct = _compute_dtype(q)
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.to(ct)[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(n, q.device), 0.0)
    if delta is None:
        delta = (dof * o.to(ct)).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.to(ct)[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dt = out_dtype or q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradcheck case)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_keep(n: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()


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


def _bwd_lib():
    global _BWD_LIB
    with _LIB_LOCK:
        if _BWD_LIB is None:
            from .kernels import build
            lib = build.load("flash_attn_bwd")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            strides = ctypes.POINTER(ctypes.c_longlong)
            lib.flash_attn_bwd_dq.argtypes = (
                [vp] * 8 + [i32] * 4 + [strides, ctypes.c_float]
                + [i32] * 4 + [vp])
            lib.flash_attn_bwd_dkv.argtypes = (
                [vp] * 8 + [i32] * 4 + [strides, ctypes.c_float]
                + [i32] * 4 + [vp])
            for fn in (lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv):
                fn.restype = i32
            lib.flash_attn_bwd_error_string.argtypes = [i32]
            lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
            _BWD_LIB = lib
        return _BWD_LIB


def _check_card(device: torch.device) -> None:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cap = _CAPABILITY.get(index)
    if cap is None:
        cap = _CAPABILITY[index] = torch.cuda.get_device_capability(index)
    if cap < (9, 0):
        raise RuntimeError(
            f"the flash-attention kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} is sm_{cap[0]}{cap[1]}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel moves 16-byte vectors: base and strides must be 16-byte
    multiples. A tensor that is not gets a fresh (aligned) copy."""
    vec = 16 // x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            s % vec for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _kernel_head_dim(d: int) -> int:
    """The head dim a D runs at: an instantiated one up to 256, a
    multiple of 64 above."""
    return kernel_head_dim(d, HEAD_DIMS, "flash_attn")


def _pad_head_dim(xs, d: int) -> tuple:
    """Each tensor (or None) with its last dim zero-padded to ``d``."""
    return tuple(None if x is None else
                 torch.nn.functional.pad(x, (0, d - x.shape[-1]))
                 for x in xs)


def _check_launch(name: str, q: torch.Tensor, heads_per_cta: int) -> None:
    """What every kernel of this module takes; raises on anything else."""
    h, d = q.shape[1], q.shape[3]
    _check_card(q.device)
    if _kernel_head_dim(d) != d:
        raise ValueError(f"{name} takes head dim in {HEAD_DIMS} or a "
                         f"multiple of {WIDE_GRANULE} above, got {d}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if heads_per_cta not in HEADS_PER_CTA or h % heads_per_cta:
        raise ValueError(f"heads_per_cta={heads_per_cta} must be in "
                         f"{HEADS_PER_CTA} and divide H={h}")


def _check_out(*outs: torch.Tensor) -> None:
    if any(_aligned(o) is not o for o in outs):
        raise ValueError("output view must be 16-byte aligned with a "
                         "contiguous last dim")


def _launch(q, k, v, out, sm_scale: float, causal: bool,
            heads_per_cta: int,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the kernel on CUDA tensors q, k, v, writing ``out`` (all
    (B, H, N, D), any strides) and ``lse`` (a contiguous float32 buffer of
    B*H*N, allocated when not given); returns the LSE as (B*H, N)."""
    b, h, n, d = q.shape
    _check_launch("flash_attn_fwd", q, heads_per_cta)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    _check_out(out)
    if lse is None:
        lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    elif lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.numel() != b * h * n:
        raise ValueError("lse must be a contiguous float32 buffer of B*H*N")
    lse = lse.view(b * h, n)
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


def _launch_bwd(q, k, v, do, lse, delta, dq, dk, dv, sm_scale: float,
                causal: bool, heads_per_cta: int,
                kernels: Tuple[str, ...] = ("dq", "dkv"),
                o: Optional[torch.Tensor] = None) -> None:
    """Run the dQ kernel, then the dK/dV kernel, on CUDA tensors: q, k, v,
    do, o and the outputs dq, dk, dv are (B, H, N, D) with any strides; lse
    and delta are (B*H, N) float32. The outputs share one dtype: q's, or
    float32. Given ``o`` (bf16 only), the dQ kernel computes
    delta = rowsum(dO * O) from it and writes it into ``delta``, a
    contiguous (B*H, N) float32 buffer, which the dK/dV kernel then reads;
    without, both read ``delta``. ``kernels`` picks one of the two (the
    custom ops launch one each; a timing harness times each alone), and
    the gradients the other one writes may be None."""
    b, h, n, d = q.shape
    _check_launch("flash_attn_bwd", q, heads_per_cta)
    outs = [g for g in (dq, dk, dv) if g is not None]
    dtypes = {g.dtype for g in outs}
    if len(dtypes) != 1 or dtypes - {q.dtype, torch.float32}:
        raise ValueError(f"gradients must share q's dtype or float32, got "
                         f"{[g.dtype for g in outs]}")
    out_dtype = outs[0].dtype
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    _check_out(*outs)
    lse = lse.to(torch.float32).reshape(b * h, n).contiguous()
    if o is None:
        delta = delta.to(torch.float32).reshape(b * h, n).contiguous()
    else:
        if q.dtype != torch.bfloat16 or o.shape != q.shape \
                or o.dtype != q.dtype:
            raise ValueError("the dQ kernel computes delta from a bf16 O "
                             "of q's shape only")
        if delta.dtype != torch.float32 or not delta.is_contiguous() \
                or delta.numel() != b * h * n:
            raise ValueError("delta must be a contiguous (B*H, N) float32 "
                             "buffer for the dQ kernel to write")
        o = _aligned(o)
    o_ptr = None if o is None else o.data_ptr()
    o_strides = (0, 0, 0) if o is None else o.stride()[:3]
    codes = (float(sm_scale), int(bool(causal)), heads_per_cta,
             _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _bwd_lib()
        for which in ("dq", "dkv"):
            if which not in kernels:
                continue
            if which == "dq":
                ptrs = (o_ptr, lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr())
                st = (*(x for t in (q, k, v, do) for x in t.stride()[:3]),
                      *o_strides, *dq.stride()[:3])
            else:
                ptrs = (lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                        dv.data_ptr())
                st = tuple(x for t in (q, k, v, do, dk, dv)
                           for x in t.stride()[:3])
            strides = (ctypes.c_longlong * len(st))(*st)
            fn = getattr(lib, f"flash_attn_bwd_{which}")
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    *ptrs, b, h, n, d, strides, *codes, stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash_attn_bwd_{which} launch failed ({rc}): "
                    f"{lib.flash_attn_bwd_error_string(rc).decode()}")
            with _COUNT_LOCK:
                _LAUNCHES[BWD_KERNEL_NAMES[which][heads_per_cta]] += 1


def _check_qkv(q, k, v) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")


def _scale(d: int, sm_scale: Optional[float]) -> float:
    """The softmax scale of the true D, never of a padded one."""
    return d ** -0.5 if sm_scale is None else float(sm_scale)


def _empty_bhnd(like: torch.Tensor, dtype: torch.dtype,
                bnhd: bool) -> torch.Tensor:
    """A (B, H, N, D) buffer for an output or a gradient; ``bnhd``: a view
    of a contiguous (B, N, H, D) tensor, the layout the models hand the
    kernels. Every result of the custom ops below is laid out by this
    function, in the real and in the fake implementations alike."""
    b, h, n, d = like.shape
    if bnhd:
        return torch.empty((b, n, h, d), dtype=dtype,
                           device=like.device).transpose(1, 2)
    return torch.empty((b, h, n, d), dtype=dtype, device=like.device)


def _rows(q: torch.Tensor) -> torch.Tensor:
    """A (B, H, N) buffer of the softmax rows' statistics (LSE, delta)."""
    b, h, n, _ = q.shape
    return torch.empty((b, h, n), dtype=_compute_dtype(q), device=q.device)


# --------------------------------------------------------- the custom ops
# Each kernel entry is one ``torch.library`` op under ``dltpu::``
# (``kernels.define_op``): the only binding, for eager runs,
# ``torch.export`` and fake-mode traces alike. The real implementations
# dispatch by where the tensors lie (the plain versions on the CPU; on the
# card the kernel, and the checks that need a card); the fake ones give
# results of the real ones' shapes, dtypes and strides and launch nothing.
def _flash_fwd_impl(q, k, v, sm_scale, causal, heads_per_cta, bnhd):
    """K1's forward: (O (B, H, N, D), LSE (B, H, N) float32)."""
    _check_qkv(q, k, v)
    out, lse = _empty_bhnd(q, q.dtype, bnhd), _rows(q)
    _fwd_into(q, k, v, out, lse, sm_scale, causal, heads_per_cta)
    return out, lse


def _flash_fwd_fake(q, k, v, sm_scale, causal, heads_per_cta, bnhd):
    _check_qkv(q, k, v)
    return _empty_bhnd(q, q.dtype, bnhd), _rows(q)


def _fwd_into(q, k, v, out, lse, scale: float, causal: bool,
              heads_per_cta: int) -> None:
    """Attention of (B, H, N, D) q, k, v into ``out`` and ``lse``."""
    b, h, n, d = q.shape
    if q.device.type == "cpu":
        o, lse_ = flash_attention_reference(q, k, v, sm_scale=scale,
                                            causal=causal)
        out.copy_(o)
        lse.copy_(lse_)
        return
    d_kernel = _kernel_head_dim(d)
    if d_kernel != d:
        qp, kp, vp = _pad_head_dim((q, k, v), d_kernel)
        o = torch.empty_like(qp, memory_format=torch.contiguous_format)
        _fwd_into(qp, kp, vp, o, lse, scale, causal, heads_per_cta)
        out.copy_(o[..., :d])
        return
    if n == 0 or b * h == 0:
        return
    _launch(q, k, v, out, scale, causal, heads_per_cta, lse=lse)


def _flash_bwd_dq_impl(q, k, v, o, lse, do, delta, sm_scale, causal,
                       heads_per_cta, out_f32, bnhd):
    """K1's dQ kernel: (dQ, delta (B, H, N)). ``delta`` = rowsum(dO * O)
    when not given: for bf16 the kernel computes it from ``o`` and writes
    it; for float32 it is computed here in float32, as the JAX code does
    outside its kernels. A given ``delta`` (ring attention's global one)
    comes back as a copy."""
    b, h, n, d = q.shape
    dq = _empty_bhnd(q, torch.float32 if out_f32 else q.dtype, bnhd)
    ct = _compute_dtype(q)
    fold = delta is None and q.dtype == torch.bfloat16 \
        and q.device.type == "cuda"
    if delta is None:
        delta = _rows(q) if fold else \
            (do.to(ct) * o.to(ct)).sum(-1).reshape(b, h, n)
    else:
        delta = delta.to(ct).reshape(b, h, n).clone()
    if q.device.type == "cpu":
        dq.copy_(flash_attention_bwd_reference(
            q, k, v, o, lse, do, sm_scale=sm_scale, causal=causal,
            out_dtype=dq.dtype, delta=delta)[0])
        return dq, delta
    d_kernel = _kernel_head_dim(d)
    qp, kp, vp, op, dop = _pad_head_dim((q, k, v, o, do), d_kernel) \
        if d_kernel != d else (q, k, v, o, do)
    dqp = dq if d_kernel == d else _empty_bhnd(qp, dq.dtype, bnhd)
    if n and b * h:
        _launch_bwd(qp, kp, vp, dop, lse, delta, dqp, None, None, sm_scale,
                    causal, heads_per_cta, kernels=("dq",),
                    o=op if fold else None)
    if dqp is not dq:
        dq.copy_(dqp[..., :d])
    return dq, delta


def _flash_bwd_dq_fake(q, k, v, o, lse, do, delta, sm_scale, causal,
                       heads_per_cta, out_f32, bnhd):
    return (_empty_bhnd(q, torch.float32 if out_f32 else q.dtype, bnhd),
            _rows(q))


def _flash_bwd_dkv_impl(q, k, v, lse, do, delta, sm_scale, causal,
                        heads_per_cta, out_f32, bnhd):
    """K1's dK/dV kernel: (dK, dV), reading the dQ op's ``delta``."""
    b, h, n, d = q.shape
    dtype = torch.float32 if out_f32 else q.dtype
    dk, dv = _empty_bhnd(q, dtype, bnhd), _empty_bhnd(q, dtype, bnhd)
    if q.device.type == "cpu":
        _, dk_, dv_ = flash_attention_bwd_reference(
            q, k, v, None, lse, do, sm_scale=sm_scale, causal=causal,
            out_dtype=dtype, delta=delta)
        dk.copy_(dk_)
        dv.copy_(dv_)
        return dk, dv
    d_kernel = _kernel_head_dim(d)
    padded = d_kernel != d
    qp, kp, vp, dop = _pad_head_dim((q, k, v, do), d_kernel) \
        if padded else (q, k, v, do)
    dkp, dvp = (_empty_bhnd(qp, dtype, bnhd) for _ in "kv") \
        if padded else (dk, dv)
    if n and b * h:
        _launch_bwd(qp, kp, vp, dop, lse, delta, None, dkp, dvp, sm_scale,
                    causal, heads_per_cta, kernels=("dkv",))
    if padded:
        dk.copy_(dkp[..., :d])
        dv.copy_(dvp[..., :d])
    return dk, dv


def _flash_bwd_dkv_fake(q, k, v, lse, do, delta, sm_scale, causal,
                        heads_per_cta, out_f32, bnhd):
    dtype = torch.float32 if out_f32 else q.dtype
    return _empty_bhnd(q, dtype, bnhd), _empty_bhnd(q, dtype, bnhd)


def _setup_fwd(ctx, inputs, output) -> None:
    q, k, v, sm_scale, causal, heads_per_cta, bnhd = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.cfg = (sm_scale, causal, heads_per_cta, bnhd)


def _backward_fwd(ctx, do, _dlse):
    """The counterpart of the JAX ``custom_vjp`` pairs ``_flash`` /
    ``_flash_hb``: P is recomputed from q, k, v and the saved LSE."""
    q, k, v, o, lse = ctx.saved_tensors
    sm_scale, causal, heads_per_cta, bnhd = ctx.cfg
    dq, dk, dv = _attention_bwd(q, k, v, o, lse, do, sm_scale=sm_scale,
                                causal=causal, heads_per_cta=heads_per_cta,
                                bnhd=bnhd)
    return dq, dk, dv, None, None, None, None


# the ops' overloads, bound once: a call through them skips the packet's
# overload lookup on every launch (the host path of a served forward)
_FWD = define_op(
    "flash_fwd(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal, "
    "int heads_per_cta, bool bnhd) -> (Tensor, Tensor)",
    _flash_fwd_impl, _flash_fwd_fake, backward=_backward_fwd,
    setup_context=_setup_fwd)
_BWD_DQ = define_op(
    "flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor? o, Tensor lse, "
    "Tensor do, Tensor? delta, float sm_scale, bool causal, "
    "int heads_per_cta, bool out_f32, bool bnhd) -> (Tensor, Tensor)",
    _flash_bwd_dq_impl, _flash_bwd_dq_fake)
_BWD_DKV = define_op(
    "flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor do, "
    "Tensor delta, float sm_scale, bool causal, int heads_per_cta, "
    "bool out_f32, bool bnhd) -> (Tensor, Tensor)",
    _flash_bwd_dkv_impl, _flash_bwd_dkv_fake)


def _attention(q, k, v, *, sm_scale, causal, heads_per_cta, bnhd=False):
    """(out, lse (B, H, N)) for (B, H, N, D) q, k, v on one device: one
    ``dltpu::flash_fwd`` call (which checks its operands)."""
    return _FWD(q, k, v, _scale(q.shape[-1], sm_scale), bool(causal),
                int(heads_per_cta), bool(bnhd))


def _attention_bwd(q, k, v, o, lse, do, *, sm_scale, causal, heads_per_cta,
                   out_dtype=None, delta=None, bnhd=False):
    """(dq, dk, dv) of attention for (B, H, N, D) operands: the
    ``dltpu::flash_bwd_dq`` op, then ``dltpu::flash_bwd_dkv``, which reads
    the first one's delta."""
    scale = _scale(q.shape[-1], sm_scale)
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"gradients come in q's dtype or float32, not "
                         f"{out_dtype}")
    out_f32 = out_dtype == torch.float32 and q.dtype != torch.float32
    dq, delta = _BWD_DQ(
        q, k, v, o, lse, do, delta, scale, bool(causal), int(heads_per_cta),
        out_f32, bool(bnhd))
    dk, dv = _BWD_DKV(
        q, k, v, lse, do, delta, scale, bool(causal), int(heads_per_cta),
        out_f32, bool(bnhd))
    return dq, dk, dv


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
    """Fused attention, one head per CTA. q, k, v: (B, H, N, D), any N.
    Differentiable: the backward runs the dQ and dK/dV kernels."""
    del block_q, block_k
    return _attention(q, k, v, sm_scale=sm_scale, causal=causal,
                      heads_per_cta=1)[0]


def flash_attention_hb(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       sm_scale: Optional[float] = None, causal: bool = False,
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K,
                       head_block: int = 4) -> torch.Tensor:
    """Head-batched fused attention: ``head_block`` heads (halved until it
    divides H) share one CTA, forward and backward — the short-N path
    (ViT's N = 197)."""
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
    merges per-chunk results with. Forward-only, as in JAX: no gradient
    flows through the pair."""
    del block_q, block_k
    with torch.no_grad():
        return _attention(q, k, v, sm_scale=sm_scale, causal=causal,
                          heads_per_cta=1)


def flash_chunk_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *,
                      sm_scale: Optional[float] = None,
                      block_q: int = DEFAULT_BLOCK_Q,
                      block_k: int = DEFAULT_BLOCK_K
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention over ONE KV chunk given the GLOBAL
    softmax statistics: ``lse`` / ``delta`` (B, H, Nq) are the
    full-sequence log-sum-exp and rowsum(dO * O), so per-chunk gradients
    sum over chunks to the exact full-attention gradient (ring attention's
    backward). q, do: (B, H, Nq, D); k, v: (B, H, Nk, D) with Nq == Nk.
    Gradients come back in float32 whatever the input dtype: the ring
    accumulates them across steps."""
    del block_q, block_k
    n = q.shape[2]
    if k.shape[2] != n:
        raise ValueError(f"ring chunks must be equal: Nq={n} "
                         f"Nk={k.shape[2]}")
    _check_qkv(q, k, v)
    return _attention_bwd(q, k, v, None, lse, do, sm_scale=sm_scale,
                          causal=False, heads_per_cta=1,
                          out_dtype=torch.float32, delta=delta)


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   heads_per_cta: int = 1,
                   sm_scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """(B, N, H, D) in and out, with no transposes: the kernels read the
    strided (B, H, N, D) views of their inputs (e.g. slices of a fused qkv)
    and write the output and the gradients as (B, N, H, D) tensors through
    the matching views. Differentiable."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(_attention(t(q), t(k), t(v), sm_scale=sm_scale, causal=causal,
                        heads_per_cta=heads_per_cta, bnhd=True)[0])


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


# (N x N x D) products each backward kernel does: dQ recomputes S and dP
# and forms dS K; dK/dV recomputes S and dP and forms P^T dO and dS^T Q
_BWD_PRODUCTS = {"dq": 3, "dkv": 4, None: 5}
# (B, H, N, D) operands read and written, and (B, H, N) float32 rows moved:
# the bf16 dQ kernel reads q, k, v, dO and O, reads LSE and writes delta
# and dQ; dK/dV reads q, k, v, dO, LSE and delta and writes dK and dV; the
# whole backward reads q, k, v, dO, O and LSE and writes the three
_BWD_IO = {"dq": (5, 1, 2), "dkv": (4, 2, 2), None: (5, 3, 1)}


def bwd_flops(b: int, h: int, n: int, d: int, causal: bool = False,
              kernel: Optional[str] = None) -> float:
    """Operations of the backward ("dq", "dkv", or None for the whole
    backward as the math needs it: S, dP, dV, dQ, dK), 2 per
    multiply-add; the causal mask halves them to first order."""
    full = _BWD_PRODUCTS[kernel] * 2.0 * b * h * n * n * d
    return full * (n + 1) / (2 * n) if causal else full


def bwd_min_bytes(b: int, h: int, n: int, d: int, itemsize: int,
                  kernel: Optional[str] = None,
                  out_itemsize: Optional[int] = None) -> int:
    """Each input read once and each output written once, for the bf16
    kernels: "dq" reads q, k, v, dO, O and LSE and writes dQ and delta;
    "dkv" reads q, k, v, dO, LSE and delta and writes dK and dV; None, the
    whole backward, reads q, k, v, dO, O and LSE and writes dQ, dK, dV.
    LSE and delta are float32."""
    t = b * h * n * d
    reads, writes, rows = _BWD_IO[kernel]
    return (reads * t * itemsize + rows * b * h * n * 4
            + writes * t * (out_itemsize or itemsize))


# K1's operation counts for ``torch.utils.flop_counter.FlopCounterMode``
# (the formulas get the ops' arguments, each tensor as its shape)
@register_flop_formula(torch.ops.dltpu.flash_fwd)
def _fwd_flop_count(q_shape, k_shape, v_shape, sm_scale, causal, *args,
                    out_shape=None, **kwargs) -> int:
    return int(flops(*q_shape, causal=causal))


@register_flop_formula(torch.ops.dltpu.flash_bwd_dq)
def _dq_flop_count(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
                   delta_shape, sm_scale, causal, *args, out_shape=None,
                   **kwargs) -> int:
    return int(bwd_flops(*q_shape, causal=causal, kernel="dq"))


@register_flop_formula(torch.ops.dltpu.flash_bwd_dkv)
def _dkv_flop_count(q_shape, k_shape, v_shape, lse_shape, do_shape,
                    delta_shape, sm_scale, causal, *args, out_shape=None,
                    **kwargs) -> int:
    return int(bwd_flops(*q_shape, causal=causal, kernel="dkv"))
