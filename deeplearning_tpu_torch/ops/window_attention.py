"""Fused window attention on Hopper: the port of
``deeplearning_tpu/ops/pallas/window_attention.py``.

``window_attention(qkv, bias, mask=None, windows_per_block=8)`` keeps the
JAX signature and layouts: qkv (BW, N, 3, heads, d) with BW = batch ×
windows and N = window², the relative-position bias (heads, N, N), the
additive shift mask (nW, N, N) or None; it returns (BW, N, heads·d). Per
(window, head) it computes S = QKᵀ·d^-½ + bias + mask[w mod nW] in
float32, softmax in float32, and P·V with P cast to v's dtype and float32
accumulation: the TPU kernel's numerics (which scale after the product,
where the unfused reference scales q before it).

The kernel is ``csrc/window_attn_fwd.cu``, built with nvcc at first use.
It reads q, k and v straight from the strided qkv view through TMA (no
transposes or padded copies), masks keys ≥ N in place, adds bias and mask
inside the kernel and writes the (BW, N, heads·d) layout the output
projection consumes. A CTA owns one head and one window position
j = w mod nW (nW = 1 unmasked) and forms that pair's additive term once;
``windows_per_block`` is the number of images it takes, window
w = img·nW + j of each. The result does not depend on it.

Any N runs (64-row query and key tiles; above 64, two passes over the key
tiles, so P is still normalised before its cast). The tensor-core kernel
is instantiated for d in ``HEAD_DIMS``; any other d up to 128 is
zero-padded to the next of them on the card, with the scale of the true d
(exact: zero columns add nothing to QKᵀ, and the padded output columns are
dropped). Above 128, d is zero-padded to a multiple of 64 and runs on a
SIMT kernel of the same source (``csrc/wide_attn.cuh``: 128 output
columns a CTA, the scores summed over 64-column chunks), with the same
CTA walk, additive-tile reuse and rounding.

Dispatch is by where the tensors lie, nothing else: a CUDA tensor
launches the kernel or raises (a card below sm_90, a build failure, a
launch error, a shape the kernel does not take); a CPU tensor takes the
plain version ``window_attention_plain``. There is no fallback from one
to the other.

The kernel is bound as one ``torch.library`` op, ``dltpu::window_attn``,
with a fake implementation, so ``torch.export``
and fake-mode traces show each launch as one node. It is differentiable
(``register_autograd``), so ``window_attention_checkpointed``, the
differentiable form in JAX, is the same call: its forward is the kernel,
its backward recomputes the gradients of
``ops/window_utils.windowed_attention_reference`` (the model's unfused
path) for qkv and bias; the mask gets none. The backward's oracle is that
reference, not the kernel's plain version: the JAX package has no
backward kernel for window attention, and neither has the port.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from .kernels import define_op, kernel_head_dim
from .window_utils import windowed_attention_reference

__all__ = ["window_attention", "window_attention_checkpointed",
           "window_attention_plain", "launch_counts", "reset_launch_counts",
           "flops", "min_bytes", "KERNEL_NAME", "HEAD_DIMS"]

KERNEL_NAME = "window_attn_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# bumped right after a successful launch, nowhere else: a run proves it
# went through the kernel by reading it
_LAUNCHES: Dict[str, int] = {KERNEL_NAME: 0}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
_CAPABILITY: Dict[int, Tuple[int, int]] = {}


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        _LAUNCHES[KERNEL_NAME] = 0


# ---------------------------------------------------------- plain version
def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch on any device: the CPU
    path of ``window_attention`` and the yardstick the kernel is held
    against on the card. Products take their operands to float32 (bf16
    products are exact there), as the kernel's float32 accumulation does.
    ``scale`` defaults to d^-½."""
    bw, n, _, heads, d = qkv.shape
    scale = d ** -0.5 if scale is None else float(scale)
    ct = torch.float64 if qkv.dtype == torch.float64 else torch.float32
    q, k, v = qkv.unbind(2)                               # (BW, N, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    s = s + bias.to(ct)[None]
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(bw // nw, nw, heads, n, n) + mask.to(ct)[None, :, None]
        s = s.reshape(bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(ct)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    return out.reshape(bw, n, heads * d).to(qkv.dtype)


# ------------------------------------------------------------ the kernel
def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .kernels import build
            lib = build.load("window_attn_fwd")
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.window_attn_fwd.argtypes = (
                [vp] * 4 + [i32] * 6 + [i64] * 6 + [ctypes.c_float, i32, vp])
            lib.window_attn_fwd.restype = i32
            lib.window_attn_error_string.argtypes = [i32]
            lib.window_attn_error_string.restype = ctypes.c_char_p
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
            f"the window-attention kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} is sm_{cap[0]}{cap[1]}")


def _aligned(qkv: torch.Tensor) -> torch.Tensor:
    """The kernel moves 16-byte vectors: base and strides must be 16-byte
    multiples. A view that is not gets a fresh (aligned) copy."""
    vec = 16 // qkv.element_size()
    if qkv.stride(-1) != 1 or qkv.data_ptr() % 16 or any(
            s % vec for s in qkv.stride()[:4]):
        return qkv.contiguous()
    return qkv


def _kernel_head_dim(d: int) -> int:
    """The head dim a d runs at: an instantiated one up to 128, a
    multiple of 64 above."""
    return kernel_head_dim(d, HEAD_DIMS, KERNEL_NAME)


def _launch(qkv: torch.Tensor, bias: torch.Tensor,
            mask: Optional[torch.Tensor],
            windows_per_block: int) -> torch.Tensor:
    """Run the kernel on CUDA tensors; qkv's d zero-padded to the next
    instantiated head dim, with the scale of the true d."""
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_attn_fwd takes float32 or bfloat16, got "
                         f"{qkv.dtype}")
    _check_card(qkv.device)
    wpb = max(int(windows_per_block), 1)
    return _at_kernel_head_dim(
        qkv, lambda x, scale: _launch_kernel(x, bias, mask, wpb, scale))


def _at_kernel_head_dim(qkv: torch.Tensor, run) -> torch.Tensor:
    """``run(x, scale)`` on qkv with d zero-padded to the kernel's head dim
    (x is qkv itself where d is instantiated) and the scale of the true d,
    never the padded one's; its (BW, N, heads·d_kernel) result sliced back
    to (BW, N, heads·d)."""
    bw, n, _, heads, d = qkv.shape
    d_kernel = _kernel_head_dim(d)
    if d_kernel == d:
        return run(qkv, d ** -0.5)
    out = run(torch.nn.functional.pad(qkv, (0, d_kernel - d)), d ** -0.5)
    return out.view(bw, n, heads, d_kernel)[..., :d].reshape(bw, n,
                                                             heads * d)


def _launch_kernel(qkv, bias, mask, wpb: int, scale: float) -> torch.Tensor:
    bw, n, _, heads, d = qkv.shape
    qkv = _aligned(qkv)
    bias = bias.detach().to(torch.float32).contiguous()
    nw = 1
    if mask is not None:
        mask = mask.detach().to(torch.float32).contiguous()
        nw = mask.shape[0]
    out = torch.empty((bw, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    if bw == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        lib = _lib()
        rc = lib.window_attn_fwd(
            qkv.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            bw, n, heads, d, nw, wpb,
            *qkv.stride()[:4], out.stride(0), out.stride(1),
            float(scale), _DTYPE_CODE[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"window_attn_fwd launch failed ({rc}): "
            f"{lib.window_attn_error_string(rc).decode()}")
    with _COUNT_LOCK:
        _LAUNCHES[KERNEL_NAME] += 1
    return out


def _check_args(qkv: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor]) -> None:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (BW, N, 3, heads, d), got "
                         f"{tuple(qkv.shape)}")
    bw, n, _, heads, _ = qkv.shape
    if tuple(bias.shape) != (heads, n, n):
        raise ValueError(f"bias must be (heads, N, N) = {(heads, n, n)}, "
                         f"got {tuple(bias.shape)}")
    tensors = [qkv, bias]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) \
                or bw % mask.shape[0]:
            raise ValueError(f"mask must be (nW, N, N) with nW dividing "
                             f"BW={bw}, got {tuple(mask.shape)}")
        tensors.append(mask)
    if any(t.device != qkv.device for t in tensors):
        raise ValueError("qkv, bias and mask must lie on one device")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no window attention for device {qkv.device}")


# --------------------------------------------------------- the custom op
# K2 is one ``torch.library`` op, ``dltpu::window_attn``
# (``kernels.define_op``): the only binding, for eager runs,
# ``torch.export`` and fake-mode traces alike. The real implementation
# dispatches by where the tensors lie (the plain version on the CPU; on
# the card the kernel, and the checks that need a card); the fake one
# gives the real one's (BW, N, heads·d) contiguous result and launches
# nothing.
def _window_attn_impl(qkv, bias, mask, windows_per_block):
    _check_args(qkv, bias, mask)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask).contiguous()
    return _launch(qkv, bias, mask, windows_per_block)


def _window_attn_fake(qkv, bias, mask, windows_per_block):
    _check_args(qkv, bias, mask)
    bw, n, _, heads, d = qkv.shape
    return qkv.new_empty((bw, n, heads * d))


def _setup(ctx, inputs, output) -> None:
    qkv, bias, mask, _ = inputs
    ctx.save_for_backward(qkv, bias)
    ctx.mask = mask


def _backward(ctx, g):
    """The backward recomputes the unfused reference (the counterpart of
    the JAX ``custom_vjp``); the mask gets no gradient."""
    qkv, bias = ctx.saved_tensors
    with torch.enable_grad():
        a = qkv.detach().requires_grad_()
        b = bias.detach().requires_grad_()
        out = windowed_attention_reference(a, b, ctx.mask)
        dqkv, dbias = torch.autograd.grad(out, (a, b), g)
    return dqkv, dbias, None, None


_WINDOW_ATTN = define_op(
    "window_attn(Tensor qkv, Tensor bias, Tensor? mask, "
    "int windows_per_block) -> Tensor",
    _window_attn_impl, _window_attn_fake, backward=_backward,
    setup_context=_setup)


# ---------------------------------------------------------- entry points
def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     windows_per_block: int = 8) -> torch.Tensor:
    """Fused attention over partitioned windows: one
    ``dltpu::window_attn`` call.

    qkv:  (BW, N, 3, heads, d), BW = batch * num_windows, N = window².
    bias: (heads, N, N) relative-position bias.
    mask: (nW, N, N) additive shift mask or None.
    Returns (BW, N, heads*d).
    """
    return _WINDOW_ATTN(qkv, bias, mask, max(int(windows_per_block), 1))


def window_attention_checkpointed(qkv: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None,
                                  **kw) -> torch.Tensor:
    """Differentiable ``window_attention``: the forward runs the kernel;
    the backward recomputes through ``windowed_attention_reference``
    (which does hold each window's P during the backward: the fused saving
    is the forward's only)."""
    windows_per_block = kw.pop("windows_per_block", 8)
    if kw:
        raise TypeError(f"unexpected keywords {sorted(kw)}")
    mask = mask.detach() if mask is not None else None
    return window_attention(qkv, bias, mask, windows_per_block)


def flops(bw: int, n: int, heads: int, d: int) -> float:
    """Operations of the two products, 2 per multiply-add."""
    return 4.0 * bw * heads * n * n * d


def min_bytes(bw: int, n: int, heads: int, d: int, itemsize: int,
              nw: int = 0) -> int:
    """q, k, v read once and O written once, in the input dtype, plus the
    float32 bias (heads, N, N) and mask (nW, N, N; ``nw`` = 0 for none)
    read once."""
    return 4 * bw * n * heads * d * itemsize + 4 * (heads + nw) * n * n
