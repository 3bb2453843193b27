"""Block-scaled int8 quantization — the port of the quantizers of
``deeplearning_tpu/parallel/collectives.py`` (``_pad_to``,
``_quantize_blocks``, ``_dequantize_blocks``).

Each block of 256 consecutive elements shares one float32 scale
``s = exp2(ceil(log2(max(max|x|, 1e-30) / 127)))`` and stores
``clip(round(x / s), -127, 127)`` as int8, so a tensor costs about one
byte an element plus 4/256 for the scales. The serving engine's int8
weight residency (``serve/engine.py``) is the one user so far; the
quantized collectives themselves (reduce-scatter, all-gather, psum) come
with multi-GPU (ROADMAP Queue 1 item 7).

The scale is computed as XLA computes it on the CPU, so that the port's
payloads and scales equal the JAX package's: ``log2(y)`` is
``log(y) / log(2)`` in float32 and ``exp2(k)`` is ``exp(log(2) * k)``,
which puts a scale a few ulps off ``2**k`` (``2**13`` comes out
8192.0039). The logarithm and the exponential are taken in float64 and
rounded once, which XLA's float32 ``exp`` matches at every exponent the
1e-30 floor allows; where ``max|x| / 127`` is exactly a power of two,
XLA's ``log`` may round across the integer and the ceilings can differ.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["_pad_to", "_quantize_blocks", "_dequantize_blocks"]

_QMAX = 127.0
_TINY = 1e-30        # floor before log2: an all-zero block gets 2^-106
_LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)


def _quantize_blocks(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., block) float32 -> int8 payload and a (..., 1) float32 scale
    a block."""
    xb = xb.to(torch.float32)
    maxabs = xb.abs().amax(dim=-1, keepdim=True)
    y = torch.clamp_min(maxabs, _TINY) / _QMAX
    ln2 = _LN2.to(xb.device)
    k = torch.ceil(torch.log(y.double()).float() / ln2)
    s = torch.exp((ln2 * k).double()).float()
    q = torch.clamp(torch.round(xb / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def _dequantize_blocks(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis up to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad
