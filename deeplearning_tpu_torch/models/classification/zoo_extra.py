"""Happy-Whale modelZoo backbones — the port of
``deeplearning_tpu/models/classification/zoo_extra.py``: Xception,
Inception-v4, DPN-68 / DPN-92, NASNet-A mobile, PolyNet and SENet-154.

Same modules, flax names and factories, so a flax tree converts one to
one (``utils/convert.from_flax_params``; a depthwise or grouped kernel
(kh, kw, cin / groups, cout) becomes the (cout, cin / groups, kh, kw)
weight of its grouped ``Conv2d``). The input is NHWC and ``dtype`` the
compute type over float32 parameters; the logits come back in float32.
The backbones run in contiguous NCHW, as the zoo's other depthwise
families do: the input is copied once into that layout. On a
channels-last view their depthwise and grouped convolutions took seconds
on the card on their first call at each shape (NASNet-A's first train
step, PERF.md §6, PR 21).

Every conv and pool pads as flax's ``padding="SAME"``: symmetrically at
stride 1 (the conv or pool pads), and at stride 2 with the odd pixel
after (``layers.pad_same``, which takes the (1, 7) / (7, 1) / (1, 3) /
(3, 1) kernels too). The average pools divide by the real pixels of each
window (flax's ``count_include_pad=False``), at stride 2 as well.
BatchNorm is flax's ``momentum=0.9`` (torch's 0.1) with epsilon 1e-5.

flax infers each layer's input width at init; the port builds them up
front, so every module takes its input channels and every factory takes
``in_chans`` (default 3). No parameter shape follows the input size:
each head follows a global mean.

NASNet's ``FitReduce`` halves a cell's previous input when that input
is one reduction behind the current one; flax decides from the runtime
shapes, which the port cannot, so it fixes each flag from the cell
sequence. That is flax's tree at any input of at least 17² (below it a
stride-2 reduction of a 1- or 2-pixel map leaves the size as it was and
flax's flags change), and the model refuses a smaller input.

PolyNet's poly-2 units apply one shared residual function twice, so in a
train-mode forward its BatchNorms move their running statistics twice,
as flax's do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ..layers import conv, dense, init_flax_, max_pool, pad_same
from .resnet import SEModule, norm_layer

__all__ = ["ConvBN", "SepConvBN", "XceptionBlock", "Xception",
           "InceptionA", "InceptionB", "InceptionC", "InceptionV4",
           "DualPathBlock", "DPN", "FitReduce", "NormalCell",
           "ReductionCell", "NASNetA", "InceptionResUnit", "PolyBlock",
           "PolyNet", "SEBottleneck", "SENet154"]

_BF16 = torch.bfloat16


class ConvBN(nn.Module):
    """conv → BN [→ relu], the building unit every zoo backbone shares."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3), stride: int = 1,
                 groups: int = 1, relu: bool = True,
                 dtype: torch.dtype = _BF16):
        super().__init__()
        kh, kw = kernel
        self.kernel, self.stride, self.relu, self.dtype = (
            (kh, kw), stride, relu, dtype)
        # "SAME" at stride 1 is symmetric: the conv pads it itself
        pad = ((kh - 1) // 2, (kw - 1) // 2) if stride == 1 else 0
        self.conv = nn.Conv2d(cin, features, (kh, kw), stride, pad,
                              groups=groups, bias=False)
        self.bn = norm_layer(dtype)(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = pad_same(x, self.kernel, self.stride)
        x = self.bn(conv(x, self.conv, self.dtype))
        return F.relu(x) if self.relu else x


class SepConvBN(nn.Module):
    """Depthwise k x k + pointwise, then BN (Xception / NASNet separable
    unit)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = _BF16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.dw = nn.Conv2d(cin, cin, kernel, stride,
                            kernel // 2 if stride == 1 else 0, groups=cin,
                            bias=False)
        self.pw = nn.Conv2d(cin, features, 1, bias=False)
        self.bn = norm_layer(dtype)(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = pad_same(x, self.kernel, self.stride)
        x = conv(conv(x, self.dw, self.dtype), self.pw, self.dtype)
        return self.bn(x)


def _pool(x: torch.Tensor, kind: str, stride: int = 1) -> torch.Tensor:
    """flax's 3x3 "SAME" max or average pool; the average divides by the
    real pixels of each window."""
    if stride == 1:
        if kind == "max":
            return F.max_pool2d(x, 3, 1, 1)
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    if kind == "max":
        return max_pool(x, 3, stride, "SAME")
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    total = F.avg_pool2d(pad_same(x, 3, stride), 3, stride,
                         divisor_override=1)
    count = F.avg_pool2d(pad_same(ones, 3, stride), 3, stride,
                         divisor_override=1)
    return total / count


class _Classifier(nn.Module):
    """The head every backbone ends in: the global mean, a Dense in the
    compute dtype, float32 logits. Subclasses set ``dtype`` and ``head``
    and define ``features`` (NCHW in, NCHW out)."""

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        del rng                   # no dropout in these families
        x = self.features(x.permute(0, 3, 1, 2).to(
            self.dtype, memory_format=torch.contiguous_format))
        return dense(x.mean(dim=(2, 3)), self.head, self.dtype).float()

    def _init(self, generator: Optional[torch.Generator]) -> None:
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- Xception

class XceptionBlock(nn.Module):
    """relu → sepconv × reps with a residual 1x1 projection (xception.py
    Block)."""

    def __init__(self, cin: int, features: int, reps: int, stride: int = 1,
                 grow_first: bool = True, dtype: torch.dtype = _BF16):
        super().__init__()
        self.reps, self.stride = reps, stride
        self.skip = (ConvBN(cin, features, (1, 1), stride, relu=False,
                            dtype=dtype)
                     if stride != 1 or cin != features else None)
        c = feats = cin
        for i in range(reps):
            if grow_first or i > 0:
                feats = features
            setattr(self, f"sep{i}", SepConvBN(c, feats, dtype=dtype))
            c = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.skip is None else self.skip(x)
        y = x
        for i in range(self.reps):
            y = getattr(self, f"sep{i}")(F.relu(y))
        if self.stride != 1:
            y = max_pool(y, 3, self.stride, "SAME")
        return y + res


class Xception(_Classifier):
    """Entry / middle / exit flows (xception.py:1-194)."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = _BF16,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem1 = ConvBN(in_chans, 32, (3, 3), 2, dtype=dtype)
        self.stem2 = ConvBN(32, 64, dtype=dtype)
        c = 64
        for i, (f, s) in enumerate([(128, 2), (256, 2), (728, 2)]):
            setattr(self, f"entry{i}", XceptionBlock(c, f, 2, s,
                                                     dtype=dtype))
            c = f
        for i in range(8):
            setattr(self, f"mid{i}", XceptionBlock(728, 728, 3, 1,
                                                   dtype=dtype))
        self.exit0 = XceptionBlock(728, 1024, 2, 2, grow_first=False,
                                   dtype=dtype)
        self.exit1 = SepConvBN(1024, 1536, dtype=dtype)
        self.exit2 = SepConvBN(1536, 2048, dtype=dtype)
        self.head = nn.Linear(2048, num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem2(self.stem1(x))
        for name in [f"entry{i}" for i in range(3)] + \
                [f"mid{i}" for i in range(8)] + ["exit0"]:
            x = getattr(self, name)(x)
        return F.relu(self.exit2(F.relu(self.exit1(x))))


# ------------------------------------------------------------- InceptionV4

class InceptionA(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.b0 = ConvBN(cin, 96, (1, 1), dtype=dtype)
        self.b1a = ConvBN(cin, 64, (1, 1), dtype=dtype)
        self.b1b = ConvBN(64, 96, (3, 3), dtype=dtype)
        self.b2a = ConvBN(cin, 64, (1, 1), dtype=dtype)
        self.b2b = ConvBN(64, 96, (3, 3), dtype=dtype)
        self.b2c = ConvBN(96, 96, (3, 3), dtype=dtype)
        self.b3 = ConvBN(cin, 96, (1, 1), dtype=dtype)
        self.out_channels = 384

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2c(self.b2b(self.b2a(x))),
                          self.b3(_pool(x, "avg"))], dim=1)


class InceptionB(nn.Module):
    # b2's chain: (features, kernel) of b20 ... b24
    _B2 = ((192, (1, 1)), (192, (7, 1)), (224, (1, 7)), (224, (7, 1)),
           (256, (1, 7)))

    def __init__(self, cin: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.b0 = ConvBN(cin, 384, (1, 1), dtype=dtype)
        self.b1a = ConvBN(cin, 192, (1, 1), dtype=dtype)
        self.b1b = ConvBN(192, 224, (1, 7), dtype=dtype)
        self.b1c = ConvBN(224, 256, (7, 1), dtype=dtype)
        c = cin
        for i, (f, k) in enumerate(self._B2):
            setattr(self, f"b2{i}", ConvBN(c, f, k, dtype=dtype))
            c = f
        self.b3 = ConvBN(cin, 128, (1, 1), dtype=dtype)
        self.out_channels = 384 + 256 + 256 + 128

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = x
        for i in range(len(self._B2)):
            b2 = getattr(self, f"b2{i}")(b2)
        return torch.cat([self.b0(x), self.b1c(self.b1b(self.b1a(x))), b2,
                          self.b3(_pool(x, "avg"))], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.b0 = ConvBN(cin, 256, (1, 1), dtype=dtype)
        self.b1a = ConvBN(cin, 384, (1, 1), dtype=dtype)
        self.b1b = ConvBN(384, 256, (1, 3), dtype=dtype)
        self.b1c = ConvBN(384, 256, (3, 1), dtype=dtype)
        self.b2z = ConvBN(cin, 384, (1, 1), dtype=dtype)
        self.b2a = ConvBN(384, 448, (3, 1), dtype=dtype)
        self.b2b = ConvBN(448, 512, (1, 3), dtype=dtype)
        self.b2c = ConvBN(512, 256, (1, 3), dtype=dtype)
        self.b2d = ConvBN(512, 256, (3, 1), dtype=dtype)
        self.b3 = ConvBN(cin, 256, (1, 1), dtype=dtype)
        self.out_channels = 256 * 6

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.b1a(x)
        b2 = self.b2b(self.b2a(self.b2z(x)))
        return torch.cat([self.b0(x), self.b1b(b1), self.b1c(b1),
                          self.b2c(b2), self.b2d(b2),
                          self.b3(_pool(x, "avg"))], dim=1)


class InceptionV4(_Classifier):
    """Stem + 4A + RedA + 7B + RedB + 3C (inceptionV4.py:1-335)."""

    def __init__(self, num_classes: int = 1000,
                 blocks: Tuple[int, int, int] = (4, 7, 3),
                 dtype: torch.dtype = _BF16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks, self.dtype = tuple(blocks), dtype

        def cb(cin, f, k, s=1):
            return ConvBN(cin, f, k, s, dtype=dtype)
        self.s1 = cb(in_chans, 32, (3, 3), 2)
        self.s2 = cb(32, 32, (3, 3))
        self.s3 = cb(32, 64, (3, 3))
        self.s4 = cb(64, 96, (3, 3), 2)
        self.s5a = cb(160, 64, (1, 1))
        self.s5b = cb(64, 96, (3, 3))
        c = 160
        for i, (f, k) in enumerate([(64, (1, 1)), (64, (1, 7)),
                                    (64, (7, 1)), (96, (3, 3))]):
            setattr(self, f"s6{i}", cb(c, f, k))
            c = f
        self.s7 = cb(192, 192, (3, 3), 2)
        c = 384
        for i in range(self.blocks[0]):
            setattr(self, f"a{i}", InceptionA(c, dtype))
        self.ra0 = cb(c, 384, (3, 3), 2)
        self.ra1a = cb(c, 192, (1, 1))
        self.ra1b = cb(192, 224, (3, 3))
        self.ra1c = cb(224, 256, (3, 3), 2)
        c = 384 + 256 + c
        for i in range(self.blocks[1]):
            setattr(self, f"b{i}", InceptionB(c, dtype))
            c = getattr(self, f"b{i}").out_channels
        self.rb0a = cb(c, 192, (1, 1))
        self.rb0b = cb(192, 192, (3, 3), 2)
        self.rb1a = cb(c, 256, (1, 1))
        self.rb1b = cb(256, 256, (1, 7))
        self.rb1c = cb(256, 320, (7, 1))
        self.rb1d = cb(320, 320, (3, 3), 2)
        c = 192 + 320 + c
        for i in range(self.blocks[2]):
            setattr(self, f"c{i}", InceptionC(c, dtype))
            c = getattr(self, f"c{i}").out_channels
        self.head = nn.Linear(c, num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.s3(self.s2(self.s1(x)))
        x = torch.cat([max_pool(x, 3, 2, "SAME"), self.s4(x)], dim=1)
        b = x
        for i in range(4):
            b = getattr(self, f"s6{i}")(b)
        x = torch.cat([self.s5b(self.s5a(x)), b], dim=1)
        x = torch.cat([self.s7(x), max_pool(x, 3, 2, "SAME")], dim=1)
        for i in range(self.blocks[0]):
            x = getattr(self, f"a{i}")(x)
        x = torch.cat([self.ra0(x), self.ra1c(self.ra1b(self.ra1a(x))),
                       max_pool(x, 3, 2, "SAME")], dim=1)
        for i in range(self.blocks[1]):
            x = getattr(self, f"b{i}")(x)
        x = torch.cat([self.rb0b(self.rb0a(x)),
                       self.rb1d(self.rb1c(self.rb1b(self.rb1a(x)))),
                       max_pool(x, 3, 2, "SAME")], dim=1)
        for i in range(self.blocks[2]):
            x = getattr(self, f"c{i}")(x)
        return x


# -------------------------------------------------------------------- DPN

class DualPathBlock(nn.Module):
    """1x1 → grouped 3x3 → 1x1 with the output split across a residual
    path (first ``bw`` channels, added) and a dense path (last ``inc``
    channels, concatenated) — dpn.py DualPathBlock."""

    def __init__(self, cin: int, r: int, bw: int, inc: int, groups: int,
                 stride: int = 1, has_proj: bool = False,
                 dtype: torch.dtype = _BF16):
        super().__init__()
        self.bw = bw
        self.proj = (ConvBN(cin, bw + 2 * inc, (1, 1), stride, relu=False,
                            dtype=dtype) if has_proj else None)
        self.c1 = ConvBN(cin, r, (1, 1), dtype=dtype)
        self.c2 = ConvBN(r, r, (3, 3), stride, groups=groups, dtype=dtype)
        self.c3 = ConvBN(r, bw + inc, (1, 1), relu=False, dtype=dtype)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        res, dense_path = carry
        x = torch.cat([res, dense_path], dim=1)
        if self.proj is not None:
            p = self.proj(x)
            res, dense_path = p[:, :self.bw], p[:, self.bw:]
        y = self.c3(self.c2(self.c1(x)))
        return (res + y[:, :self.bw],
                torch.cat([dense_path, y[:, self.bw:]], dim=1))


class DPN(_Classifier):
    """Dual Path Network (dpn.py:1-381). ``k_sec`` blocks a stage; stage s
    has residual width bw0·2^s, bottleneck r0·2^s, dense growth inc[s]."""

    def __init__(self, num_classes: int = 1000,
                 k_sec: Sequence[int] = (3, 4, 20, 3),
                 inc_sec: Sequence[int] = (16, 32, 24, 128), r0: int = 96,
                 bw0: int = 256, groups: int = 32, stem: int = 64,
                 dtype: torch.dtype = _BF16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = ConvBN(in_chans, stem, (7, 7), 2, dtype=dtype)
        self._blocks: List[str] = []
        res_c, dense_c = stem, 0
        for s, (n, inc) in enumerate(zip(k_sec, inc_sec)):
            bw, r = bw0 * 2 ** s, r0 * 2 ** s
            for i in range(n):
                name = f"s{s}b{i}"
                setattr(self, name, DualPathBlock(
                    res_c + dense_c, r, bw, inc, groups,
                    stride=2 if (i == 0 and s > 0) else 1,
                    has_proj=(i == 0), dtype=dtype))
                self._blocks.append(name)
                if i == 0:
                    dense_c = 2 * inc
                res_c, dense_c = bw, dense_c + inc
        self.head = nn.Linear(res_c + dense_c, num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.stem(x), 3, 2, "SAME")
        carry = (x, x[:, :0])
        for name in self._blocks:
            carry = getattr(self, name)(carry)
        return F.relu(torch.cat(carry, dim=1))


# ----------------------------------------------------------------- NASNet

class FitReduce(nn.Module):
    """1x1 fit of a cell input to ``features``; with ``reduce``, the
    factorized stride-2 reduction of an input one reduction behind
    (nasnet.py CellStem / first-cell path adjustment): two 1x1 convs over
    the even and the odd pixels, the odd half zero-padded at the end."""

    def __init__(self, cin: int, features: int, reduce: bool = False,
                 dtype: torch.dtype = _BF16):
        super().__init__()
        self.reduce, self.dtype = reduce, dtype
        if reduce:
            self.p1 = nn.Conv2d(cin, features // 2, 1, bias=False)
            self.p2 = nn.Conv2d(cin, features - features // 2, 1,
                                bias=False)
            self.bn = norm_layer(dtype)(features)
        else:
            self.fit = ConvBN(cin, features, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.reduce:
            return self.fit(x)
        # flax's 1x1 average pools at stride 2 (VALID) pick these pixels
        a = x[:, :, ::2, ::2]
        b = x[:, :, 1::2, 1::2]
        b = F.pad(b, (0, a.shape[3] - b.shape[3], 0, a.shape[2] - b.shape[2]))
        return self.bn(torch.cat([conv(F.relu(a), self.p1, self.dtype),
                                  conv(F.relu(b), self.p2, self.dtype)],
                                 dim=1))


class NormalCell(nn.Module):
    """NASNet-A normal cell: 5 pairwise combines over (h, h_prev)
    (nasnet.py NormalCell; wiring per the NASNet-A paper figure)."""

    def __init__(self, cin: int, cin_prev: int, features: int,
                 reduce_prev: bool, dtype: torch.dtype = _BF16):
        super().__init__()
        f = features
        self.fit_h = FitReduce(cin, f, dtype=dtype)
        self.fit_hp = FitReduce(cin_prev, f, reduce_prev, dtype)
        self.c0 = SepConvBN(f, f, 3, dtype=dtype)
        self.c1a = SepConvBN(f, f, 3, dtype=dtype)
        self.c1b = SepConvBN(f, f, 5, dtype=dtype)
        self.c4a = SepConvBN(f, f, 5, dtype=dtype)
        self.c4b = SepConvBN(f, f, 3, dtype=dtype)
        self.out_channels = 6 * f

    def forward(self, h: torch.Tensor, h_prev: torch.Tensor
                ) -> torch.Tensor:
        h = self.fit_h(h)
        hp = self.fit_hp(h_prev)
        c0 = self.c0(h) + h
        c1 = self.c1a(hp) + self.c1b(h)
        c2 = _pool(h, "avg") + hp
        c3 = _pool(hp, "avg") + _pool(hp, "avg")
        c4 = self.c4a(hp) + self.c4b(hp)
        return torch.cat([hp, c0, c1, c2, c3, c4], dim=1)


class ReductionCell(nn.Module):
    """NASNet-A reduction cell (stride-2 combines)."""

    def __init__(self, cin: int, cin_prev: int, features: int,
                 reduce_prev: bool, dtype: torch.dtype = _BF16):
        super().__init__()
        f = features
        self.fit_h = FitReduce(cin, f, dtype=dtype)
        self.fit_hp = FitReduce(cin_prev, f, reduce_prev, dtype)
        self.c0a = SepConvBN(f, f, 7, 2, dtype=dtype)
        self.c0b = SepConvBN(f, f, 5, 2, dtype=dtype)
        self.c1 = SepConvBN(f, f, 7, 2, dtype=dtype)
        self.c2 = SepConvBN(f, f, 5, 2, dtype=dtype)
        self.c3 = SepConvBN(f, f, 3, dtype=dtype)
        self.out_channels = 4 * f

    def forward(self, h: torch.Tensor, h_prev: torch.Tensor
                ) -> torch.Tensor:
        h = self.fit_h(h)
        hp = self.fit_hp(h_prev)
        c0 = self.c0a(hp) + self.c0b(h)
        c1 = _pool(h, "max", 2) + self.c1(hp)
        c2 = _pool(h, "avg", 2) + self.c2(hp)
        c3 = _pool(h, "max", 2) + self.c3(c0)
        c4 = _pool(c0, "avg") + c1
        return torch.cat([c1, c2, c3, c4], dim=1)


class NASNetA(_Classifier):
    """NASNet-A (nasnet.py:1-643): stem → (N normal + reduction) × 3 −
    final reduction, doubling filters at each reduction."""

    MIN_SIZE = 17     # the least input side at which the flags are flax's

    def __init__(self, num_classes: int = 1000, filters: int = 44,
                 n_normal: int = 4, dtype: torch.dtype = _BF16,
                 in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = ConvBN(in_chans, 32, (3, 3), 2, relu=False,
                           dtype=dtype)
        f = filters
        # (channels, reductions behind the input) of h_prev and h: a cell's
        # fit_hp reduces when h_prev is one reduction behind h
        prev, cur = (32, 0), (32, 0)

        def cell(cell_cls, features, reduction):
            nonlocal prev, cur
            c = cell_cls(cur[0], prev[0], features, prev[1] != cur[1],
                         dtype)
            prev, cur = cur, (c.out_channels, cur[1] + reduction)
            return c
        self.stem0 = cell(ReductionCell, f // 2, 1)      # (x, x)
        self.stem1 = cell(ReductionCell, f, 1)           # (h0, x)
        # flax's n{stage}_{i} are n{stage}.{i} here (utils/convert)
        self._cells: List[nn.Module] = []
        for stage in range(3):
            normal = nn.ModuleList(cell(NormalCell, f * 2 ** stage, 0)
                                   for _ in range(n_normal))
            setattr(self, f"n{stage}", normal)
            self._cells += list(normal)
            if stage < 2:
                setattr(self, f"r{stage}", cell(
                    ReductionCell, f * 2 ** (stage + 1), 1))
                self._cells.append(getattr(self, f"r{stage}"))
        self.head = nn.Linear(cur[0], num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        if min(x.shape[2:]) < self.MIN_SIZE:
            raise ValueError(
                f"NASNet-A takes inputs of at least {self.MIN_SIZE}² (its "
                f"cell-input reductions are flax's from there); got "
                f"{tuple(x.shape[2:])}")
        x = self.stem(x)
        h0 = self.stem0(x, x)
        h_prev, h = h0, self.stem1(h0, x)
        for c in self._cells:
            h_prev, h = h, c(h, h_prev)
        return F.relu(h)


# ---------------------------------------------------------------- PolyNet

class InceptionResUnit(nn.Module):
    """Inception-ResNet residual F used inside the poly compositions
    (ployNet.py BlockA/B/C analogs). Returns the residual branch only."""

    def __init__(self, cin: int, kind: str, dtype: torch.dtype = _BF16):
        super().__init__()
        self.kind = kind

        def cb(ci, f, k):
            return ConvBN(ci, f, k, dtype=dtype)
        if kind == "a":
            self.b0 = cb(cin, 32, (1, 1))
            self.b1a, self.b1b = cb(cin, 32, (1, 1)), cb(32, 32, (3, 3))
            self.b2a, self.b2b = cb(cin, 32, (1, 1)), cb(32, 48, (3, 3))
            self.b2c = cb(48, 64, (3, 3))
            width = 32 + 32 + 64
        elif kind == "b":
            self.b0 = cb(cin, 192, (1, 1))
            self.b1a, self.b1b = cb(cin, 128, (1, 1)), cb(128, 160, (1, 7))
            self.b1c = cb(160, 192, (7, 1))
            width = 192 + 192
        else:
            self.b0 = cb(cin, 192, (1, 1))
            self.b1a, self.b1b = cb(cin, 192, (1, 1)), cb(192, 224, (1, 3))
            self.b1c = cb(224, 256, (3, 1))
            width = 192 + 256
        self.proj = ConvBN(width, cin, (1, 1), relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "a":
            y = [self.b0(x), self.b1b(self.b1a(x)),
                 self.b2c(self.b2b(self.b2a(x)))]
        else:
            y = [self.b0(x), self.b1c(self.b1b(self.b1a(x)))]
        return self.proj(torch.cat(y, dim=1))


class PolyBlock(nn.Module):
    """Polynomial composition (ployNet.py poly / mpoly / 2-way):
    poly2:  x + F(x) + F(F(x))    (shared F)
    mpoly2: x + F(x) + G(F(x))
    2way:   x + F(x) + G(x)
    with the paper's beta residual scaling."""

    def __init__(self, cin: int, kind: str, mode: str = "poly2",
                 beta: float = 0.3, dtype: torch.dtype = _BF16):
        super().__init__()
        self.mode, self.beta = mode, beta
        self.f = InceptionResUnit(cin, kind, dtype)
        if mode != "poly2":
            self.g = InceptionResUnit(cin, kind, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = self.f(x)
        if self.mode == "poly2":
            second = self.f(F.relu(x + self.beta * fx))
        elif self.mode == "mpoly2":
            second = self.g(F.relu(x + self.beta * fx))
        else:
            second = self.g(x)
        return F.relu(x + self.beta * (fx + second))


class PolyNet(_Classifier):
    """PolyNet (ployNet.py:1-490): inception-resnet-v2 trunk with
    poly-2 / 2-way mixed stages A / B / C."""

    _MODES = ("2way", "poly2", "mpoly2")

    def __init__(self, num_classes: int = 1000,
                 stage_blocks: Tuple[int, int, int] = (10, 10, 5),
                 dtype: torch.dtype = _BF16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_blocks, self.dtype = tuple(stage_blocks), dtype

        def cb(cin, f, k, s=1):
            return ConvBN(cin, f, k, s, dtype=dtype)
        self.s1 = cb(in_chans, 32, (3, 3), 2)
        self.s2 = cb(32, 64, (3, 3))
        self.s3 = cb(64, 80, (1, 1))
        self.s4 = cb(80, 192, (3, 3))
        self.s5 = cb(192, 384, (1, 1))
        c = 384
        for i in range(self.stage_blocks[0]):
            setattr(self, f"a{i}", PolyBlock(c, "a", self._MODES[i % 3],
                                             dtype=dtype))
        self.ra0 = cb(c, 384, (3, 3), 2)
        self.ra1a = cb(c, 256, (1, 1))
        self.ra1b = cb(256, 256, (3, 3))
        self.ra1c = cb(256, 384, (3, 3), 2)
        c = 384 + 384 + c
        for i in range(self.stage_blocks[1]):
            setattr(self, f"b{i}", PolyBlock(c, "b", self._MODES[i % 3],
                                             dtype=dtype))
        self.rb0a = cb(c, 256, (1, 1))
        self.rb0b = cb(256, 384, (3, 3), 2)
        self.rb1a = cb(c, 256, (1, 1))
        self.rb1b = cb(256, 384, (3, 3), 2)
        c = 384 + 384 + c
        for i in range(self.stage_blocks[2]):
            setattr(self, f"c{i}", PolyBlock(c, "c", self._MODES[i % 3],
                                             dtype=dtype))
        self.head = nn.Linear(c, num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.s2(self.s1(x)), 3, 2, "SAME")
        x = max_pool(self.s4(self.s3(x)), 3, 2, "SAME")
        x = self.s5(x)
        for i in range(self.stage_blocks[0]):
            x = getattr(self, f"a{i}")(x)
        x = torch.cat([self.ra0(x), self.ra1c(self.ra1b(self.ra1a(x))),
                       max_pool(x, 3, 2, "SAME")], dim=1)
        for i in range(self.stage_blocks[1]):
            x = getattr(self, f"b{i}")(x)
        x = torch.cat([self.rb0b(self.rb0a(x)), self.rb1b(self.rb1a(x)),
                       max_pool(x, 3, 2, "SAME")], dim=1)
        for i in range(self.stage_blocks[2]):
            x = getattr(self, f"c{i}")(x)
        return x


# -------------------------------------------------------------- SENet-154

class SEBottleneck(nn.Module):
    """SENet-154 bottleneck: double-width 1x1, grouped 3x3, SE(16)
    (senet.py SEBottleneck)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 groups: int = 64, dtype: torch.dtype = _BF16):
        super().__init__()
        out = features * 4
        self.down = (ConvBN(cin, out, (1, 1), stride, relu=False,
                            dtype=dtype)
                     if stride != 1 or cin != out else None)
        self.c1 = ConvBN(cin, features * 2, (1, 1), dtype=dtype)
        self.c2 = ConvBN(features * 2, out, (3, 3), stride, groups=groups,
                         dtype=dtype)
        self.c3 = ConvBN(out, out, (1, 1), relu=False, dtype=dtype)
        self.se = SEModule(out, reduction=16, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.down is None else self.down(x)
        y = self.se(self.c3(self.c2(self.c1(x))))
        return F.relu(y + res)


class SENet154(_Classifier):
    """SENet-154 (senet.py:1-449): 3-conv deep stem + SEBottleneck stages
    (3, 8, 36, 3)."""

    def __init__(self, num_classes: int = 1000,
                 blocks: Sequence[int] = (3, 8, 36, 3),
                 dtype: torch.dtype = _BF16, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.s1 = ConvBN(in_chans, 64, (3, 3), 2, dtype=dtype)
        self.s2 = ConvBN(64, 64, dtype=dtype)
        self.s3 = ConvBN(64, 128, dtype=dtype)
        self._blocks: List[str] = []
        c = 128
        for s, n in enumerate(blocks):
            for i in range(n):
                name = f"s{s}b{i}"
                setattr(self, name, SEBottleneck(
                    c, 64 * 2 ** s, stride=2 if (i == 0 and s > 0) else 1,
                    dtype=dtype))
                self._blocks.append(name)
                c = 64 * 2 ** s * 4
        self.head = nn.Linear(c, num_classes)
        self._init(generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.s3(self.s2(self.s1(x))), 3, 2, "SAME")
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x


@MODELS.register("xception")
def xception(num_classes: int = 1000, **kw):
    return Xception(num_classes=num_classes, **kw)


@MODELS.register("inception_v4")
def inception_v4(num_classes: int = 1000, **kw):
    return InceptionV4(num_classes=num_classes, **kw)


@MODELS.register("dpn92")
def dpn92(num_classes: int = 1000, **kw):
    return DPN(num_classes=num_classes, **kw)


@MODELS.register("dpn68")
def dpn68(num_classes: int = 1000, **kw):
    cfg = dict(k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64), r0=32,
               bw0=64, stem=16, groups=32)
    cfg.update(kw)
    return DPN(num_classes=num_classes, **cfg)


@MODELS.register("nasnet_a_mobile")
def nasnet_a_mobile(num_classes: int = 1000, **kw):
    return NASNetA(num_classes=num_classes, **kw)


@MODELS.register("polynet")
def polynet(num_classes: int = 1000, **kw):
    return PolyNet(num_classes=num_classes, **kw)


@MODELS.register("senet154")
def senet154(num_classes: int = 1000, **kw):
    return SENet154(num_classes=num_classes, **kw)
