"""YOLOX: the port of ``deeplearning_tpu/models/detection/yolox.py``:
the networks, the decode, the postprocess, SimOTA and the loss.

Same classes, structure and parameter names as the flax modules, so a flax
tree converts one to one (``utils/convert.from_flax_params`` with the
model as ``like``: conv kernels HWIO → OIHW, ``batch_stats`` mean/var →
the BatchNorm buffers). A flax name ending in ``_<i>`` is item ``i`` of a
``ModuleList`` here (``head/cls0_1`` → ``head.cls0.1``), as the converter
maps it.

As in JAX the input is NHWC float32 and ``dtype`` is the compute type over
float32 parameters (bf16 by default); the head's output comes back in
float32 as (B, A, 5 + C) rows of (x, y, w, h, obj, cls…) with the anchors
of each level in row-major (y, x) order, levels at strides 8, 16, 32. The
convolutions run in NCHW on a channels-last view of the input (no copy);
each head level permutes back to NHWC before the reshape that enumerates
its anchors, so row ``a`` is anchor ``a`` of ``yolox_grid``.

Layer semantics carried over: symmetric k//2 padding, BatchNorm with eps
1e-3 and flax's momentum 0.97 (torch 0.03) whose statistics and affine map
run in float32, SPP max-pools at stride 1 padded with -inf, 2× nearest
upsampling, a Bottleneck shortcut only when the channels match, PAFPN's
CSP layers without shortcut, and cls/obj biases initialised at −log(99).

``simota_assign`` is the fixed-shape SimOTA of the JAX package, batched
over the images: candidates gated by in-box or in-centre, cost = class
BCE + 3·(−log IoU) + 1e5 for a non-candidate + 1e5 for an anchor not in
both gates, dynamic k from the top-10 candidate IoUs (summed, truncated,
at least 1), a stable sort of each gt's costs ranked with a scatter (so
equal float32 costs keep the anchor order, as ``jnp.argsort`` does), and
an anchor claimed by several gts kept by the cheapest (first on ties). It
runs in float32 under ``no_grad`` on detached boxes and never leaves the
device. ``yolox_loss`` is the IoU² loss (×5), the objectness BCE summed
over anchors, the class BCE against IoU-scaled one-hots summed over the
positives, and with ``use_l1`` the L1 loss on the raw deltas, each over
the batch's positives (at least 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.registry import MODELS
from ...ops import boxes as box_ops
from ...ops import losses as L
from ...ops import nms as nms_ops
from ..layers import BatchNorm, calibrate_batchnorm, lecun_normal_
from ..layers import conv as _conv

__all__ = ["STRIDES", "ConvBnSiLU", "Bottleneck", "CSPLayer",
           "SPPBottleneck", "CSPDarknet", "PAFPN", "ResLayer", "Darknet53",
           "YOLOFPN", "YOLOXHead", "YOLOX", "yolox_grid", "decode_outputs",
           "simota_assign", "yolox_loss", "yolox_postprocess",
           "postprocess_decoded", "calibrate_batchnorm"]

STRIDES = (8, 16, 32)
_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class ConvBnSiLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.bfloat16, act: str = "silu"):
        super().__init__()
        # torch autopad: k//2 on every side (SAME would pad (0, 1) at
        # stride 2 and shift the sampling centres)
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(features, dtype, eps=1e-3, momentum=0.03)
        self.dtype, self.act = dtype, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(_conv(x, self.conv, self.dtype))
        return F.leaky_relu(x, 0.1) if self.act == "lrelu" else F.silu(x)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c1 = ConvBnSiLU(cin, features, 1, dtype=dtype)
        self.c2 = ConvBnSiLU(features, features, 3, dtype=dtype)
        self.add = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        return x + y if self.add else y


class CSPLayer(nn.Module):
    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        half = features // 2
        self.main = ConvBnSiLU(cin, half, 1, dtype=dtype)
        self.skip = ConvBnSiLU(cin, half, 1, dtype=dtype)
        self.n = n
        for i in range(n):
            setattr(self, f"b{i}", Bottleneck(half, half, shortcut, dtype))
        self.out = ConvBnSiLU(2 * half, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.main(x)
        b = self.skip(x)
        for i in range(self.n):
            a = getattr(self, f"b{i}")(a)
        return self.out(torch.cat([a, b], dim=1))


def _spp_pools(x: torch.Tensor) -> torch.Tensor:
    """[x, maxpool 5, 9, 13] at stride 1, "SAME" (−inf padding k//2)."""
    return torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                            for k in (5, 9, 13)], dim=1)


class SPPBottleneck(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pre = ConvBnSiLU(cin, features // 2, 1, dtype=dtype)
        self.post = ConvBnSiLU(features // 2 * 4, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post(_spp_pools(self.pre(x)))


class CSPDarknet(nn.Module):
    """Focus stem, CSP stages and SPP; returns c3, c4, c5 (NCHW)."""

    def __init__(self, depth_mult: float = 0.33, width_mult: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def w(c):
            return int(c * width_mult)

        def d(n):
            return max(int(round(n * depth_mult)), 1)
        self.dtype = dtype
        self.stem = ConvBnSiLU(12, w(64), 3, dtype=dtype)
        self.d2_conv = ConvBnSiLU(w(64), w(128), 3, 2, dtype=dtype)
        self.d2_csp = CSPLayer(w(128), w(128), d(3), dtype=dtype)
        self.d3_conv = ConvBnSiLU(w(128), w(256), 3, 2, dtype=dtype)
        self.d3_csp = CSPLayer(w(256), w(256), d(9), dtype=dtype)
        self.d4_conv = ConvBnSiLU(w(256), w(512), 3, 2, dtype=dtype)
        self.d4_csp = CSPLayer(w(512), w(512), d(9), dtype=dtype)
        self.d5_conv = ConvBnSiLU(w(512), w(1024), 3, 2, dtype=dtype)
        self.spp = SPPBottleneck(w(1024), w(1024), dtype)
        self.d5_csp = CSPLayer(w(1024), w(1024), d(3), shortcut=False,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        # Focus: space-to-depth in the flax channel order
        patches = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                             x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)
        y = self.d2_csp(self.d2_conv(self.stem(patches.to(self.dtype))))
        c3 = y = self.d3_csp(self.d3_conv(y))
        c4 = y = self.d4_csp(self.d4_conv(y))
        c5 = self.d5_csp(self.spp(self.d5_conv(y)))
        return {"c3": c3, "c4": c4, "c5": c5}


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAFPN(nn.Module):
    def __init__(self, width_mult: float = 0.5, depth_mult: float = 0.33,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def w(c):
            return int(c * width_mult)

        def d(n):
            return max(int(round(n * depth_mult)), 1)
        self.lat5 = ConvBnSiLU(w(1024), w(512), 1, dtype=dtype)
        self.td4 = CSPLayer(w(512) + w(512), w(512), d(3), False, dtype)
        self.lat4 = ConvBnSiLU(w(512), w(256), 1, dtype=dtype)
        self.td3 = CSPLayer(w(256) + w(256), w(256), d(3), False, dtype)
        self.bu3 = ConvBnSiLU(w(256), w(256), 3, 2, dtype=dtype)
        self.bu4_csp = CSPLayer(w(256) + w(256), w(512), d(3), False, dtype)
        self.bu4 = ConvBnSiLU(w(512), w(512), 3, 2, dtype=dtype)
        self.bu5_csp = CSPLayer(w(512) + w(512), w(1024), d(3), False, dtype)

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]
        p5 = self.lat5(c5)
        p4 = self.lat4(self.td4(torch.cat([_up(p5), c4], dim=1)))
        p3 = self.td3(torch.cat([_up(p4), c3], dim=1))
        n4 = self.bu4_csp(torch.cat([self.bu3(p3), p4], dim=1))
        n5 = self.bu5_csp(torch.cat([self.bu4(n4), p5], dim=1))
        return [p3, n4, n5]


class ResLayer(nn.Module):
    """Darknet residual: 1×1 halve + 3×3 restore, lrelu."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c1 = ConvBnSiLU(ch, ch // 2, 1, dtype=dtype, act="lrelu")
        self.c2 = ConvBnSiLU(ch // 2, ch, 3, dtype=dtype, act="lrelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.c1(x))


class Darknet53(nn.Module):
    """Darknet-53 (residual groups 1/2/8/8/4) with the SPP block YOLOFPN
    appends to dark5; returns c3 (256 ch), c4 (512), c5 (512)."""

    GROUPS = (("d1", 64, 1), ("d2", 128, 2), ("d3", 256, 8),
              ("d4", 512, 8), ("d5", 1024, 4))

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = ConvBnSiLU(3, 32, 3, dtype=dtype, act="lrelu")
        cin = 32
        for name, ch, n in self.GROUPS:
            setattr(self, f"{name}_down",
                    ConvBnSiLU(cin, ch, 3, 2, dtype=dtype, act="lrelu"))
            for i in range(n):
                setattr(self, f"{name}_res{i}", ResLayer(ch, dtype))
            cin = ch

        def cbl(name, ci, co, k):
            setattr(self, name, ConvBnSiLU(ci, co, k, dtype=dtype,
                                           act="lrelu"))
        cbl("spp_pre1", 1024, 512, 1)
        cbl("spp_pre2", 512, 1024, 3)
        cbl("spp_post1", 4096, 512, 1)
        cbl("spp_post2", 512, 1024, 3)
        cbl("spp_out", 1024, 512, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.stem(x.to(self.dtype))
        feats = {}
        for name, _, n in self.GROUPS:
            y = getattr(self, f"{name}_down")(y)
            for i in range(n):
                y = getattr(self, f"{name}_res{i}")(y)
            feats[name] = y
        y = self.spp_pre2(self.spp_pre1(y))
        y = self.spp_post2(self.spp_post1(_spp_pools(y)))
        return {"c3": feats["d3"], "c4": feats["d4"], "c5": self.spp_out(y)}


class YOLOFPN(nn.Module):
    """Two top-down upsample + concat "embedding" branches (five
    alternating 1×1 / 3×3 lrelu convs each) over Darknet-53 features."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def cbl(ci, co, k):
            return ConvBnSiLU(ci, co, k, dtype=dtype, act="lrelu")

        def embed(cin, ch):
            specs = [(1, ch), (3, ch * 2), (1, ch), (3, ch * 2), (1, ch)]
            layers, c = [], cin
            for k, f in specs:
                layers.append(cbl(c, f, k))
                c = f
            return nn.ModuleList(layers)
        self.out1_cbl = cbl(512, 256, 1)
        self.out1 = embed(256 + 512, 256)
        self.out2_cbl = cbl(256, 128, 1)
        self.out2 = embed(128 + 256, 128)

    @staticmethod
    def _embed(layers: nn.ModuleList, y: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            y = layer(y)
        return y

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]
        p4 = self._embed(self.out1,
                         torch.cat([_up(self.out1_cbl(c5)), c4], dim=1))
        p3 = self._embed(self.out2,
                         torch.cat([_up(self.out2_cbl(p4)), c3], dim=1))
        return [p3, p4, c5]


class YOLOXHead(nn.Module):
    """Decoupled head: per level a 1×1 stem, two 3×3 convs each for the
    class and the box branch, and 1×1 cls / reg / obj predictions."""

    def __init__(self, in_channels: Tuple[int, ...], num_classes: int = 80,
                 width_mult: float = 0.5, dtype: torch.dtype = torch.bfloat16,
                 act: str = "silu"):
        super().__init__()
        w = int(256 * width_mult)
        self.num_classes, self.dtype = num_classes, dtype
        self.levels = len(in_channels)
        for li, cin in enumerate(in_channels):
            setattr(self, f"stem{li}", ConvBnSiLU(cin, w, 1, dtype=dtype,
                                                  act=act))
            for branch in ("cls", "reg"):
                setattr(self, f"{branch}{li}", nn.ModuleList(
                    [ConvBnSiLU(w, w, 3, dtype=dtype, act=act)
                     for _ in range(2)]))
            setattr(self, f"cls_pred{li}", nn.Conv2d(w, num_classes, 1))
            setattr(self, f"reg_pred{li}", nn.Conv2d(w, 4, 1))
            setattr(self, f"obj_pred{li}", nn.Conv2d(w, 1, 1))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        outs = []
        for li, x in enumerate(feats):
            x = getattr(self, f"stem{li}")(x)
            c = r = x
            for layer in getattr(self, f"cls{li}"):
                c = layer(c)
            for layer in getattr(self, f"reg{li}"):
                r = layer(r)
            cls = _conv(c, getattr(self, f"cls_pred{li}"), self.dtype)
            reg = _conv(r, getattr(self, f"reg_pred{li}"), self.dtype)
            obj = _conv(r, getattr(self, f"obj_pred{li}"), self.dtype)
            out = torch.cat([reg, obj, cls], dim=1)          # (B, 5+C, h, w)
            # NHWC before the reshape: anchors in row-major (y, x) order
            outs.append(out.permute(0, 2, 3, 1).reshape(
                out.shape[0], -1, 5 + self.num_classes))
        return torch.cat(outs, dim=1).float()


class YOLOX(nn.Module):
    """CSPDarknet + PAFPN + decoupled head ("darknet53": the yolov3 exp's
    Darknet-53 + YOLOFPN + lrelu head). Input (B, H, W, 3) NHWC float32,
    output (B, A, 5 + C) float32 raw head rows."""

    def __init__(self, num_classes: int = 80, depth_mult: float = 0.33,
                 width_mult: float = 0.5, dtype: torch.dtype = torch.bfloat16,
                 backbone_type: str = "cspdarknet",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        if backbone_type == "darknet53":
            self.backbone = Darknet53(dtype)
            self.neck = YOLOFPN(dtype)
            self.head = YOLOXHead((128, 256, 512), num_classes, width_mult,
                                  dtype, act="lrelu")
        elif backbone_type == "cspdarknet":
            self.backbone = CSPDarknet(depth_mult, width_mult, dtype)
            self.neck = PAFPN(width_mult, depth_mult, dtype)
            chans = tuple(int(c * width_mult) for c in (256, 512, 1024))
            self.head = YOLOXHead(chans, num_classes, width_mult, dtype)
        else:
            raise ValueError(f"backbone_type must be cspdarknet or "
                             f"darknet53, got {backbone_type!r}")
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal conv kernels, zero biases (the cls
        and obj predictions at −log(99), a 1% prior), BatchNorm scale 1,
        bias 0, mean 0, var 1."""
        for name, module in self.named_modules():
            if isinstance(module, nn.Conv2d):
                lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    last = name.rsplit(".", 1)[-1]
                    nn.init.constant_(module.bias, _PRIOR_BIAS if
                                      last.startswith(("cls_pred",
                                                       "obj_pred"))
                                      else 0.0)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)           # NCHW view, channels-last
        return self.head(self.neck(self.backbone(x)))


# ------------------------------------------------------ decode + postprocess
def yolox_grid(image_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(A, 2) grid centres (cell units, not scaled) + (A,) strides."""
    h, w = image_hw
    centers, strides = [], []
    for s in STRIDES:
        fh, fw = math.ceil(h / s), math.ceil(w / s)
        ys, xs = np.mgrid[0:fh, 0:fw].astype(np.float32)
        centers.append(np.stack([xs, ys], -1).reshape(-1, 2))
        strides.append(np.full(fh * fw, s, np.float32))
    return np.concatenate(centers), np.concatenate(strides)


def decode_outputs(raw: torch.Tensor, centers: torch.Tensor,
                   strides: torch.Tensor) -> torch.Tensor:
    """(B, A, 5+C) raw → boxes xyxy + obj + cls: xy = (pred + grid)·stride,
    wh = exp(clip(pred, -10, 8))·stride."""
    xy = (raw[..., :2] + centers) * strides[:, None]
    wh = torch.exp(raw[..., 2:4].clamp(-10, 8)) * strides[:, None]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    return torch.cat([boxes, raw[..., 4:]], dim=-1)


def simota_assign(decoded: torch.Tensor, centers: torch.Tensor,
                  strides: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  num_classes: int, center_radius: float = 2.5,
                  topk_ious: int = 10) -> Dict[str, torch.Tensor]:
    """Fixed-shape SimOTA. decoded (B, A, 5+C) float32; gt_boxes (B, G, 4)
    xyxy pixels, gt_labels (B, G), gt_valid (B, G). Returns {fg (B, A)
    bool, matched_gt (B, A) int64 (0 where not fg), matched_iou (B, A)}."""
    with torch.no_grad():
        decoded = decoded.detach().float()
        a = decoded.shape[1]
        boxes = decoded[..., :4]
        obj = torch.sigmoid(decoded[..., 4])                    # (B, A)
        cls = torch.sigmoid(decoded[..., 5:])                   # (B, A, C)

        cx = (centers[:, 0] + 0.5) * strides                    # (A,)
        cy = (centers[:, 1] + 0.5) * strides
        g = gt_boxes[..., None, :]                              # (B, G, 1, 4)
        # gating: anchor centre in the gt box OR within the centre radius
        in_box = ((cx > g[..., 0]) & (cx < g[..., 2])
                  & (cy > g[..., 1]) & (cy < g[..., 3]))        # (B, G, A)
        gcx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
        gcy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
        rad = center_radius * strides
        in_center = ((torch.abs(cx - gcx[..., None]) < rad)
                     & (torch.abs(cy - gcy[..., None]) < rad))
        valid = gt_valid[..., None]
        fg_cand = (in_box | in_center) & valid

        iou = torch.where(valid, box_ops.box_iou(gt_boxes, boxes), 0.0)
        iou_cost = -torch.log(iou + 1e-8)
        onehot = F.one_hot(gt_labels.long(), num_classes).float()
        onehot = onehot[:, :, None, :]                          # (B,G,1,C)
        joint = torch.sqrt(torch.clamp(cls * obj[..., None], 1e-8, 1.0))
        joint = joint[:, None]                                  # (B,1,A,C)
        cls_cost = -(onehot * torch.log(joint)
                     + (1 - onehot) * torch.log(1 - joint + 1e-8))
        cls_cost = torch.sum(cls_cost, -1)                      # (B, G, A)
        # an extra 1e5 for candidates not in BOTH gates prefers anchors
        # that pass both; non-candidates end at 2e5, strictly worse
        cost = (cls_cost + 3.0 * iou_cost + 1e5 * (~fg_cand)
                + 1e5 * (~(in_box & in_center)))

        # dynamic k per gt: the top-10 candidate IoUs summed, truncated
        masked_iou = torch.where(fg_cand, iou, 0.0)
        topk = torch.topk(masked_iou, min(topk_ious, a), dim=-1).values
        dynamic_k = torch.clamp(topk.sum(-1).to(torch.int32), 1, a)

        # rank of each anchor's cost within its gt row (0 = cheapest);
        # the stable sort keeps equal float32 costs in anchor order
        order = torch.argsort(cost, dim=-1, stable=True)
        ranks = torch.arange(a, device=cost.device).expand_as(order)
        rank = torch.empty_like(order).scatter_(-1, order, ranks)
        take = (rank < dynamic_k[..., None]) & fg_cand          # (B, G, A)

        # an anchor claimed by several gts keeps the cheapest (first on ties)
        best_gt = torch.argmin(torch.where(take, cost, float("inf")), dim=1)
        fg = take.any(dim=1)
        matched_gt = torch.where(fg, best_gt, 0)
        matched_iou = torch.where(
            fg, iou.gather(1, matched_gt[:, None]).squeeze(1), 0.0)
    return {"fg": fg, "matched_gt": matched_gt, "matched_iou": matched_iou}


def yolox_loss(raw: torch.Tensor, centers: torch.Tensor,
               strides: torch.Tensor, gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               num_classes: int, use_l1: bool = False
               ) -> Dict[str, torch.Tensor]:
    """IoU loss + objectness BCE + class BCE (+ the L1 loss on the raw
    deltas with ``use_l1``), each summed per image and normalised by the
    batch's positives. raw (B, A, 5+C) float32, the head's output. Every
    value is a device tensor; the assignment is a constant target."""
    decoded = decode_outputs(raw, centers, strides)
    with torch.profiler.record_function("simota_assign"):
        assign = simota_assign(decoded, centers, strides, gt_boxes,
                               gt_labels, gt_valid, num_classes)
    fg = assign["fg"]
    fgf = fg.float()
    mg = assign["matched_gt"]
    tgt_boxes = gt_boxes.gather(1, mg[..., None].expand(-1, -1, 4))
    iou = box_ops.elementwise_box_iou(decoded[..., :4], tgt_boxes, "iou")
    iou_loss = torch.sum((1.0 - iou ** 2) * fgf, dim=1)         # IoU² loss
    a = raw.shape[1]
    # the sum over anchors, as the mean times A
    obj_loss = torch.mean(L.binary_cross_entropy(
        raw[..., 4], fgf, reduction="none"), dim=1) * a
    cls_t = (F.one_hot(gt_labels.gather(1, mg).long(), num_classes)
             * assign["matched_iou"][..., None])
    # the JAX weighted mean with the (A, 1) positive mask, times the
    # positives: the sum over (positives, C)
    n_fg = fgf.sum(1)
    cls_bce = L.binary_cross_entropy(raw[..., 5:], cls_t, reduction="none")
    cls_loss = (torch.sum(cls_bce * fgf[..., None], dim=(1, 2))
                / torch.clamp(n_fg, min=1.0) * n_fg)
    l1 = torch.zeros_like(n_fg)
    if use_l1:
        s = strides[:, None]
        tgt_xy = (tgt_boxes[..., :2] + tgt_boxes[..., 2:]) / 2 / s - centers
        tgt_wh = torch.log(torch.clamp(
            (tgt_boxes[..., 2:] - tgt_boxes[..., :2]) / s, min=1e-6))
        l1_t = torch.cat([tgt_xy, tgt_wh], -1)
        l1 = torch.sum(torch.abs(raw[..., :4] - l1_t) * fgf[..., None],
                       dim=(1, 2))
    norm = torch.clamp(n_fg.sum(), min=1.0)
    return {"iou_loss": 5.0 * iou_loss.sum() / norm,
            "obj_loss": obj_loss.sum() / norm,
            "cls_loss": cls_loss.sum() / norm,
            "l1_loss": l1.sum() / norm,
            "num_fg": n_fg.sum()}


def yolox_postprocess(raw: torch.Tensor, centers: torch.Tensor,
                      strides: torch.Tensor, score_thresh: float = 0.01,
                      nms_thresh: float = 0.65, max_det: int = 100,
                      nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    decoded = decode_outputs(raw, centers, strides)
    return postprocess_decoded(decoded, score_thresh=score_thresh,
                               nms_thresh=nms_thresh, max_det=max_det,
                               nms_impl=nms_impl)


def postprocess_decoded(decoded: torch.Tensor, score_thresh: float = 0.01,
                        nms_thresh: float = 0.65, max_det: int = 100,
                        nms_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Class-aware NMS over decoded (B, A, 5+C) rows, the whole batch in
    one call: score = sigmoid(obj) · max sigmoid(cls), label its argmax;
    returns {boxes (B, max_det, 4), scores, labels (−1 on padded slots),
    valid}."""
    obj = torch.sigmoid(decoded[..., 4])
    cls = torch.sigmoid(decoded[..., 5:])
    scores_all = obj[..., None] * cls
    best_score = scores_all.amax(dim=-1)
    best_cls = scores_all.argmax(dim=-1)                 # first of the maxima
    keep_idx, keep_valid = nms_ops.batched_nms(
        decoded[..., :4], best_score, best_cls, nms_thresh, max_det,
        score_threshold=score_thresh, impl=nms_impl)
    boxes, scores, labels = nms_ops.gather_nms_outputs(
        keep_idx, keep_valid, decoded[..., :4], best_score, best_cls,
        fill=(0, 0, -1))
    return {"boxes": boxes, "scores": scores, "labels": labels,
            "valid": keep_valid}


# ---------------------------------------------------------------- factories
_VARIANTS = {
    "yolox_nano": (0.33, 0.25), "yolox_tiny": (0.33, 0.375),
    "yolox_s": (0.33, 0.5), "yolox_m": (0.67, 0.75),
    "yolox_l": (1.0, 1.0), "yolox_x": (1.33, 1.25),
}


def _factory(name: str, depth: float, width: float, **defaults):
    @MODELS.register(name)
    def build(num_classes: int = 80, **kw):
        return YOLOX(num_classes=num_classes, depth_mult=depth,
                     width_mult=width, **{**defaults, **kw})
    build.__name__ = name
    return build


for _name, (_d, _w) in _VARIANTS.items():
    _factory(_name, _d, _w)

# exps/default/yolov3.py: Darknet-53 + YOLOFPN + lrelu head at width 1.0
yolox_yolov3 = _factory("yolox_yolov3", 1.0, 1.0, backbone_type="darknet53")
