"""Spec-driven YOLO model assembly: the port of
``deeplearning_tpu/models/detection/yolo_builder.py`` (the parse_model
YAML builder).

The model is a list of layer specs ``[from, number, module, args]``
evaluated top to bottom, where ``from`` indexes earlier outputs (−1 the
previous one, a list concatenates). Vocabulary: Conv, C3, SPP, Focus,
Upsample, Concat, Detect, built from the port's YOLOX blocks. Layer i is
attribute ``l{i}_{module}``, as the flax module names it; a Conv repeated
``number > 1`` times, and Detect, are ``ModuleList``s (flax
``l{i}_conv_{r}``, ``l{i}_detect_{j}``), as the converter maps them. The
channels each layer takes are tracked while building, since torch
convolutions need them up front.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import yaml

from ...core.registry import MODELS
from ..layers import conv, init_flax_
from .retinanet import nhwc_rows
from .yolov5 import focus
from .yolox import ConvBnSiLU, CSPLayer, SPPBottleneck

__all__ = ["SpecModel", "YOLOV5_SPEC", "load_spec_yaml", "yolov5_from_spec"]

Spec = Tuple[Union[int, List[int]], int, str, list]

# jax.image.resize methods an Upsample layer may name, as torch modes
_RESIZE = {"nearest": "nearest-exact", "linear": "bilinear",
           "bilinear": "bilinear"}


class SpecModel(nn.Module):
    """Evaluate a layer-spec list (parse_model semantics). Input (B, H, W,
    3) NHWC float32; output the Detect rows (B, A, 5 + C) float32, or,
    without a Detect layer, the last output NHWC float32."""

    def __init__(self, spec: Sequence[Spec], num_classes: int = 80,
                 width_mult: float = 1.0, depth_mult: float = 1.0,
                 anchors_per_loc: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def w(c):
            return max(int(c * width_mult), 1)

        def d(n):
            return max(int(round(n * depth_mult)), 1)
        self.spec = tuple((list(f) if isinstance(f, (list, tuple)) else f,
                           n, m, list(a)) for f, n, m, a in spec)
        self.num_classes, self.dtype = num_classes, dtype
        self.anchors_per_loc = anchors_per_loc
        chans: List[int] = []
        c_prev = 3
        for li, (frm, num, mod, args) in enumerate(self.spec):
            ins = [chans[f] if f != -1 else c_prev
                   for f in (frm if isinstance(frm, list) else [frm])]
            name = f"l{li}_{mod.lower()}"
            c_out = ins[0]
            if mod == "Focus":
                c_out = w(args[0])
                setattr(self, name, ConvBnSiLU(
                    4 * ins[0], c_out, args[1] if len(args) > 1 else 3,
                    dtype=dtype))
            elif mod == "Conv":
                c_out, k = w(args[0]), args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                layers = [ConvBnSiLU(ins[0] if r == 0 else c_out, c_out, k,
                                     s if r == 0 else 1, dtype=dtype)
                          for r in range(d(num))]
                setattr(self, name, nn.ModuleList(layers) if num > 1
                        else layers[0])
            elif mod == "C3":
                c_out = w(args[0])
                setattr(self, name, CSPLayer(
                    ins[0], c_out, d(num),
                    args[1] if len(args) > 1 else True, dtype))
            elif mod == "SPP":
                c_out = w(args[0])
                setattr(self, name, SPPBottleneck(ins[0], c_out, dtype))
            elif mod in ("Upsample", "nn.Upsample"):
                method = str(args[2]) if len(args) >= 3 and args[2] \
                    else "nearest"
                if method not in _RESIZE:
                    raise ValueError(f"Upsample method {method!r}: the port "
                                     f"resizes with {sorted(_RESIZE)}")
            elif mod == "Concat":
                c_out = sum(ins)
            elif mod == "Detect":
                setattr(self, name, nn.ModuleList(
                    nn.Conv2d(c, anchors_per_loc * (5 + num_classes), 1)
                    for c in ins))
            else:
                raise ValueError(f"unknown module {mod!r} in spec")
            chans.append(c_out)
            c_prev = c_out
        init_flax_(self, generator if generator is not None
                   else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        outputs: List[torch.Tensor] = []
        y = images.permute(0, 3, 1, 2).to(self.dtype)   # NCHW view
        detect_outs: List[torch.Tensor] = []
        for li, (frm, num, mod, args) in enumerate(self.spec):
            inputs = [outputs[f] if f != -1 else y
                      for f in (frm if isinstance(frm, list) else [frm])]
            inp = inputs[0]
            layer = getattr(self, f"l{li}_{mod.lower()}", None)
            if mod == "Focus":
                y = layer(focus(inp))
            elif mod == "Conv":
                y = inp
                for c in (layer if isinstance(layer, nn.ModuleList)
                          else [layer]):
                    y = c(y)
            elif mod in ("C3", "SPP"):
                y = layer(inp)
            elif mod in ("Upsample", "nn.Upsample"):
                scale = int(args[1]) if len(args) >= 2 and args[1] else 2
                method = str(args[2]) if len(args) >= 3 and args[2] \
                    else "nearest"
                y = F.interpolate(inp, scale_factor=scale,
                                  mode=_RESIZE[method])
            elif mod == "Concat":
                y = torch.cat(inputs, dim=1)
            else:                                      # Detect
                for di, feat in enumerate(inputs):
                    detect_outs.append(nhwc_rows(
                        conv(feat, layer[di], self.dtype),
                        5 + self.num_classes))
                # Detect makes no feature map: its slot keeps a tensor, so a
                # later reference fails on its shape, not on None
                y = inputs[0]
            outputs.append(y)
        if detect_outs:
            return torch.cat(detect_outs, dim=1).float()
        return y.permute(0, 2, 3, 1).float()


# yolov5-v5.0 layout as a spec list (the yolov5s.yaml content)
YOLOV5_SPEC: Sequence[Spec] = (
    (-1, 1, "Focus", [64]),          # 0
    (-1, 1, "Conv", [128, 3, 2]),    # 1
    (-1, 3, "C3", [128]),            # 2
    (-1, 1, "Conv", [256, 3, 2]),    # 3
    (-1, 9, "C3", [256]),            # 4  (P3)
    (-1, 1, "Conv", [512, 3, 2]),    # 5
    (-1, 9, "C3", [512]),            # 6  (P4)
    (-1, 1, "Conv", [1024, 3, 2]),   # 7
    (-1, 1, "SPP", [1024]),          # 8
    (-1, 3, "C3", [1024, False]),    # 9  (P5)
    (-1, 1, "Conv", [512, 1]),       # 10
    (-1, 1, "Upsample", []),         # 11
    ([-1, 6], 1, "Concat", []),      # 12
    (-1, 3, "C3", [512, False]),     # 13
    (-1, 1, "Conv", [256, 1]),       # 14
    (-1, 1, "Upsample", []),         # 15
    ([-1, 4], 1, "Concat", []),      # 16
    (-1, 3, "C3", [256, False]),     # 17 (out P3)
    (-1, 1, "Conv", [256, 3, 2]),    # 18
    ([-1, 14], 1, "Concat", []),     # 19
    (-1, 3, "C3", [512, False]),     # 20 (out P4)
    (-1, 1, "Conv", [512, 3, 2]),    # 21
    ([-1, 10], 1, "Concat", []),     # 22
    (-1, 3, "C3", [1024, False]),    # 23 (out P5)
    ([17, 20, 23], 1, "Detect", []),  # 24
)


def load_spec_yaml(path: str) -> Dict[str, Any]:
    """Load a reference-style model yaml: {depth_multiple, width_multiple,
    backbone: [...], head: [...]} → kwargs for SpecModel."""
    with open(path) as f:
        doc = yaml.safe_load(f)
    spec = [tuple(row) for row in
            list(doc.get("backbone", [])) + list(doc.get("head", []))]
    return {
        "spec": spec,
        "depth_mult": float(doc.get("depth_multiple", 1.0)),
        "width_mult": float(doc.get("width_multiple", 1.0)),
        "num_classes": int(doc.get("nc", 80)),
    }


@MODELS.register("yolov5_from_spec")
def yolov5_from_spec(num_classes: int = 80, spec=YOLOV5_SPEC, **kw):
    defaults = dict(depth_mult=0.33, width_mult=0.5)
    return SpecModel(spec=tuple(spec), num_classes=num_classes,
                     **{**defaults, **kw})
