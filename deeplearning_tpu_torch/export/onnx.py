"""Self-contained ``torch.export`` → ONNX exporter and load-back
evaluator: the port of ``deeplearning_tpu/export/onnx.py``.

Neither the ``onnx`` package nor ``onnxscript`` / ``onnxruntime`` is
installed, so ``torch.onnx`` cannot run; this module implements the whole
path itself, as the JAX module does:

- the same minimal protobuf **wire-format** writer and reader for the
  public ONNX schema (ModelProto / GraphProto / NodeProto / TensorProto /
  AttributeProto, opset 12: attribute-style Reduce* axes, IR 7);
- a walk of the FX graph of ``torch.export`` after ``run_decompositions()``
  (core ATen) that lowers each op through ``ONNX_LOWERINGS``;
- ``register_onnx_lowering``: a model using an op outside the built-in
  table registers a lowering and exports (the ``support_new_ops.py``
  ``g.op()`` symbolic-registration analog); K1's custom op
  ``dltpu.flash_fwd`` has one (its attention in plain ONNX ops), so a ViT
  on K1 exports too;
- ``load_onnx`` / ``run_onnx``: parse the serialized file back and
  evaluate it (numpy, and torch on the CPU for Conv, MaxPool and Erf,
  where JAX uses ``lax``), so tests hold the ARTIFACT against the eager
  forward.

The port's tensors are NCHW, as ONNX defines Conv and MaxPool, so no
Transpose pair wraps them. Every node type the exporter emits is one the
JAX evaluator's table also runs (a Conv's bias is a separate Add, a
LayerNorm or a softmax is written out in reductions and arithmetic), so
JAX's ``run_onnx`` can evaluate the port's files.
"""

from __future__ import annotations

import math
import operator
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .serialize import _as_module

__all__ = ["export_onnx", "load_onnx", "run_onnx",
           "register_onnx_lowering", "ONNX_LOWERINGS"]

OPSET = 12
IR_VERSION = 7            # IR for opset-12-era onnx releases

# TensorProto.DataType
_DTYPES = {
    np.dtype("float32"): 1, np.dtype("uint8"): 2, np.dtype("int8"): 3,
    np.dtype("int32"): 6, np.dtype("int64"): 7, np.dtype("bool"): 9,
    np.dtype("float16"): 10, np.dtype("float64"): 11,
}
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}
_TORCH_NP = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int64: np.int64,
             torch.int32: np.int32, torch.int8: np.int8,
             torch.uint8: np.uint8, torch.bool: np.bool_}
_NP_TORCH = {np.dtype(v): k for k, v in _TORCH_NP.items()}
_INT64_MAX = 2 ** 63 - 1


# --------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _packed_ints(field: int, values: Sequence[int]) -> bytes:
    if not values:
        return b""
    payload = b"".join(_varint(v) for v in values)
    return _len_field(field, payload)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def varint(self) -> int:
        shift = result = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def field(self) -> Tuple[int, int, Any]:
        key = self.varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            return field, wire, self.varint()
        if wire == 2:
            n = self.varint()
            blob = self.data[self.pos:self.pos + n]
            self.pos += n
            return field, wire, blob
        if wire == 5:
            blob = self.data[self.pos:self.pos + 4]
            self.pos += 4
            return field, wire, struct.unpack("<f", blob)[0]
        if wire == 1:
            blob = self.data[self.pos:self.pos + 8]
            self.pos += 8
            return field, wire, struct.unpack("<d", blob)[0]
        raise ValueError(f"unsupported wire type {wire}")


def _read_packed_ints(blob: bytes) -> List[int]:
    r = _Reader(blob)
    out = []
    while not r.eof():
        out.append(r.varint())
    return out


# ---------------------------------------------------------- proto builders

def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {arr.dtype} for ONNX export")
    parts = [
        _packed_ints(1, arr.shape),              # dims
        _int_field(2, _DTYPES[arr.dtype]),       # data_type
        _len_field(8, name.encode()),            # name
        _len_field(9, arr.tobytes()),            # raw_data
    ]
    return b"".join(parts)


def _value_info(name: str, shape: Sequence[int], dtype: np.dtype) -> bytes:
    dims = b"".join(_len_field(1, _int_field(1, d)) for d in shape)
    tensor_type = (_int_field(1, _DTYPES[np.dtype(dtype)])
                   + _len_field(2, dims))
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode()) + _len_field(2, type_proto)


def _attribute(name: str, value: Any) -> bytes:
    parts = [_len_field(1, name.encode())]
    if isinstance(value, float):
        parts += [_tag(2, 5) + struct.pack("<f", value), _int_field(20, 1)]
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        parts += [_int_field(3, int(value)), _int_field(20, 2)]
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, np.integer)) for v in value):
        parts += [b"".join(_int_field(8, int(v)) for v in value),
                  _int_field(20, 7)]
    elif isinstance(value, str):
        parts += [_len_field(4, value.encode()), _int_field(20, 3)]
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return b"".join(parts)


def _node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
                attrs: Dict[str, Any], domain: str = "") -> bytes:
    parts = [_len_field(1, i.encode()) for i in inputs]
    parts += [_len_field(2, o.encode()) for o in outputs]
    parts += [_len_field(4, op_type.encode())]
    parts += [_len_field(5, _attribute(k, v)) for k, v in attrs.items()]
    if domain:
        parts += [_len_field(7, domain.encode())]
    return b"".join(parts)


# ----------------------------------------------------------- graph builder

class _GraphBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._const_cache: Dict[Any, str] = {}
        self._counter = 0

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def node(self, op_type: str, inputs: Sequence[str],
             outputs: Optional[Sequence[str]] = None,
             domain: str = "", **attrs) -> str:
        outputs = list(outputs) if outputs else [self.fresh(op_type.lower())]
        self.nodes.append(_node_proto(op_type, inputs, outputs, attrs,
                                      domain))
        return outputs[0]

    def constant(self, arr: np.ndarray, hint: str = "const") -> str:
        arr = np.asarray(arr)
        # dedupe small constants (scalars recur per op: BatchNorm eps adds,
        # activation thresholds, reshape targets)
        key = None
        if arr.size <= 64:
            key = (str(arr.dtype), arr.shape, arr.tobytes())
            if key in self._const_cache:
                return self._const_cache[key]
        name = self.fresh(hint)
        self.initializers.append(_tensor_proto(name, arr))
        if key is not None:
            self._const_cache[key] = name
        return name

    def shape(self, dims: Sequence[int]) -> str:
        return self.constant(np.asarray(list(dims), np.int64))


# ------------------------------------------------------ lowering registry

ONNX_LOWERINGS: Dict[str, Callable] = {}


def register_onnx_lowering(op_name: str):
    """Register an ATen (or custom) op → ONNX lowering, keyed by the op's
    name without its overload (``"aten.atan"``, ``"dltpu.flash_fwd"``) —
    the analog of the reference's symbolic registration for unsupported
    ops (others/deploy/pytorch2onnx/support_new_ops.py ``g.op()``). The
    function receives (builder, node, ins, outs): the FX node, its
    arguments with every tensor replaced by its ONNX value name (other
    arguments as they are), and the names its outputs must take; it emits
    nodes through ``builder.node``."""
    def deco(fn):
        ONNX_LOWERINGS[op_name] = fn
        return fn
    return deco


def _val(node) -> Any:
    return node.meta["val"]


def _np_dtype(t) -> np.dtype:
    return np.dtype(_TORCH_NP[t.dtype])


def _out_dtype(node) -> np.dtype:
    val = _val(node)
    return _np_dtype(val[0] if isinstance(val, (tuple, list)) else val)


def _arg(g: _GraphBuilder, node, x, dtype: np.dtype) -> str:
    """An operand as an ONNX name in ``dtype``: a Python scalar becomes a
    constant, a tensor of another dtype a Cast."""
    if isinstance(x, _Value):
        if x.dtype != dtype:
            return g.node("Cast", [x.name], to=_DTYPES[dtype])
        return x.name
    return g.constant(np.asarray(x, dtype))


class _Value:
    """A tensor argument: its ONNX name, dtype and shape."""

    __slots__ = ("name", "dtype", "shape")

    def __init__(self, name: str, dtype: np.dtype, shape: Tuple[int, ...]):
        self.name, self.dtype, self.shape = name, dtype, shape

    def __repr__(self) -> str:
        return f"_Value({self.name})"


def _promoted(ins) -> np.dtype:
    dts = [x.dtype for x in ins if isinstance(x, _Value)]
    return np.result_type(*dts) if dts else np.dtype(np.float32)


def _binary(op_type: str, compare: bool = False):
    def lower(g, node, ins, outs):
        a, b = ins[0], ins[1]
        dt = _promoted([a, b]) if compare else _out_dtype(node)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = _Value(g.node("Mul", [_arg(g, node, b, dt),
                                      g.constant(np.asarray(alpha, dt))]),
                       dt, ())
        g.node(op_type, [_arg(g, node, a, dt), _arg(g, node, b, dt)], outs)
    return lower


for _op, _onnx in [("add", "Add"), ("sub", "Sub"), ("mul", "Mul"),
                   ("maximum", "Max"), ("minimum", "Min"), ("pow", "Pow"),
                   ("logical_and", "And"), ("logical_or", "Or"),
                   ("bitwise_and", "And"), ("bitwise_or", "Or")]:
    ONNX_LOWERINGS[f"aten.{_op}"] = _binary(_onnx)
for _op, _onnx in [("eq", "Equal"), ("lt", "Less"), ("gt", "Greater"),
                   ("le", "LessOrEqual"), ("ge", "GreaterOrEqual")]:
    ONNX_LOWERINGS[f"aten.{_op}"] = _binary(_onnx, compare=True)


@register_onnx_lowering("aten.ne")
def _ne(g, node, ins, outs):
    dt = _promoted(ins[:2])
    e = g.node("Equal", [_arg(g, node, ins[0], dt), _arg(g, node, ins[1], dt)])
    g.node("Not", [e], outs)


@register_onnx_lowering("aten.div")
def _div(g, node, ins, outs):
    dt = _out_dtype(node)
    mode = node.kwargs.get("rounding_mode")
    a, b = _arg(g, node, ins[0], dt), _arg(g, node, ins[1], dt)
    if mode is None:
        g.node("Div", [a, b], outs)
    elif mode == "floor":
        g.node("Floor", [g.node("Div", [a, b])], outs)
    else:
        raise NotImplementedError(f"div rounding_mode={mode!r}")


def _unary(op_type: str):
    def lower(g, node, ins, outs):
        g.node(op_type, [_arg(g, node, ins[0], _out_dtype(node))], outs)
    return lower


for _op, _onnx in [("neg", "Neg"), ("exp", "Exp"), ("log", "Log"),
                   ("tanh", "Tanh"), ("sqrt", "Sqrt"), ("erf", "Erf"),
                   ("sigmoid", "Sigmoid"), ("abs", "Abs"), ("sign", "Sign"),
                   ("floor", "Floor"), ("ceil", "Ceil"),
                   ("reciprocal", "Reciprocal"), ("logical_not", "Not"),
                   ("bitwise_not", "Not"), ("alias", "Identity"),
                   ("clone", "Identity"), ("detach", "Identity"),
                   ("lift_fresh_copy", "Identity")]:
    ONNX_LOWERINGS[f"aten.{_op}"] = _unary(_onnx)


@register_onnx_lowering("aten.rsqrt")
def _rsqrt(g, node, ins, outs):
    g.node("Reciprocal", [g.node("Sqrt", [ins[0].name])], outs)


@register_onnx_lowering("aten.relu")
def _relu(g, node, ins, outs):
    g.node("Max", [ins[0].name, g.constant(np.zeros((), ins[0].dtype))],
           outs)


@register_onnx_lowering("aten.silu")
def _silu(g, node, ins, outs):
    g.node("Mul", [ins[0].name, g.node("Sigmoid", [ins[0].name])], outs)


@register_onnx_lowering("aten.gelu")
def _gelu(g, node, ins, outs):
    x, dt = ins[0].name, ins[0].dtype
    c = lambda v: g.constant(np.asarray(v, dt))  # noqa: E731
    if node.kwargs.get("approximate", "none") == "tanh":
        x3 = g.node("Mul", [g.node("Mul", [x, x]), x])
        inner = g.node("Mul", [c(math.sqrt(2 / math.pi)), g.node(
            "Add", [x, g.node("Mul", [c(0.044715), x3])])])
        t = g.node("Tanh", [inner])
    else:
        t = g.node("Erf", [g.node("Mul", [x, c(1 / math.sqrt(2))])])
    g.node("Mul", [g.node("Mul", [x, c(0.5)]), g.node("Add", [t, c(1.0)])],
           outs)


@register_onnx_lowering("aten.clamp")
def _clamp(g, node, ins, outs):
    x, dt = ins[0].name, ins[0].dtype
    lo = ins[1] if len(ins) > 1 else node.kwargs.get("min")
    hi = ins[2] if len(ins) > 2 else node.kwargs.get("max")
    if lo is not None:
        x = g.node("Max", [x, g.constant(np.asarray(lo, dt))])
    if hi is not None:
        x = g.node("Min", [x, g.constant(np.asarray(hi, dt))])
    g.node("Identity", [x], outs)


@register_onnx_lowering("aten.where")
def _where(g, node, ins, outs):
    dt = _out_dtype(node)
    g.node("Where", [ins[0].name, _arg(g, node, ins[1], dt),
                     _arg(g, node, ins[2], dt)], outs)


@register_onnx_lowering("aten._to_copy")
def _to_copy(g, node, ins, outs):
    dt = _out_dtype(node)
    if dt == ins[0].dtype:
        g.node("Identity", [ins[0].name], outs)
    else:
        g.node("Cast", [ins[0].name], outs, to=_DTYPES[dt])


def _reshape(g, node, ins, outs):
    """Static shapes: every view-like op is a Reshape to its output."""
    g.node("Reshape", [ins[0].name, g.shape(_val(node).shape)], outs)


for _op in ("view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
            "flatten"):
    ONNX_LOWERINGS[f"aten.{_op}"] = _reshape


@register_onnx_lowering("aten.permute")
def _permute(g, node, ins, outs):
    g.node("Transpose", [ins[0].name], outs,
           perm=[d % len(ins[0].shape) for d in ins[1]])


@register_onnx_lowering("aten.expand")
def _expand(g, node, ins, outs):
    g.node("Expand", [ins[0].name, g.shape(_val(node).shape)], outs)


@register_onnx_lowering("aten.cat")
def _cat(g, node, ins, outs):
    dt = _out_dtype(node)
    parts = [x for x in ins[0] if 0 not in x.shape]
    dim = ins[1] if len(ins) > 1 else 0
    g.node("Concat", [_arg(g, node, x, dt) for x in parts], outs,
           axis=dim % len(_val(node).shape))


def _slice_node(g, x: _Value, dim: int, start: int, end: int, step: int,
                outs=None) -> str:
    size = x.shape[dim]
    start = max(-size, min(start, size))
    end = max(-size, min(end, size))
    return g.node("Slice", [x.name, g.shape([start]), g.shape([end]),
                            g.shape([dim]), g.shape([step])], outs)


@register_onnx_lowering("aten.slice")
def _slice(g, node, ins, outs):
    x = ins[0]
    dim = (ins[1] if len(ins) > 1 else 0) % len(x.shape)
    start = ins[2] if len(ins) > 2 and ins[2] is not None else 0
    end = ins[3] if len(ins) > 3 and ins[3] is not None else _INT64_MAX
    step = ins[4] if len(ins) > 4 else 1
    _slice_node(g, x, dim, start, end, step, outs)


@register_onnx_lowering("aten.select")
def _select(g, node, ins, outs):
    x, dim, i = ins[0], ins[1] % len(ins[0].shape), ins[2]
    i = i % x.shape[dim]
    s = _slice_node(g, x, dim, i, i + 1, 1)
    g.node("Reshape", [s, g.shape(_val(node).shape)], outs)


@register_onnx_lowering("aten.split_with_sizes")
def _split(g, node, ins, outs):
    x, sizes = ins[0], ins[1]
    dim = (ins[2] if len(ins) > 2 else 0) % len(x.shape)
    start = 0
    for size, out in zip(sizes, outs):
        _slice_node(g, x, dim, start, start + size, 1, [out])
        start += size


def _reduce(op_type: str, mean: bool = False):
    def lower(g, node, ins, outs):
        x = ins[0]
        dims = ins[1] if len(ins) > 1 and ins[1] is not None else \
            list(range(len(x.shape)))
        dims = [dims] if isinstance(dims, int) else list(dims)
        dims = [d % len(x.shape) for d in dims] or list(range(len(x.shape)))
        keep = int(bool(ins[2] if len(ins) > 2 else
                        node.kwargs.get("keepdim", False)))
        name = _arg(g, node, x, _out_dtype(node))
        if not mean:
            g.node(op_type, [name], outs, axes=dims, keepdims=keep)
            return
        n = int(np.prod([x.shape[d] for d in dims]))
        s = g.node("ReduceSum", [name], axes=dims, keepdims=keep)
        g.node("Div", [s, g.constant(np.asarray(n, _out_dtype(node)))],
               outs)
    return lower


ONNX_LOWERINGS["aten.sum"] = _reduce("ReduceSum")
ONNX_LOWERINGS["aten.amax"] = _reduce("ReduceMax")
ONNX_LOWERINGS["aten.amin"] = _reduce("ReduceMin")
ONNX_LOWERINGS["aten.prod"] = _reduce("ReduceProd")
ONNX_LOWERINGS["aten.mean"] = _reduce("ReduceSum", mean=True)


@register_onnx_lowering("aten.argmax")
def _argmax(g, node, ins, outs):
    x = ins[0]
    dim = ins[1] if len(ins) > 1 and ins[1] is not None else None
    keep = int(bool(ins[2] if len(ins) > 2 else
                    node.kwargs.get("keepdim", False)))
    name = x.name
    if dim is None:
        name, dim = g.node("Reshape", [name, g.shape([-1])]), 0
    g.node("ArgMax", [name], outs, axis=dim % max(len(x.shape), 1),
           keepdims=keep, select_last_index=0)


def _softmax_nodes(g, x: str, dim: int, dt, outs=None, log=False) -> str:
    m = g.node("ReduceMax", [x], axes=[dim], keepdims=1)
    z = g.node("Sub", [x, m])
    e = g.node("Exp", [z])
    s = g.node("ReduceSum", [e], axes=[dim], keepdims=1)
    if log:
        return g.node("Sub", [z, g.node("Log", [s])], outs)
    return g.node("Div", [e, s], outs)


@register_onnx_lowering("aten._softmax")
def _softmax(g, node, ins, outs):
    _softmax_nodes(g, ins[0].name, ins[1] % len(ins[0].shape),
                   ins[0].dtype, outs)


@register_onnx_lowering("aten._log_softmax")
def _log_softmax(g, node, ins, outs):
    _softmax_nodes(g, ins[0].name, ins[1] % len(ins[0].shape),
                   ins[0].dtype, outs, log=True)


@register_onnx_lowering("aten.mm")
def _mm(g, node, ins, outs):
    g.node("MatMul", [ins[0].name, ins[1].name], outs)


ONNX_LOWERINGS["aten.bmm"] = _mm
ONNX_LOWERINGS["aten.matmul"] = _mm


@register_onnx_lowering("aten.addmm")
def _addmm(g, node, ins, outs):
    beta = node.kwargs.get("beta", 1)
    alpha = node.kwargs.get("alpha", 1)
    if beta != 1 or alpha != 1:
        raise NotImplementedError("addmm with beta or alpha != 1")
    mm = g.node("MatMul", [ins[1].name, ins[2].name])
    g.node("Add", [mm, ins[0].name], outs)


@register_onnx_lowering("aten.convolution")
def _conv(g, node, ins, outs):
    x, w, b, stride, padding, dilation, transposed, _, groups = ins[:9]
    if transposed:
        raise NotImplementedError("transposed convolution")
    if len(w.shape) != 4:
        raise NotImplementedError(f"{len(w.shape) - 2}-D convolution")
    # no bias input: the JAX evaluator's Conv takes two, so the bias is an
    # Add of a (1, C, 1, 1) view
    y = g.node("Conv", [x.name, w.name],
               None if b is not None else outs,
               strides=list(stride), dilations=list(dilation),
               pads=[padding[0], padding[1], padding[0], padding[1]],
               group=int(groups))
    if b is not None:
        bb = g.node("Reshape", [b.name, g.shape([1, -1, 1, 1])])
        g.node("Add", [y, bb], outs)


@register_onnx_lowering("aten.max_pool2d_with_indices")
def _max_pool(g, node, ins, outs):
    x, kernel = ins[0], list(ins[1])
    stride = list(ins[2]) if len(ins) > 2 and ins[2] else kernel
    padding = list(ins[3]) if len(ins) > 3 else [0, 0]
    dilation = list(ins[4]) if len(ins) > 4 else [1, 1]
    ceil_mode = ins[5] if len(ins) > 5 else False
    if len(padding) == 1:
        padding = padding * 2
    if any(d != 1 for d in dilation) or ceil_mode:
        raise NotImplementedError("dilated or ceil-mode pooling")
    if node.users and any(u.args[1] != 0 for u in node.users):
        raise NotImplementedError("max_pool2d's indices")
    g.node("MaxPool", [x.name], outs[:1], kernel_shape=kernel,
           strides=stride,
           pads=[padding[0], padding[1], padding[0], padding[1]])


@register_onnx_lowering("aten.upsample_nearest2d")
def _upsample_nearest(g, node, ins, outs):
    """Integer nearest upsampling as Reshape, Expand and Reshape."""
    x = ins[0]
    n, c, h, w = x.shape
    oh, ow = _val(node).shape[2:]
    if oh % h or ow % w:
        raise NotImplementedError("non-integer nearest upsampling")
    r = g.node("Reshape", [x.name, g.shape([n, c, h, 1, w, 1])])
    e = g.node("Expand", [r, g.shape([n, c, h, oh // h, w, ow // w])])
    g.node("Reshape", [e, g.shape([n, c, oh, ow])], outs)


@register_onnx_lowering("aten.native_layer_norm")
def _layer_norm(g, node, ins, outs):
    x, normalized, w, b, eps = ins[:5]
    dt = x.dtype
    axes = list(range(len(x.shape) - len(normalized), len(x.shape)))
    n = g.constant(np.asarray(int(np.prod(normalized)), dt))
    mean = g.node("Div", [g.node("ReduceSum", [x.name], axes=axes,
                                 keepdims=1), n])
    xc = g.node("Sub", [x.name, mean])
    var = g.node("Div", [g.node("ReduceSum", [g.node("Mul", [xc, xc])],
                                axes=axes, keepdims=1), n])
    rstd = g.node("Reciprocal", [g.node("Sqrt", [g.node(
        "Add", [var, g.constant(np.asarray(eps, dt))])])])
    y = g.node("Mul", [xc, rstd])
    if w is not None:
        y = g.node("Mul", [y, w.name])
    if b is not None:
        y = g.node("Add", [y, b.name])
    g.node("Identity", [y], outs[:1])


@register_onnx_lowering("aten._native_batch_norm_legit_no_training")
def _batch_norm(g, node, ins, outs):
    x, w, b, mean, var, _, eps = ins[:7]
    dt = x.dtype
    def view(v):
        return g.node("Reshape", [v.name, g.shape([1, -1, 1, 1])])
    rstd = g.node("Reciprocal", [g.node("Sqrt", [g.node(
        "Add", [view(var), g.constant(np.asarray(eps, dt))])])])
    y = g.node("Mul", [g.node("Sub", [x.name, view(mean)]), rstd])
    if w is not None:
        y = g.node("Mul", [y, view(w)])
    if b is not None:
        y = g.node("Add", [y, view(b)])
    g.node("Identity", [y], outs[:1])


@register_onnx_lowering("aten.constant_pad_nd")
def _pad(g, node, ins, outs):
    """Zero (or constant) padding as a Concat of constant blocks."""
    x, pad = ins[0], list(ins[1])
    value = ins[2] if len(ins) > 2 else 0.0
    name, shape = x.name, list(x.shape)
    for i in range(len(pad) // 2):
        dim = len(shape) - 1 - i
        lo, hi = pad[2 * i], pad[2 * i + 1]
        if lo < 0 or hi < 0:
            raise NotImplementedError("negative padding")
        parts = []
        for k in (lo, hi):
            blk = list(shape)
            blk[dim] = k
            parts.append(g.constant(np.full(blk, value, x.dtype))
                         if k else None)
        name = g.node("Concat", [p for p in (parts[0], name, parts[1])
                                 if p is not None], axis=dim)
        shape[dim] += lo + hi
    g.node("Identity", [name], outs)


def _constant_of(g, node, ins, outs):
    """Ops whose value follows from static shapes alone (full, arange,
    zeros_like ...): run on the CPU at export and folded into an
    initializer."""
    def real(a):
        if isinstance(a, _Value):
            return torch.zeros(a.shape, dtype=_NP_TORCH[a.dtype])
        return a
    kwargs = {k: v for k, v in node.kwargs.items()
              if k not in ("device", "pin_memory")}
    arr = node.target(*[real(a) for a in ins], **kwargs)
    g.node("Identity", [g.constant(arr.numpy().astype(_out_dtype(node)),
                                   "fold")], outs)


for _op in ("full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
            "arange", "scalar_tensor"):
    ONNX_LOWERINGS[f"aten.{_op}"] = _constant_of


@register_onnx_lowering("aten.index")
def _index(g, node, ins, outs):
    """``x[i0, i1, ...]`` with index tensors over leading dims (advanced
    indexing) as one GatherND over their broadcast stack."""
    x, idx = ins[0], ins[1]
    if any(i is None for i in idx):
        raise NotImplementedError("index with a full slice before it")
    bshape = np.broadcast_shapes(*[i.shape for i in idx])
    parts = []
    for i, dim_size in zip(idx, x.shape):
        e = g.node("Cast", [i.name], to=_DTYPES[np.dtype(np.int64)])
        e = g.node("Expand", [e, g.shape(bshape)])
        parts.append(g.node("Reshape", [e, g.shape(list(bshape) + [1])]))
    stack = g.node("Concat", parts, axis=len(bshape))
    g.node("GatherND", [x.name, stack], outs)


@register_onnx_lowering("aten.gather")
def _gather(g, node, ins, outs):
    g.node("GatherElements", [ins[0].name, ins[2].name], outs,
           axis=ins[1] % len(ins[0].shape))


@register_onnx_lowering("aten.topk")
def _topk(g, node, ins, outs):
    x, k = ins[0], ins[1]
    dim = (ins[2] if len(ins) > 2 else -1) % len(x.shape)
    largest = ins[3] if len(ins) > 3 else True
    g.node("TopK", [x.name, g.shape([k])], outs, axis=dim,
           largest=int(bool(largest)), sorted=1)


@register_onnx_lowering("aten.sort")
def _sort(g, node, ins, outs):
    x = ins[0]
    dim = (ins[1] if len(ins) > 1 else -1) % len(x.shape)
    desc = ins[2] if len(ins) > 2 else node.kwargs.get("descending", False)
    g.node("TopK", [x.name, g.shape([x.shape[dim]])], outs, axis=dim,
           largest=int(bool(desc)), sorted=1)


@register_onnx_lowering("dltpu.flash_fwd")
def _flash_fwd(g, node, ins, outs):
    """K1's forward as plain ONNX: softmax(Q Kᵀ · scale) · V and the row
    log-sum-exp, over (B, H, N, D) in float32."""
    q, k, v, scale, causal = ins[:5]
    if causal:
        raise NotImplementedError("causal flash attention")
    kt = g.node("Transpose", [k.name], perm=[0, 1, 3, 2])
    s = g.node("Mul", [g.node("MatMul", [q.name, kt]),
                       g.constant(np.asarray(scale, q.dtype))])
    m = g.node("ReduceMax", [s], axes=[3], keepdims=1)
    e = g.node("Exp", [g.node("Sub", [s, m])])
    total = g.node("ReduceSum", [e], axes=[3], keepdims=1)
    g.node("MatMul", [g.node("Div", [e, total]), v.name], outs[:1])
    lse = g.node("Add", [g.node("Log", [total]), m])
    g.node("Reshape", [lse, g.shape(_val(node)[1].shape)], outs[1:2])


# ---------------------------------------------------------------- export

_SKIP = ("aten._assert_tensor_metadata", "aten._assert_scalar",
         "aten.sym_constrain_range_for_size")


def _op_name(target) -> str:
    packet = getattr(target, "_overloadpacket", None)
    return str(packet) if packet is not None else str(target)


def export_onnx(fn: Callable, example_args: Sequence[Any],
                path: Optional[str] = None,
                graph_name: str = "deeplearning_tpu_torch") -> bytes:
    """``torch.export`` ``fn`` (a module or a function) on
    ``example_args``, decompose to core ATen, and serialize the graph as
    an ONNX ModelProto (opset 12). Parameters and buffers become
    initializers; inputs are ``input_i``, outputs ``output_i``. Returns
    the bytes; writes ``path`` if given."""
    with torch.no_grad():
        ep = torch.export.export(_as_module(fn), tuple(example_args))
        ep = ep.run_decompositions()
    g = _GraphBuilder()
    values: Dict[Any, Any] = {}
    state = {**ep.state_dict, **ep.constants}
    inputs = []
    user_i = 0
    for spec, ph in zip(ep.graph_signature.input_specs,
                        (n for n in ep.graph.nodes if n.op == "placeholder")):
        val = ph.meta["val"]
        if not isinstance(val, torch.Tensor):
            raise NotImplementedError(f"non-tensor input {ph.name}")
        dt, shape = _np_dtype(val), tuple(val.shape)
        if spec.kind.name == "USER_INPUT":
            name = f"input_{user_i}"
            user_i += 1
            inputs.append(_value_info(name, shape, dt))
        else:
            name = g.constant(state[spec.target].detach().cpu().numpy()
                              .astype(dt), "w")
        values[ph] = _Value(name, dt, shape)

    def to_arg(a):
        if isinstance(a, torch.fx.Node):
            return values[a]
        if isinstance(a, (list, tuple)):
            return type(a)(to_arg(x) for x in a)
        return a

    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node.target)
        if node.target is operator.getitem:
            values[node] = values[node.args[0]][node.args[1]]
            continue
        if name in _SKIP:
            continue
        if name not in ONNX_LOWERINGS:
            raise NotImplementedError(
                f"no ONNX lowering for op '{name}'; add one with "
                "register_onnx_lowering (the support_new_ops.py analog)")
        val = node.meta["val"]
        vals = list(val) if isinstance(val, (tuple, list)) else [val]
        outs = [g.fresh("v") for _ in vals]
        ONNX_LOWERINGS[name](g, node, [to_arg(a) for a in node.args], outs)
        made = [_Value(o, _np_dtype(t), tuple(t.shape))
                if isinstance(t, torch.Tensor) else None
                for o, t in zip(outs, vals)]
        values[node] = made if isinstance(val, (tuple, list)) else made[0]

    outputs, renames = [], []
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    for i, res in enumerate(out_node.args[0]):
        v = values[res]
        name = f"output_{i}"
        renames.append(_node_proto("Identity", [v.name], [name], {}))
        outputs.append(_value_info(name, v.shape, v.dtype))

    graph = b"".join(
        [_len_field(1, n) for n in g.nodes + renames]
        + [_len_field(2, graph_name.encode())]
        + [_len_field(5, t) for t in g.initializers]
        + [_len_field(11, i) for i in inputs]
        + [_len_field(12, o) for o in outputs])
    opset = _int_field(2, OPSET)                   # default domain ""
    model = b"".join([
        _int_field(1, IR_VERSION),
        _len_field(2, b"deeplearning_tpu_torch"),
        _len_field(7, graph),
        _len_field(8, opset),
    ])
    if path:
        with open(path, "wb") as f:
            f.write(model)
    return model


# ------------------------------------------------------------------ load

def _parse_tensor(blob: bytes) -> Tuple[str, np.ndarray]:
    r = _Reader(blob)
    dims: List[int] = []
    dtype = 1
    raw = b""
    name = ""
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            dims += _read_packed_ints(val) if wire == 2 else [val]
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    arr = np.frombuffer(raw, _DTYPES_INV[dtype]).reshape(dims)
    return name, arr


def _signed64(v: int) -> int:
    """Protobuf int64 varints are two's complement; undo the encoder's
    `n & (1<<64)-1` so negative attributes (axis=-1) read back signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(blob: bytes) -> Tuple[str, Any]:
    r = _Reader(blob)
    name, value, ints = "", None, []
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            name = val.decode()
        elif field == 2:
            value = val
        elif field == 3:
            value = _signed64(val)
        elif field == 4:
            value = val.decode()
        elif field == 8:
            ints += ([_signed64(v) for v in _read_packed_ints(val)]
                     if wire == 2 else [_signed64(val)])
    return name, (ints if ints else value)


def _parse_node(blob: bytes) -> Dict[str, Any]:
    r = _Reader(blob)
    node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 2:
            node["outputs"].append(val.decode())
        elif field == 4:
            node["op"] = val.decode()
        elif field == 5:
            k, v = _parse_attr(val)
            node["attrs"][k] = v
    return node


def _parse_value_info(blob: bytes) -> str:
    r = _Reader(blob)
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            return val.decode()
    return ""


def load_onnx(data: bytes) -> Dict[str, Any]:
    """Parse serialized ONNX bytes into {nodes, initializers, inputs,
    outputs}."""
    r = _Reader(data)
    graph_blob = None
    while not r.eof():
        field, wire, val = r.field()
        if field == 7:
            graph_blob = val
    if graph_blob is None:
        raise ValueError("no GraphProto in model")
    g = _Reader(graph_blob)
    out = {"nodes": [], "initializers": {}, "inputs": [], "outputs": []}
    while not g.eof():
        field, wire, val = g.field()
        if field == 1:
            out["nodes"].append(_parse_node(val))
        elif field == 5:
            name, arr = _parse_tensor(val)
            out["initializers"][name] = arr
        elif field == 11:
            out["inputs"].append(_parse_value_info(val))
        elif field == 12:
            out["outputs"].append(_parse_value_info(val))
    return out


# ------------------------------------------------------------- evaluator

def _np_cast(arr, to):
    return np.asarray(arr).astype(_DTYPES_INV[to])


def _np_slice(x):
    data, starts, ends = x[0], x[1], x[2]
    axes = x[3] if len(x) > 3 else np.arange(len(starts))
    steps = x[4] if len(x) > 4 else np.ones(len(starts), np.int64)
    idx = [slice(None)] * data.ndim
    for a, s0, e0, st in zip(axes, starts, ends, steps):
        idx[int(a)] = slice(int(s0), int(e0), int(st))
    return data[tuple(idx)]


def _eval_node(node: Dict[str, Any], vals: Dict[str, np.ndarray]):
    op = node["op"]
    A = node["attrs"]
    x = [np.asarray(vals[i]) for i in node["inputs"]]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if op == "Conv":
        pads = A.get("pads", [0, 0, 0, 0])
        if pads[:2] != pads[2:]:
            raise NotImplementedError("asymmetric Conv padding")
        y = torch.nn.functional.conv2d(
            t(x[0]), t(x[1]),
            stride=tuple(A["strides"]), padding=tuple(pads[:2]),
            dilation=tuple(A.get("dilations", [1, 1])),
            groups=int(A.get("group", 1)))
        return y.numpy()
    if op == "MaxPool":
        pads = A.get("pads", [0, 0, 0, 0])
        if pads[:2] != pads[2:]:
            raise NotImplementedError("asymmetric MaxPool padding")
        y = torch.nn.functional.max_pool2d(
            t(x[0]), tuple(A["kernel_shape"]),
            tuple(A["strides"]), tuple(pads[:2]))
        return y.numpy()
    if op == "Erf":
        return torch.erf(t(x[0])).numpy()
    simple = {
        "Add": lambda: x[0] + x[1], "Sub": lambda: x[0] - x[1],
        "Mul": lambda: x[0] * x[1], "Div": lambda: x[0] / x[1],
        "Max": lambda: np.maximum(x[0], x[1]),
        "Min": lambda: np.minimum(x[0], x[1]),
        "Pow": lambda: np.power(x[0], x[1]),
        "Neg": lambda: -x[0], "Exp": lambda: np.exp(x[0]),
        "Log": lambda: np.log(x[0]), "Tanh": lambda: np.tanh(x[0]),
        "Sqrt": lambda: np.sqrt(x[0]),
        "Reciprocal": lambda: 1.0 / x[0],
        "Sigmoid": lambda: 1.0 / (1.0 + np.exp(-x[0])),
        "Abs": lambda: np.abs(x[0]), "Sign": lambda: np.sign(x[0]),
        "Floor": lambda: np.floor(x[0]), "Ceil": lambda: np.ceil(x[0]),
        "Identity": lambda: x[0],
        "Equal": lambda: x[0] == x[1], "Less": lambda: x[0] < x[1],
        "Greater": lambda: x[0] > x[1],
        "LessOrEqual": lambda: x[0] <= x[1],
        "GreaterOrEqual": lambda: x[0] >= x[1],
        "And": lambda: np.logical_and(x[0], x[1]),
        "Or": lambda: np.logical_or(x[0], x[1]),
        "Not": lambda: np.logical_not(x[0]),
        "Where": lambda: np.where(x[0], x[1], x[2]),
        "MatMul": lambda: np.matmul(x[0], x[1]),
        "Reshape": lambda: x[0].reshape([int(d) for d in x[1]]),
        "Expand": lambda: np.broadcast_to(
            x[0], [int(d) for d in x[1]]).copy(),
        "Concat": lambda: np.concatenate(x, axis=int(A["axis"])),
        "Transpose": lambda: np.transpose(x[0], A["perm"]),
        "Cast": lambda: _np_cast(x[0], int(A["to"])),
        "ReduceSum": lambda: np.sum(
            x[0], axis=tuple(A["axes"]), keepdims=bool(A["keepdims"])),
        "ReduceMax": lambda: np.max(
            x[0], axis=tuple(A["axes"]), keepdims=bool(A["keepdims"])),
        "ReduceMin": lambda: np.min(
            x[0], axis=tuple(A["axes"]), keepdims=bool(A["keepdims"])),
        "ReduceProd": lambda: np.prod(
            x[0], axis=tuple(A["axes"]), keepdims=bool(A["keepdims"])),
        "Slice": lambda: _np_slice(x),
        "GatherND": lambda: x[0][tuple(
            np.asarray(x[1])[..., j] for j in range(x[1].shape[-1]))],
        "GatherElements": lambda: np.take_along_axis(
            x[0], np.asarray(x[1], np.int64), axis=int(A["axis"])),
        "ArgMax": lambda: np.argmax(x[0], axis=int(A["axis"])).astype(
            np.int64) if not int(A.get("keepdims", 1)) else np.argmax(
            x[0], axis=int(A["axis"]), keepdims=True).astype(np.int64),
    }
    if op == "TopK":
        k = int(np.asarray(x[1]).reshape(-1)[0])
        axis = int(A.get("axis", -1))
        largest = int(A.get("largest", 1))
        key = -x[0] if largest else x[0]
        idx = np.argsort(key, axis=axis, kind="stable")
        idx = np.take(idx, np.arange(k), axis=axis)
        vals_ = np.take_along_axis(x[0], idx, axis=axis)
        return (vals_, idx.astype(np.int64))
    if op not in simple:
        raise NotImplementedError(f"evaluator: unsupported op {op}")
    return simple[op]()


def run_onnx(graph: Dict[str, Any], *inputs: np.ndarray
             ) -> List[np.ndarray]:
    """Evaluate a parsed graph on numpy inputs (topological node order as
    serialized — the exporter emits in dependency order)."""
    vals: Dict[str, np.ndarray] = dict(graph["initializers"])
    for name, arr in zip(graph["inputs"], inputs):
        vals[name] = np.asarray(arr)
    for node in graph["nodes"]:
        out = _eval_node(node, vals)
        outs = node["outputs"]
        if isinstance(out, tuple):
            if len(outs) > len(out):
                raise NotImplementedError("output arity mismatch")
            vals.update(zip(outs, out))
        elif len(outs) != 1:
            raise NotImplementedError("multi-output node")
        else:
            vals[outs[0]] = out
    return [vals[o] for o in graph["outputs"]]
