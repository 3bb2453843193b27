"""The port's export (deeplearning_tpu_torch/export/: serialize, onnx,
fuse, custom_op and the CLI) and its kernels' custom-op binding, vs the
JAX package's export (deeplearning_tpu/export/, tools/export.py), on the
CPU.

- The kernels' ``dltpu::`` custom ops pass ``torch.library.opcheck``
  (schema, autograd registration, fake tensors with the real strides), and
  a (B, N, H, D) layout stays one in fake mode, on the card's device too.
- ``fuse_conv_bn`` equals JAX's on the same weights and ``batch_stats``.
- ``export_onnx`` round-trips mnist_cnn, resnet18 (float32), an attention
  block and yolox_nano with decode (JAX's tests/test_onnx_export.py): the
  loaded file's result is within 1e-4 of the port's eager forward and of
  JAX's forward on the converted weights, and JAX's ``run_onnx`` on the
  port's file gives the port's numbers (every node type is in JAX's
  evaluator table).
- ``register_onnx_lowering`` and the error that names it behave as JAX's.
- A ``.pt2`` round trip of ViT-B/16 on K1 keeps its kernel nodes and
  launches nothing at export; ``my_add`` gives 3a + 2b and exports as one
  node; the export CLI's ONNX self-check passes; ``savedmodel`` raises
  naming item 8d.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.export import fuse as jfuse
from deeplearning_tpu.export import onnx as jonnx
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.export import fuse as tfuse
from deeplearning_tpu_torch.export import onnx as tonnx
from deeplearning_tpu_torch.export import serialize
from deeplearning_tpu_torch.export.custom_op import my_add
from deeplearning_tpu_torch.ops import flash_attention as fa
from deeplearning_tpu_torch.ops import nms as tnms
from deeplearning_tpu_torch.utils.convert import (as_state_dict, flax_path,
                                                  to_flax_order)
from torch_threads import one_torch_thread  # noqa: F401


def seeded_tree(shapes, seed=0):
    """A flax variable tree of numpy arrays over ``shapes``: kernels
    N(0, 1/fan_in), biases N(0, 0.1²), scales 1 + N(0, 0.1²), means
    N(0, 0.1²), variances U(0.5, 1.5) (nonzero scales: a zero scale would
    hide a wrong conv)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            value = rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        return (value + (name == "scale")).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(jmodel, tmodel, x, seed=0, **kw):
    """The JAX model's seeded variables and the port model holding them."""
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.asarray(x), **kw))
    variables = seeded_tree(shapes, seed)
    tmodel.load_state_dict(as_state_dict(variables, like=tmodel),
                           strict=False)
    return variables, tmodel.eval()


def _images(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------ the custom-op binding
# schema, autograd registration, fake tensors (shapes, dtypes, strides)
OPCHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


def test_kernel_ops_pass_opcheck():
    """Schema, autograd registration and fake tensors whose strides equal
    the real implementation's, for every kernel op."""
    opcheck = lambda op, args: torch.library.opcheck(  # noqa: E731
        op, args, test_utils=OPCHECKS)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 9, 16, generator=g) for _ in range(3))
    for bnhd in (False, True):
        args = [t.transpose(1, 2).contiguous().transpose(1, 2) if bnhd
                else t for t in (q, k, v)]
        opcheck(torch.ops.dltpu.flash_fwd,
                              (*[a.detach().requires_grad_() for a in args],
                               0.25, False, 2, bnhd))
        o, lse = fa.flash_attention_reference(q, k, v)
        do = torch.randn(o.shape, generator=g)
        delta = (do * o).sum(-1)
        opcheck(torch.ops.dltpu.flash_bwd_dq,
                              (q, k, v, o, lse, do, None, 0.25, False, 2,
                               False, bnhd))
        opcheck(torch.ops.dltpu.flash_bwd_dkv,
                              (q, k, v, lse, do, delta, 0.25, False, 2,
                               False, bnhd))
    qkv = torch.randn(4, 49, 3, 2, 8, generator=g, requires_grad=True)
    bias = torch.randn(2, 49, 49, generator=g, requires_grad=True)
    mask = torch.randn(2, 49, 49, generator=g)
    opcheck(torch.ops.dltpu.window_attn, (qkv, bias, mask, 8))
    sboxes, alive0, _, _ = tnms.sort_pad_candidates(
        torch.rand(2, 100, 4, generator=g).cumsum(-1),
        torch.rand(2, 100, generator=g), float("-inf"), tnms.WORD)
    opcheck(torch.ops.dltpu.nms_sweep,
                          (sboxes, alive0, 0.5, 20))


def test_fake_bnhd_layout_on_the_card_device():
    """In fake mode on a CUDA device (no card needed) the forward and the
    gradients keep the (B, N, H, D) buffer's strides, as the kernels
    write them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        qb = torch.empty(2, 9, 4, 64, device="cuda")
        q = qb.transpose(1, 2)
        o, lse = torch.ops.dltpu.flash_fwd(q, q, q, 0.125, False, 4, True)
        dq, delta = torch.ops.dltpu.flash_bwd_dq(
            q, q, q, o, lse, o, None, 0.125, False, 4, False, True)
        assert o.device.type == "cuda"
        assert o.stride() == dq.stride() == q.stride() == (2304, 64, 256, 1)
        assert lse.shape == delta.shape == (2, 4, 9)


# --------------------------------------------------------------- fuse
def test_fuse_conv_bn_equals_jax():
    x = _images((1, 32, 32, 3))
    jmodel = JMODELS.build("resnet18", num_classes=4, dtype=jnp.float32)
    tmodel = TMODELS.build("resnet18", num_classes=4, dtype=torch.float32)
    variables, tmodel = _pair(jmodel, tmodel, x, train=False)
    jf = jfuse.fuse_conv_bn(variables)
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tf = tfuse.fuse_conv_bn(state)
    n_pairs = 0
    for name, t in tf.items():
        if name.endswith("num_batches_tracked"):
            continue
        path = flax_path(name, t.dim())
        tree = jf["batch_stats" if path.endswith(("/mean", "/var"))
                  else "params"]
        for part in path.split("/"):
            tree = tree[part]
        np.testing.assert_allclose(to_flax_order(name, t).numpy(),
                                   np.asarray(tree), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        n_pairs += name.endswith(".running_var")
    assert n_pairs == 20
    # the fused weights serve the same logits (the module's own epsilon)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = tmodel(xt)

    def probe(sd):
        tmodel.load_state_dict(sd)
        with torch.no_grad():
            return tmodel(xt)

    fused = tfuse.fuse_conv_bn(
        state, eps=lambda bn: tmodel.get_submodule(bn).eps, verify=probe,
        verify_tol=1e-4)
    torch.testing.assert_close(probe(fused), want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="self-check failed"):
        tfuse.fuse_conv_bn(state, eps=10.0, verify=probe)


# --------------------------------------------------------------- ONNX
def _roundtrip(tfn, jfn, x, tol=1e-4):
    """Export the port's fn, load the file back and run it through both
    evaluators; each result against the port's eager forward and JAX's."""
    blob = tonnx.export_onnx(tfn, [torch.from_numpy(x)])
    graph = tonnx.load_onnx(blob)
    got = tonnx.run_onnx(graph, x)
    with torch.no_grad():
        eager = tfn(torch.from_numpy(x))
    eager = eager if isinstance(eager, (tuple, list)) else [eager]
    want = jfn(jnp.asarray(x))
    want = want if isinstance(want, (tuple, list)) else [want]
    jgot = jonnx.run_onnx(jonnx.load_onnx(blob), x)
    for g, e, w, jg in zip(got, eager, want, jgot):
        np.testing.assert_allclose(g, e.numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)
        np.testing.assert_allclose(jg, g, rtol=tol, atol=tol)
    ops = {n["op"] for n in graph["nodes"]}
    assert ops <= set(_JAX_EVAL_OPS), ops - set(_JAX_EVAL_OPS)
    return blob, graph


_JAX_EVAL_OPS = (
    "Conv", "MaxPool", "Erf", "Add", "Sub", "Mul", "Div", "Max", "Min",
    "Pow", "Neg", "Exp", "Log", "Tanh", "Sqrt", "Reciprocal", "Sigmoid",
    "Abs", "Sign", "Floor", "Ceil", "Identity", "Equal", "Less", "Greater",
    "LessOrEqual", "GreaterOrEqual", "And", "Or", "Not", "Where", "MatMul",
    "Reshape", "Expand", "Concat", "Transpose", "Cast", "ReduceSum",
    "ReduceMax", "ReduceMin", "ReduceProd", "Slice", "GatherND",
    "GatherElements", "ArgMax", "TopK")


def test_mnist_cnn_roundtrip(tmp_path):
    x = _images((2, 28, 28, 1), seed=0)
    jmodel = JMODELS.build("mnist_cnn", num_classes=10, dtype=jnp.float32)
    tmodel = TMODELS.build("mnist_cnn", num_classes=10, in_chans=1,
                           dtype=torch.float32)
    variables, tmodel = _pair(jmodel, tmodel, x, train=False)
    jfn = jax.jit(lambda xx: jmodel.apply(variables, xx, train=False))
    path = tmp_path / "m.onnx"
    blob = tonnx.export_onnx(tmodel, [torch.from_numpy(x)], path=str(path))
    assert path.read_bytes() == blob
    _roundtrip(tmodel, jfn, x)


def test_resnet18_roundtrip():
    x = _images((1, 32, 32, 3))
    jmodel = JMODELS.build("resnet18", num_classes=4, dtype=jnp.float32)
    tmodel = TMODELS.build("resnet18", num_classes=4, dtype=torch.float32)
    variables, tmodel = _pair(jmodel, tmodel, x, train=False)
    jfn = jax.jit(lambda xx: jmodel.apply(variables, xx, train=False))
    _, graph = _roundtrip(tmodel, jfn, x)
    assert {"Conv", "MaxPool", "MatMul"} <= {n["op"] for n in graph["nodes"]}


def test_attention_block_roundtrip():
    """Transformer math (batched products, softmax, LayerNorm)."""
    from deeplearning_tpu.models.classification.vit import Block as JBlock
    from deeplearning_tpu_torch.models.classification.vit import Block
    x = _images((2, 5, 16), seed=2)
    jblock = JBlock(num_heads=2, dtype=jnp.float32)
    variables, tblock = _pair(jblock, Block(16, 2, dtype=torch.float32), x)
    _roundtrip(tblock, jax.jit(lambda xx: jblock.apply(variables, xx)), x)


def test_yolox_decoded_roundtrip():
    from deeplearning_tpu.models.detection import yolox as jyolox
    from deeplearning_tpu_torch.models.detection import yolox as tyolox
    x = _images((1, 32, 32, 3), seed=2)
    jmodel = JMODELS.build("yolox_nano", num_classes=3, dtype=jnp.float32)
    tmodel = TMODELS.build("yolox_nano", num_classes=3, dtype=torch.float32)
    variables, tmodel = _pair(jmodel, tmodel, x, train=False)
    centers, strides = jyolox.yolox_grid((32, 32))
    jfn = jax.jit(lambda xx: jyolox.decode_outputs(
        jmodel.apply(variables, xx, train=False), jnp.asarray(centers),
        jnp.asarray(strides)))
    tc, ts = torch.as_tensor(centers), torch.as_tensor(strides)
    _, graph = _roundtrip(
        lambda xx: tyolox.decode_outputs(tmodel(xx), tc, ts), jfn, x)
    assert "Slice" in {n["op"] for n in graph["nodes"]}   # the Focus stem


def test_unsupported_op_error_names_the_hook():
    x = torch.ones(3)
    with pytest.raises(NotImplementedError, match="register_onnx_lowering"):
        tonnx.export_onnx(lambda a: torch.atan2(a, a + 1.0), [x])
    with pytest.raises(NotImplementedError, match="register_onnx_lowering"):
        jonnx.export_onnx(lambda a: jnp.arctan2(a, a + 1.0),
                          [jnp.ones(3)])


def test_custom_lowering_registration(monkeypatch):
    """The support_new_ops.py flow, as JAX's test drives it: an op the
    exporter does not know gets a lowering and exports."""
    assert "aten.atan" not in tonnx.ONNX_LOWERINGS

    @tonnx.register_onnx_lowering("aten.atan")
    def _atan(g, node, ins, outs):
        g.node("Atan", [ins[0].name], outs)

    try:
        x = torch.linspace(-2, 2, 7)
        graph = tonnx.load_onnx(tonnx.export_onnx(
            lambda a: torch.atan(a) * 2.0, [x]))
        assert any(n["op"] == "Atan" for n in graph["nodes"])
        orig = tonnx._eval_node

        def patched(node, vals):
            if node["op"] == "Atan":
                return np.arctan(np.asarray(vals[node["inputs"][0]]))
            return orig(node, vals)
        monkeypatch.setattr(tonnx, "_eval_node", patched)
        got = tonnx.run_onnx(graph, x.numpy())[0]
        np.testing.assert_allclose(got, (torch.atan(x) * 2).numpy(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        tonnx.ONNX_LOWERINGS.pop("aten.atan", None)


# ---------------------------------------------------------- .pt2 and CLI
def test_pt2_roundtrip_keeps_the_k1_nodes(tmp_path):
    fa.reset_launch_counts()
    model, _ = hub.load("vit_base_patch16_224", num_classes=10, seed=0,
                        device="cpu", depth=2, dtype=torch.float32,
                        **hub.model_kwargs("vit_base_patch16_224",
                                           "flash_hb"))
    x = torch.from_numpy(_images((1, 224, 224, 3)))
    path = tmp_path / "vit.pt2"
    blob = serialize.export_program(model, [x], path)
    assert path.read_bytes() == blob
    assert all(v == 0 for v in fa.launch_counts().values())
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("dltpu.flash_fwd.default") == 2
    with torch.no_grad():
        torch.testing.assert_close(serialize.load_program(str(path))(x),
                                   model(x), atol=0, rtol=0)
    with pytest.raises(ValueError, match="item 8d"):
        serialize.export_savedmodel(model, [x], str(tmp_path / "sm"))


def test_my_add_gives_3a_plus_2b_and_exports():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 5, generator=g), torch.randn(4, 5, generator=g)
    torch.testing.assert_close(my_add(a, b), 3 * a + 2 * b, atol=0, rtol=0)
    torch.library.opcheck(torch.ops.dltpu.my_add, (a, b),
                          test_utils=OPCHECKS)
    blob = serialize.export_program(lambda p, q: my_add(p, q) - 1, [a, b])
    ep = torch.export.load(io.BytesIO(blob))
    assert "dltpu.my_add.default" in [str(n.target) for n in ep.graph.nodes]
    torch.testing.assert_close(serialize.load_program(blob)(a, b),
                               3 * a + 2 * b - 1)
    with pytest.raises(ValueError, match="one shape"):
        my_add(a, b[:2])


def test_export_cli(tmp_path, capsys):
    from deeplearning_tpu_torch.export.__main__ import main
    out = tmp_path / "lenet.onnx"
    assert main(["--model", "mnist_cnn", "--channels", "1", "--size", "28",
                 "--num-classes", "10", "--format", "onnx", "--out",
                 str(out), "--device", "cpu"]) == 0
    assert out.stat().st_size > 1000
    log = capsys.readouterr().out
    assert "load-back max|diff|=" in log and "FAILED" not in log
    with pytest.raises(ValueError, match="item 8d"):
        main(["--model", "mnist_cnn", "--size", "28", "--format",
              "savedmodel", "--out", str(tmp_path / "sm"), "--device",
              "cpu"])
