"""The port's tensor parallelism (deeplearning_tpu_torch/parallel/sharding's
qkv layout and ``bind_tensor_parallel``, collectives' ``copy_to_model`` /
``reduce_from_model``, the ViT's Megatron blocks, the mesh step under
``TRANSFORMER_TP_RULES``, ZeRO-1 and FSDP beside a ``model`` split, the
data x model x seq composition, the checkpoint and ``elastic_restore``
across layouts and the train CLI's ``train.mesh_model_axis``) vs the JAX
package, on the CPU.

JAX runs GSPMD on the virtual CPU devices of tests/conftest.py; the port
runs on gloo ranks spawned by tests/torch_ranks.py (scenario
``tensor_parallel``: one spawn of 2 ranks at model = 2, one of 4 at data
2 x model 2 and fsdp 2 x model 2, one of 8 at data 2 x model 2 x seq 2,
started at once; one torch thread each). The ViT is JAX's
``test_3d_parallel_train_step`` one (32², patch 8, embed 32, depth 2, 4
heads, float32), its weights numpy-made. Tolerances:

- the slices of every leaf but qkv and the gathered leaves: bit-equal to
  JAX's shards and whole leaves; a rank's qkv slice is whole heads of q,
  k and v (not JAX's contiguous shard), bit-equal to those rows;
- one SGD step (clip 1.0, momentum, weight decay) at model 2 and at data
  2 x model 2: loss and ``grad_norm`` rtol 1e-5, params atol 1e-5 of
  JAX's mesh step; eval sums: counts exact, loss rtol 1e-5;
- ZeRO-1 with the rules at data 2 x model 2, two steps: params and the
  momentum (split over data where a rule does not split it) atol 1e-5,
  the moment layout's counts and bytes a rank equal to JAX's;
- fsdp 2 x model 2 with a two-dim spec: as the SGD step;
- data 2 x model 2 x seq 2 with the ring (JAX's 3-D test): loss rtol
  1e-5, params atol 1e-5 of JAX's 3-D step (JAX's own test holds it to
  its plain data-parallel step at rtol 1e-4 / atol 1e-4);
- the masks at drop-path and dropout 0.1 and Swin through the gather
  path, against the same mesh without rules: atol 1e-5, and the leaves
  the layout does not split bit-equal across the model ranks;
- checkpoints: a data-parallel AdamW state restored onto data 1 x model
  2 and back with params and moments bit-equal;
- the CLI with ``train.mesh_model_axis=2``: eval sums rtol 1e-6 of its
  own run without the axis.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.parallel import mesh as jmesh_mod
from deeplearning_tpu.parallel import sharding as jsharding
from deeplearning_tpu.parallel.ring_attention import (
    make_ring_attn_fn as j_ring_fn)
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import make_eval_step as j_make_eval_step
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu.train import optim as joptim
from deeplearning_tpu.train.steps import shard_state as j_shard_state
from deeplearning_tpu_torch.models.classification.swin import SwinTransformer
from deeplearning_tpu_torch.parallel import collectives as tcoll
from deeplearning_tpu_torch.parallel import sharding as tsharding
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_ranks import (FSDP_TP_RULES, SGD, TP_CLI, TP_LR, TP_SWIN, TP_VIT,
                         run_ranks)
from torch_threads import one_torch_thread  # noqa: F401

JP = jax.sharding.PartitionSpec
QKV = "blocks.0.attn.qkv.weight"


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _jmesh(n, **axes):
    return jmesh_mod.build_mesh(jmesh_mod.MeshConfig(**axes),
                                devices=jax.devices()[:n])


def _flax(seed):
    model = jvit.VisionTransformer(**TP_VIT, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return seeded_tree(shapes, seed=seed)["params"]


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(0)
    flax = _flax(1)
    swin = SwinTransformer(**TP_SWIN, dtype=torch.float32,
                           generator=torch.Generator().manual_seed(2))
    return {"tp_flax": flax, "tp_vit": from_flax_params(flax),
            "tp_other": from_flax_params(_flax(3)),
            "tp_swin": swin.state_dict(),
            "tp_batch": {"image": g.normal(size=(8, 32, 32, 3)).astype(
                np.float32), "label": g.integers(0, 4, 8)}}


class _Spawned:
    def __init__(self, runs):
        self._runs = runs

    def __getitem__(self, n):
        return self._runs[n].result()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, inputs):
    """The three spawns at once, from the module's start."""
    from concurrent.futures import ThreadPoolExecutor
    payload = {k: v for k, v in inputs.items() if k != "tp_flax"}
    with ThreadPoolExecutor(3) as pool:
        yield _Spawned({n: pool.submit(
            run_ranks, "tensor_parallel", n,
            tmp_path_factory.mktemp(f"tp{n}"), payload) for n in (2, 4, 8)})


def _jstate(inputs, mesh, rules=None, opt="sgd", zero1=False, **model_kw):
    model = jvit.VisionTransformer(**TP_VIT, dtype=jnp.float32, **model_kw)
    params = jax.tree.map(jnp.asarray, inputs["tp_flax"])
    tx = (optax.sgd(TP_LR) if opt == "sgd0" else joptim.build_optimizer(
        "sgd", SGD["lr"], momentum=SGD["momentum"],
        weight_decay=SGD["weight_decay"], clip_grad_norm=SGD["clip"],
        params=params))
    return j_shard_state(JTrainState.create(apply_fn=model.apply,
                                            params=params, tx=tx),
                         mesh, rules, zero1=zero1)


def _jsteps(state, mesh, inputs, steps=1, **kw):
    step = j_make_train_step(jcls.make_loss_fn(), mesh=mesh, **kw)
    data = jax.device_put({k: jnp.asarray(v)
                           for k, v in inputs["tp_batch"].items()},
                          jsharding.batch_sharding(mesh))
    metrics = []
    for _ in range(steps):
        state, m = step(state, data, jax.random.key(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, data


def _jmoments(opt_state):
    """{"<moment>/<port name>": array} of JAX's trace / mu / nu trees."""
    out = {}

    def walk(node):
        for name in ("trace", "mu", "nu"):
            tree = getattr(node, name, None)
            if hasattr(node, "_fields") and tree is not None:
                out.update({f"{name}/{k}": v.numpy() for k, v in
                            from_flax_params(jax.tree.map(
                                np.asarray, tree)).items()})
        if isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
    walk(opt_state)
    return out


def _hold(got, jstate, jmetrics, what, moments=False):
    """A rank's run against JAX's: every step's loss and grad_norm rtol
    1e-5, the gathered params (and moments) atol 1e-5."""
    for g_, w_ in zip(got["metrics"], jmetrics):
        np.testing.assert_allclose(g_["loss"], w_["loss"], rtol=1e-5,
                                   err_msg=f"{what} loss")
        np.testing.assert_allclose(g_["grad_norm"], w_["grad_norm"],
                                   rtol=1e-5, err_msg=f"{what} grad_norm")
    want = from_flax_params(jax.tree.map(np.asarray, jstate.params))
    assert set(got["params"]) == set(want)
    for k, v in got["params"].items():
        _close(v, want[k].numpy(), 1e-5, f"{what} {k}")
    if moments:
        jm = _jmoments(jstate.opt_state)
        assert set(got["moments"]) == set(jm) and jm
        for k, v in got["moments"].items():
            _close(v, jm[k], 1e-5, f"{what} {k}")


# ------------------------------------------------- without ranks
def test_qkv_slices_follow_the_heads_and_gather_back():
    """``local_slice`` / ``gather_global`` of a leaf split within its 3
    parts, at one rank of 2 and 4 (no collective: the slices are joined
    here), against the head rows of q, k and v. The rules alone give
    JAX's spec, a contiguous cut: the parts are the bound Attention's
    (``tp_layout``), recorded by ``bind_tensor_parallel``."""
    from deeplearning_tpu_torch.models.classification.vit import Attention
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    x = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    for n in (2, 4):
        lay = None
        slices = []
        for r in range(n):
            m = build_mesh(MeshConfig(data=1, model=n), n, r, device="cpu")
            rule = tsharding.logical_to_sharding(
                m, tsharding.TRANSFORMER_TP_RULES)(
                "blocks.0.attn.qkv.weight", x)
            assert rule.spec == tsharding.P("model", None) and not rule.parts
            lay = tsharding.NamedSharding(
                m, rule.spec, (Attention(8, 4).tp_layout(n)["qkv.weight"],))
            slices.append(tsharding.local_slice(x, lay))
        assert lay.parts == ((0, 3),) and lay.shard_shape(x.shape) == (
            24 // n, 5)
        rows = x.view(3, n, 8 // n, 5)
        for r, s in enumerate(slices):
            assert torch.equal(s, rows[:, r].reshape(-1, 5))
        joined = torch.cat(slices).view(n, 3, -1, 5).transpose(0, 1)
        assert torch.equal(joined.reshape(24, 5), x)
        with pytest.raises(ValueError, match="not a view"):
            tsharding.local_slice(x, lay, view=True)
    # a dim split over model and another axis at once is refused
    m = build_mesh(MeshConfig(data=2, model=2), 4, 0, device="cpu")
    with pytest.raises(ValueError, match="at once"):
        tsharding.NamedSharding(m, tsharding.P(("data", "model"))).over(
            ("model",))


def test_copy_and_reduce_issue_no_collective_at_one_rank():
    """Megatron's operators over a group of one: the identity both ways,
    no collective issued (as ``ppermute`` at one rank)."""
    import torch.distributed as dist
    from deeplearning_tpu_torch.parallel.mesh import initialize_distributed
    started = initialize_distributed(device="cpu")
    try:
        x = torch.randn(3, 4, requires_grad=True)
        tcoll.reset_launch_counts()
        y = tcoll.reduce_from_model(tcoll.copy_to_model(x, None), None)
        y.backward(torch.ones(3, 4))
        assert y is x and torch.equal(x.grad, torch.ones(3, 4))
        assert not any(tcoll.launch_counts().values())
    finally:
        if started:
            dist.destroy_process_group()


# --------------------------------------------------- model = 2
def test_slices_and_gathered_leaves_match_jax(ranks, inputs):
    """Each rank's slice of every leaf but qkv equals JAX's shard on its
    device; its qkv slice is whole heads of q, k and v; the gathered
    leaves equal JAX's whole ones; the bytes a rank holds and the layout
    summary's counts are JAX's; every Attention and Mlp runs on its
    slices."""
    jm = _jmesh(2, data=1, model=2)
    jparams = jax.tree.map(jnp.asarray, inputs["tp_flax"])
    placed = jax.device_put(jparams, jsharding.shard_params_tree(
        jparams, jm, jsharding.TRANSFORMER_TP_RULES))
    whole = from_flax_params(jax.tree.map(np.asarray, jparams))
    jsum = jsharding.shard_layout_summary(placed)
    d = TP_VIT["embed_dim"]
    for r, out in enumerate(ranks[2]):
        lay = out["layouts"]
        assert lay["bytes"] == jsharding.tree_bytes_per_device(placed)
        assert {k: lay["summary"][k] for k in ("leaves", "sharded")} == {
            k: jsum[k] for k in ("leaves", "sharded")}
        assert all(lay["groups"].values()) and len(lay["groups"]) == 4
        assert len(lay["native"]) == 16
        for k, v in lay["start"].items():
            np.testing.assert_array_equal(v, whole[k].numpy(), err_msg=k)
        dev = jax.devices()[r]
        shard = jax.tree.map(lambda a: np.asarray(next(
            s.data for s in a.addressable_shards if s.device == dev)),
            placed)
        want = from_flax_params(shard, like={
            k: torch.from_numpy(v) for k, v in lay["slices"].items()})
        for k, v in lay["slices"].items():
            if "qkv" not in k:
                np.testing.assert_array_equal(v, want[k].numpy(),
                                              err_msg=f"rank {r} {k}")
                continue
            heads = whole[k].numpy().reshape(3, 2, d // 2, -1)[:, r]
            np.testing.assert_array_equal(v, heads.reshape(v.shape),
                                          err_msg=f"rank {r} {k}")
            if k == QKV:     # not JAX's contiguous shard of 3 * D outputs
                assert not np.array_equal(v, want[k].numpy())


def test_tp_step_and_eval_match_jax_gspmd(ranks, inputs):
    """One SGD step under TRANSFORMER_TP_RULES at model 2 against JAX's
    mesh step; the eval step on the TP state against JAX's; the model
    all-reduces a step: two forward and two backward a block."""
    jm = _jmesh(2, data=1, model=2)
    js, jmetrics, data = _jsteps(
        _jstate(inputs, jm, jsharding.TRANSFORMER_TP_RULES), jm, inputs)
    jev = j_make_eval_step(jcls.make_metric_fn(), mesh=jm)(js, data)
    for r, out in enumerate(ranks[2]):
        lay = out["layouts"]
        _hold(lay["sgd"], js, jmetrics, f"rank {r} model 2", moments=True)
        for k, v in jev.items():
            np.testing.assert_allclose(lay["eval"][k], float(v), rtol=1e-5,
                                       err_msg=k)
        counts = lay["sgd"]["counts"]
        # 4 a block, the packed gradients, the metrics, the norm's model
        # sum in the step and in the clip
        assert counts["all_reduce"] == 4 * TP_VIT["depth"] + 4
        assert counts["reduce_scatter"] == 0


def test_zero1_with_tp_rules_at_model_two(ranks, inputs):
    """ZeRO-1 with the rules at data 1: nothing for ZeRO-1 to split, the
    step equals JAX's zero1 step with the rules."""
    jm = _jmesh(2, data=1, model=2)
    js, jmetrics, _ = _jsteps(
        _jstate(inputs, jm, jsharding.TRANSFORMER_TP_RULES, zero1=True),
        jm, inputs, weight_update="zero1",
        rules=jsharding.TRANSFORMER_TP_RULES)
    for r, out in enumerate(ranks[2]):
        _hold(out["layouts"]["zero1"], js, jmetrics, f"rank {r} zero1",
              moments=True)


def test_masks_are_the_unsplit_models_and_replicas_stay_equal(ranks):
    """Two steps at drop-path, dropout and attention dropout 0.1 with the
    rules equal two on the same mesh without them (the hidden dropout's
    mask is the whole width's and the attention dropout's all heads',
    cut to the slice; the stream's masks follow the data index only); the
    leaves the layout does not split are bit-equal on the two
    model ranks."""
    outs = [o["layouts"] for o in ranks[2]]
    for r, lay in enumerate(outs):
        tp, rep = lay["drop_tp"], lay["drop_rep"]
        for a, b in zip(tp["metrics"], rep["metrics"]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for k, v in tp["params"].items():
            _close(v, rep["params"][k], 1e-5, f"rank {r} {k}")
    # the masks were drawn: the first loss is not the maskless step's
    assert outs[0]["drop_tp"]["metrics"][0]["loss"] != \
        outs[0]["sgd"]["metrics"][0]["loss"]
    a, b = (lay["drop_tp"]["replicated"] for lay in outs)
    assert set(a) == set(b) and len(a) > 10
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_swin_under_the_rules_trains_through_the_gather_path(ranks):
    """Swin under TRANSFORMER_TP_RULES: its window attention's qkv / proj
    are gathered before the forward (GSPMD's meaning of the rules), its
    Mlps (the ViT's) run on their slices; one step equals the same mesh
    without rules."""
    for r, out in enumerate(ranks[2]):
        tp, rep = out["layouts"]["swin_tp"], out["layouts"]["swin_rep"]
        assert tp["native"] and all("mlp" in k for k in tp["native"])
        assert any("attn.qkv" in k for k in tp["split"]["specs"])
        assert not rep["native"] and rep["split"]["sharded"] == 0
        np.testing.assert_allclose(tp["metrics"][0]["loss"],
                                   rep["metrics"][0]["loss"], rtol=1e-5)
        for k, v in tp["params"].items():
            _close(v, rep["params"][k], 1e-5, f"rank {r} swin {k}")


def test_reduce_refuses_a_model_split(ranks):
    """The gradient reduction names the axes it sums over (data x fsdp):
    a layout split over model is refused, never reduce-scattered."""
    for out in ranks[2]:
        assert out["layouts"]["refused"] == (
            "ValueError: w: a gradient split as PartitionSpec('model',) "
            "is reduced over ('data', 'fsdp'), one dim at most")


def test_checkpoint_restores_dp_onto_dp_x_tp_and_back(ranks, inputs):
    """A data-parallel AdamW state (one step) restored by
    ``elastic_restore(..., rules=TRANSFORMER_TP_RULES)`` onto data 1 x
    model 2: params and moments bit-equal, the qkv slice and its moment
    are the head rows; one step there, saved with a sidecar that records
    the model axis; restored back onto data 2, bit-equal again."""
    d = TP_VIT["embed_dim"]
    for r, out in enumerate(ranks[2]):
        ck = out["ckpt"]
        assert ck["step"] == 1 and ck["back_step"] == 2
        for tree in ("params", "moments"):
            assert set(ck["saved"][tree]) == set(ck["onto_tp"][tree])
            for k, v in ck["saved"][tree].items():
                np.testing.assert_array_equal(ck["onto_tp"][tree][k], v,
                                              err_msg=k)
            for k, v in ck["tp_step"][tree].items():
                np.testing.assert_array_equal(ck["back"][tree][k], v,
                                              err_msg=k)
        for got, key in ((ck["tp_qkv"], "params"),
                         (ck["tp_qkv_mu"], "moments")):
            src = (ck["saved"]["params"][QKV] if key == "params"
                   else ck["saved"]["moments"][f"mu/{QKV}"])
            np.testing.assert_array_equal(
                got, src.reshape(3, 2, d // 2, -1)[:, r].reshape(got.shape))
        assert np.isfinite(ck["tp_step"]["metrics"][0]["loss"])
        side = ck["sidecar"]
        assert side["mesh_shape"]["model"] == 2 and side["mesh_str"] == \
            "model=2" and side["process_count"] == 2
        assert any("qkv" in k for k in side["shard_layout"]["specs"])


def test_cli_model_axis_replicates_as_the_jax_cli(ranks, tmp_path):
    """``train.mesh_model_axis=2`` on two ranks: a model axis, the state
    placed without rules (tools/train.py:268), so nothing runs on slices
    and the model ranks repeat each other's work: the eval after the
    epoch equals this CLI's own run without the axis (the two CLIs draw
    their initial weights from different generators, so the port's is
    held to itself, as JAX's CLI replicates over its model axis)."""
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.train import __main__ as cli
    sys.modules.setdefault("torch.utils.tensorboard", None)
    argv = [a for a in TP_CLI if a != "train.mesh_model_axis=2"]
    trainer = cli.build(config_cli(cli.Config(), argv + [
        f"train.workdir={tmp_path}"]))
    trainer.train()
    want = trainer.evaluate()
    outs = [o["cli"] for o in ranks[2]]
    assert outs[0] == outs[1]
    got = outs[0]
    assert got["step"] == trainer.state.step == 2 and got["native"] == []
    assert got["mesh"]["model"] == 2 and got["mesh"]["data"] == 1
    assert set(got["eval"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["eval"][k], v, rtol=1e-6, err_msg=k)


# ------------------------------------------------------ four ranks
def test_data_x_model_step_matches_jax(ranks, inputs):
    """data 2 x model 2: one SGD step and the eval against JAX's."""
    jm = _jmesh(4, data=2, model=2)
    js, jmetrics, data = _jsteps(
        _jstate(inputs, jm, jsharding.TRANSFORMER_TP_RULES), jm, inputs)
    jev = j_make_eval_step(jcls.make_metric_fn(), mesh=jm)(js, data)
    for r, out in enumerate(ranks[4]):
        _hold(out["dp_tp"], js, jmetrics, f"rank {r} data x model",
              moments=True)
        for k, v in jev.items():
            np.testing.assert_allclose(out["dp_tp"]["eval"][k], float(v),
                                       rtol=1e-5, err_msg=k)


def test_zero1_beside_the_rules_matches_jax(ranks, inputs):
    """ZeRO-1 with the rules at data 2 x model 2, two steps: a rule's leaf
    keeps its model split, the rest split their momentum over data; the
    layout's counts and a rank's moment bytes are JAX's."""
    jm = _jmesh(4, data=2, model=2)
    start = _jstate(inputs, jm, jsharding.TRANSFORMER_TP_RULES, zero1=True)
    jlay = jsharding.shard_layout_summary(start.opt_state)
    jbytes = jsharding.tree_bytes_per_device(start.opt_state)
    js, jmetrics, _ = _jsteps(start, jm, inputs, steps=2,
                              weight_update="zero1",
                              rules=jsharding.TRANSFORMER_TP_RULES)
    for r, out in enumerate(ranks[4]):
        assert out["zero1_bytes"] == jbytes
        assert {k: out["zero1_layout"][k] for k in ("sharded",)} == {
            k: jlay[k] for k in ("sharded",)}
        _hold(out["zero1"], js, jmetrics, f"rank {r} zero1 x model",
              moments=True)


def test_fsdp_x_model_two_dim_spec_matches_jax(ranks, inputs):
    """fsdp 2 x model 2, each kernel split on both dims: the blocks run on
    their model slices gathered over fsdp, the gradients are
    reduce-scattered over fsdp; one SGD step against JAX's."""
    rules = tuple((pat, JP(*spec[::-1])) for pat, spec in FSDP_TP_RULES
                  if len(spec) == 2) + tuple(
        (pat, JP(*spec)) for pat, spec in FSDP_TP_RULES if len(spec) == 1)
    jm = _jmesh(4, data=1, fsdp=2, model=2)
    js, jmetrics, _ = _jsteps(_jstate(inputs, jm, rules), jm, inputs)
    d = TP_VIT["embed_dim"]
    for r, out in enumerate(ranks[4]):
        assert len(out["fsdp_native"]) == 16
        assert out["fsdp_qkv"] == (3 * d // 2, d // 2)
        _hold(out["fsdp_tp"], js, jmetrics, f"rank {r} fsdp x model",
              moments=True)


# ------------------------------------------------------- eight ranks
def test_3d_parallel_step_matches_jax(ranks, inputs):
    """JAX's test_3d_parallel_train_step configuration: data 2 x model 2
    x seq 2, the ring adapter (plain path, 17 tokens padded to 18) and
    the TP rules, one step of SGD at 0.01, against JAX's 3-D step."""
    jm = _jmesh(8, data=2, model=2, seq=2)
    js, jmetrics, _ = _jsteps(
        _jstate(inputs, jm, jsharding.TRANSFORMER_TP_RULES, opt="sgd0",
                attn_fn=j_ring_fn(jm)), jm, inputs)
    coords = set()
    for r, out in enumerate(ranks[8]):
        coords.add(tuple(out["coords"][a] for a in ("data", "seq", "model")))
        _hold(out, js, jmetrics, f"rank {r} 3-D")
    assert len(coords) == 8


def test_ulysses_refuses_local_heads_that_do_not_split(ranks):
    """Beside model 2 a rank holds 2 of the 4 heads; Ulysses over seq 4
    refuses them with JAX's message."""
    from deeplearning_tpu.parallel.ulysses import make_ulysses_attention
    jm = _jmesh(4, data=1, seq=4)
    x = jax.device_put(jnp.zeros((1, 2, 32, 8)), jax.sharding.NamedSharding(
        jm, JP(None, None, "seq", None)))
    with pytest.raises(ValueError) as e:
        make_ulysses_attention(jm)(x, x, x)
    for out in ranks[8]:
        assert out["ulysses_heads"] == f"ValueError: {e.value}"
