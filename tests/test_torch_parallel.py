"""The port's parallel half (deeplearning_tpu_torch/parallel/{mesh,sharding,
collectives}, train/steps' mesh step and shard_state, elastic/{topology,
resume}, the checkpoint's topology sidecar, the loader's rank slices,
evaluation/distributed) vs the JAX package, on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py; the port runs
on gloo ranks spawned by tests/torch_ranks.py (one torch thread each,
rendezvous through a file), the same numpy inputs on both sides.
Tolerances, stated per test:

- layouts: a rank's slice equals ``from_flax_params`` of JAX's shard on
  the same device, exactly (ZeRO-1: the same leaves split, the same bytes
  a rank; the port splits its own first divisible dim);
- int8 collectives: bit-equal on small integers; on Gaussian values
  within 2 ulp of the sum's magnitude; ``psum_tree`` / ``pmean_tree``
  exact on small integers;
- mesh steps (2 ranks, a 2-layer width-64 ViT, float32, SGD with
  momentum, weight decay and global-norm clipping, 3 steps): losses rtol
  1e-5, params rtol 1e-5 / atol 1e-6 for replicated, ZeRO-1 and FSDP; the
  int8 steps' first loss rtol 1e-5, each reduced gradient within 2/127
  of the largest local value of its leaf off the exact mean, and bit-equal
  to JAX's int8 collectives fed the same local gradients on the leaves
  whose layout is JAX's (1-D);
- a BatchNorm resnet18 step on 2 ranks (global-batch moments): losses
  rtol 1e-5, params and running statistics rtol 1e-4 / atol 1e-5;
- checkpoints, the feed and the evaluation: exact.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.evaluation.coco_eval import CocoEvaluator
from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.ops.attention import get_attn_fn as j_get_attn_fn
from deeplearning_tpu.parallel import mesh as jmesh_mod
from deeplearning_tpu.parallel import sharding as jsharding
from deeplearning_tpu.parallel._compat import shard_map
from deeplearning_tpu.parallel.collectives import (
    quantized_psum as j_qpsum, quantized_reduce_scatter as j_qrs)
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu.train import optim as joptim
from deeplearning_tpu.train.steps import shard_state as j_shard_state
from deeplearning_tpu_torch import models  # noqa: F401
from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.data.loader import ArraySource, DataLoader
from deeplearning_tpu_torch.elastic.resume import elastic_restore
from deeplearning_tpu_torch.elastic.topology import topology_changed
from deeplearning_tpu_torch.evaluation.distributed import (
    gather_and_evaluate, pack_shard)
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.parallel import mesh as tmesh
from deeplearning_tpu_torch.parallel import sharding as tsharding
from deeplearning_tpu_torch.train import TrainState
from deeplearning_tpu_torch.train import classification as tcls
from deeplearning_tpu_torch.train.optim import build_optimizer
from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                 shard_state)
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_distributed_eval import NUM_CLASSES, synth_image
from test_torch_detection import seeded_tree
from torch_ranks import MODES, RESNET_LR, SGD, STEPS, TINY_VIT, run_ranks
from torch_threads import one_torch_thread  # noqa: F401

AXES = (jmesh_mod.DATA_AXIS, jmesh_mod.FSDP_AXIS)
JP = jsharding.P


# ------------------------------------------------------------- fixtures
def _jvit(**kw):
    return jvit.VisionTransformer(**{**TINY_VIT, **kw}, dtype=jnp.float32,
                                  attn_fn=j_get_attn_fn("naive"))


@pytest.fixture(scope="module")
def vit_params():
    shapes = jax.eval_shape(functools.partial(_jvit().init, train=False),
                            jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    return seeded_tree(shapes, seed=1)["params"]


@pytest.fixture(scope="module")
def resnet_vars():
    jmodel = JMODELS.build("resnet18", num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    return seeded_tree(shapes, seed=2)


def _batches(n_steps, n, seed, classes=10):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, classes, n).astype(np.int64)}
            for _ in range(n_steps)]


def _shards(n_images=9, n_proc=2):
    rng = np.random.default_rng(0)
    images = [synth_image(rng) for _ in range(n_images)]
    per = -(-n_images // n_proc)
    shards = []
    for p in range(n_proc):
        idx = [p * per + j for j in range(per)]
        imgs = [images[i % n_images] for i in idx]
        det = {k: np.stack([im[f"det_{k}"] for im in imgs])
               for k in ("boxes", "scores", "labels", "valid")}
        gt = {k: np.stack([im[f"gt_{k}"] for im in imgs])
              for k in ("boxes", "labels", "valid")}
        shards.append(pack_shard([i % n_images for i in idx], det, gt,
                                 np.asarray([i < n_images for i in idx])))
    return images, shards


CLI = ["train.device=cpu", "model.name=vit_micro_patch4_56",
       "data.image_size=16", "data.channels=3", "data.n_train=16",
       "data.global_batch=8", "train.epochs=1", "model.precision=f32",
       "train.weight_update=zero1", "train.grad_comm=int8"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, vit_params, resnet_vars):
    """One spawn of two gloo ranks runs every step, checkpoint, feed,
    evaluation and CLI scenario (tests/torch_ranks.py:steps)."""
    d = tmp_path_factory.mktemp("ranks")
    feed = {"image": np.arange(40 * 3, dtype=np.float32).reshape(40, 3),
            "label": np.arange(40, dtype=np.int64)}
    payload = {"vit": from_flax_params(vit_params),
               "batches": _batches(STEPS, 8, seed=3),
               "resnet": from_flax_params(resnet_vars, like=TMODELS.build(
                   "resnet18", num_classes=10, dtype=torch.float32)),
               "resnet_batches": _batches(2, 8, seed=4),
               "feed": feed, "shards": _shards()[1], "cli": CLI}
    out = run_ranks("steps", 2, d, payload)
    return {"out": out, "dir": d, "payload": payload}


@pytest.fixture(scope="module")
def coll_inputs():
    g = np.random.default_rng(0)
    return {"ints": g.integers(-7, 8, (4, 96)).astype(np.float32),
            "ints2": g.integers(-3, 4, (4, 5, 7)).astype(np.float32),
            "rs_ints": g.integers(-5, 6, (4, 8, 5)).astype(np.float32),
            "gauss_a": g.normal(size=(4, 4096)).astype(np.float32),
            "gauss_b": g.normal(size=(4, 33, 7)).astype(np.float32),
            "gauss_rs": g.normal(size=(4, 8, 33)).astype(np.float32)}


@pytest.fixture(scope="module")
def coll_ranks(tmp_path_factory, coll_inputs):
    return run_ranks("collectives", 4, tmp_path_factory.mktemp("coll"),
                     coll_inputs)


# ------------------------------------------------------- mesh and layout
@pytest.mark.parametrize("cfg,n", [
    (dict(), 8), (dict(data=2, fsdp=4), 8), (dict(data=-1, fsdp=2), 8),
    (dict(data=-1, model=2), 4), (dict(data=1, fsdp=-1), 2),
    (dict(data=-1, fsdp=3), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(data=2, fsdp=2), 8)])
def test_build_mesh_matches_jax(cfg, n):
    """Shapes, and the same errors (-1 inference, divisibility, count)."""
    try:
        want = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(**cfg),
                                    devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            tmesh.build_mesh(tmesh.MeshConfig(**cfg), n, 0, device="cpu")
        return
    for r in range(n):
        got = tmesh.build_mesh(tmesh.MeshConfig(**cfg), n, r, device="cpu")
        assert got.shape == dict(want.shape)
        assert tmesh.mesh_shape_str(got) == jmesh_mod.mesh_shape_str(want)
        # rank r sits where JAX's device r sits
        pos = np.argwhere(want.devices == jax.devices()[r])[0]
        assert tuple(got.coords.values()) == tuple(int(p) for p in pos)
    assert tmesh.global_batch_from_per_device(4, got) == \
        jmesh_mod.global_batch_from_per_device(4, want)


@pytest.mark.parametrize("model", ["vit", "resnet18"])
@pytest.mark.parametrize("layout", ["none", "fsdp", "zero1"])
def test_rank_slices_hold_jax_shards(model, layout, vit_params,
                                     resnet_vars):
    """dp = 8: rank r's slice of every converted leaf equals
    ``from_flax_params`` of JAX's shard on device r (params under no rules
    and FSDP_RULES); under ZeRO-1 the same leaves split and a rank holds
    the same bytes as a JAX device."""
    if model == "vit":
        jparams = seeded_tree(jax.eval_shape(
            functools.partial(_jvit(num_classes=16).init, train=False),
            jax.random.key(0), jnp.zeros((1, 16, 16, 3))), seed=6)["params"]
        jparams = jax.tree.map(jnp.asarray, jparams)
        tmodel = tvit.VisionTransformer(**{**TINY_VIT, "num_classes": 16},
                                        dtype=torch.float32)
    else:
        jparams = jax.tree.map(jnp.asarray, resnet_vars["params"])
        tmodel = TMODELS.build("resnet18", num_classes=16,
                               dtype=torch.float32)
        jparams = dict(jparams)
        jparams["fc"] = {"kernel": jnp.zeros((512, 16)),
                         "bias": jnp.zeros((16,))}
    full = from_flax_params(jax.tree.map(np.asarray, jparams), like=tmodel)
    devs = jax.devices()[:8]
    fsdp = layout == "fsdp"
    cfg = dict(data=1, fsdp=8) if fsdp else dict(data=-1)
    jm = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(**cfg), devices=devs)
    rules = jsharding.FSDP_RULES if fsdp else None
    if layout == "zero1":
        jsh = jsharding.zero1_shardings(jparams, jm)
    else:
        jsh = jsharding.shard_params_tree(jparams, jm, rules)
    placed = jax.device_put(jparams, jsh)
    jbytes = jsharding.tree_bytes_per_device(placed)
    jsplit = set(jsharding.shard_layout_summary(placed)["specs"])
    for r in range(8):
        tm = tmesh.build_mesh(tmesh.MeshConfig(**cfg), 8, r, device="cpu")
        if layout == "zero1":
            tsh = tsharding.zero1_shardings(full, tm)
        else:
            tsh = tsharding.shard_params_tree(
                full, tm, tsharding.FSDP_RULES if fsdp else None)
        local = {n: tsharding.local_slice(t, tsh[n])
                 for n, t in full.items()}
        assert tsharding.tree_bytes_per_device(local) == jbytes
        if layout == "zero1":
            got = {tflax for tflax in (
                f"{n}" for n, s in tsh.items() if not s.is_fully_replicated)}
            assert len(got) == len(jsplit)
            continue
        shard = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devs[r])), placed)
        want = from_flax_params(shard, like={
            n: t for n, t in local.items()})
        for n, t in local.items():
            np.testing.assert_array_equal(t.numpy(), want[n].numpy(),
                                          err_msg=f"rank {r} {n}")


def test_zero1_partition_spec_and_summary_equal_jax():
    for shape, dp in (((16, 24), 8), ((10, 16), 8), ((10,), 8), ((4,), 8),
                      ((), 8), ((512, 512), 1), ((3, 64, 7, 7), 8)):
        assert tuple(tsharding.zero1_partition_spec(shape, dp)) == \
            tuple(jsharding.zero1_partition_spec(shape, dp))
    m = tmesh.build_mesh(tmesh.MeshConfig(), 8, 3, device="cpu")
    sh = {"w": tsharding.NamedSharding(m, tsharding.P(None, AXES)),
          "b": tsharding.replicated(m)}
    assert tsharding.shard_layout_summary({"mu": sh}) == {
        "specs": {"mu/w": str((None, AXES))}, "leaves": 2,
        "replicated": 1, "sharded": 1}
    assert tsharding.host_local_slice(64) == (0, 64)


# ------------------------------------------------------------ collectives
def _jax_collective(fn, x, n, out_spec=JP()):
    mesh = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=-1),
                                devices=jax.devices()[:n])
    f = jax.jit(shard_map(lambda v: fn(v[0]), mesh=mesh, in_specs=(JP(AXES),),
                          out_specs=out_spec, check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


def test_quantized_collectives_bit_equal_on_small_ints(coll_ranks,
                                                       coll_inputs):
    """4 ranks vs ``shard_map`` over 4 devices: psum, reduce-scatter and
    the tree form are bitwise JAX's on small integers."""
    x = coll_inputs
    psum = _jax_collective(lambda v: j_qpsum(v, AXES, block=16),
                           x["ints"], 4)
    rs = _jax_collective(lambda v: j_qrs(v, AXES, block=16),
                         x["rs_ints"], 4, JP(AXES))
    tree_b = _jax_collective(lambda v: j_qpsum(v, AXES, block=16),
                             x["ints2"], 4)
    for r, out in enumerate(coll_ranks):
        np.testing.assert_array_equal(out["psum_ints"], psum)
        np.testing.assert_array_equal(out["psum_ints"],
                                      x["ints"].sum(0))
        np.testing.assert_array_equal(out["rs_ints"], rs[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["tree_ints"]["a"], psum)
        np.testing.assert_array_equal(out["tree_ints"]["b"], tree_b)


def test_quantized_collectives_gaussian_within_2ulp(coll_ranks,
                                                    coll_inputs):
    x = coll_inputs
    want = {"psum_gauss": _jax_collective(lambda v: j_qpsum(v, AXES),
                                          x["gauss_a"], 4),
            "b": _jax_collective(lambda v: j_qpsum(v, AXES),
                                 x["gauss_b"], 4),
            "rs": _jax_collective(lambda v: j_qrs(v, AXES), x["gauss_rs"],
                                  4, JP(AXES))}
    for r, out in enumerate(coll_ranks):
        pairs = [(out["psum_gauss"], want["psum_gauss"], x["gauss_a"]),
                 (out["tree_gauss"]["a"], want["psum_gauss"], x["gauss_a"]),
                 (out["tree_gauss"]["b"], want["b"], x["gauss_b"]),
                 (out["rs_gauss"], want["rs"][2 * r:2 * r + 2],
                  x["gauss_rs"][:, 2 * r:2 * r + 2])]
        for got, ref, inp in pairs:
            ulp = np.spacing(np.abs(inp.sum(0)).max().astype(np.float32))
            assert np.abs(got - ref).max() <= 2 * ulp
            # and the EQuARX bound against the exact sum
            rel = np.abs(got - inp.sum(0)).max() / np.abs(inp.sum(0)).max()
            assert rel < 0.05


def test_psum_pmean_subgroups_and_host_collectives(coll_ranks, coll_inputs):
    """``psum_tree`` / ``pmean_tree`` exact on small integers; psum over
    the fsdp and data subgroups of a data=2 x fsdp=2 mesh equals JAX's
    over those axes; host gather, broadcast and the counters."""
    x = coll_inputs["ints"]
    jm = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=2, fsdp=2),
                              devices=jax.devices()[:4])
    by_axis = {}
    for axis, out_axis in (("fsdp", "data"), ("data", "fsdp")):
        f = jax.jit(shard_map(
            lambda v, a=axis: j_qpsum(v[0], a, block=16)[None],
            mesh=jm, in_specs=(JP(AXES),), out_specs=JP(out_axis),
            check_vma=False))
        by_axis[axis] = np.asarray(f(jnp.asarray(x)))
    for r, out in enumerate(coll_ranks):
        data, fsdp, idx = out["coords"]
        assert (data, fsdp, idx) == (r // 2, r % 2, r)
        np.testing.assert_array_equal(out["fsdp_ints"],
                                      by_axis["fsdp"][data])
        np.testing.assert_array_equal(out["data_ints"],
                                      by_axis["data"][fsdp])
        np.testing.assert_array_equal(out["psum_tree"]["a"], x.sum(0))
        np.testing.assert_array_equal(out["pmean_tree"]["a"],
                                      x.sum(0) / 4)
        np.testing.assert_allclose(out["psum_tree"]["b"],
                                   coll_inputs["gauss_b"].sum(0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(out["allgather"]["r"],
                                      [[0, 7], [1, 7], [2, 7], [3, 7]])
        assert out["broadcast"] == {"rank": 0}
        # one packed pass a call: 2 all_to_all, plus 2 all_gather a psum
        assert out["counts"]["all_to_all"] == 2 * 8
        assert out["counts"]["all_gather"] == 2 * 6 + 1


# ------------------------------------------------------------ mesh steps
def _jax_mesh_run(vit_params, batches, fsdp, wu, comm, rules):
    mesh = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=2 // fsdp,
                                                     fsdp=fsdp),
                                devices=jax.devices()[:2])
    model = _jvit()
    params = jax.tree.map(jnp.asarray, vit_params)
    tx = joptim.build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                                weight_decay=SGD["weight_decay"],
                                clip_grad_norm=SGD["clip"], params=params)
    st = JTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    st = j_shard_state(st, mesh, rules, zero1=wu == "zero1")
    step = j_make_train_step(jcls.make_loss_fn(), mesh=mesh,
                             weight_update=wu, grad_comm=comm, rules=rules,
                             donate=False)
    losses = []
    for b in batches:
        b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                           jsharding.batch_sharding(mesh))
        st, m = step(st, b, jax.random.key(0))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, st.params)


@pytest.mark.parametrize("mode", [m for m in MODES if m[3] == "fp32"],
                         ids=lambda m: m[0])
def test_mesh_step_matches_jax(mode, ranks, vit_params):
    name, fsdp, wu, comm, fsdp_rules = mode
    rules = jsharding.FSDP_RULES if fsdp_rules else None
    losses, params = _jax_mesh_run(vit_params, ranks["payload"]["batches"],
                                   fsdp, wu, comm, rules)
    want = from_flax_params(params)
    for r, out in enumerate(ranks["out"]):
        got = out["vit"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    local = ranks["out"][0]["vit"][name]["local_params"]
    if fsdp_rules:      # FSDP keeps half of every kernel on a rank
        assert local["blocks.0.attn.qkv.weight"] == (96, 64)
        assert local["blocks.0.attn.proj.weight"] == (64, 32)
        assert local["patch_embed.proj.weight"] == (32, 48)
    else:
        assert local["blocks.0.attn.qkv.weight"] == (192, 64)
    # every rank reports the same averaged loss
    assert ranks["out"][0]["vit"][name]["losses"] == \
        ranks["out"][1]["vit"][name]["losses"]


@pytest.mark.parametrize("mode", [m for m in MODES if m[3] == "int8"],
                         ids=lambda m: m[0])
def test_int8_step_matches_jax(mode, ranks, vit_params):
    name, fsdp, wu, comm, _ = mode
    losses, _ = _jax_mesh_run(vit_params, ranks["payload"]["batches"],
                              fsdp, wu, comm, None)
    outs = [o["vit"][name] for o in ranks["out"]]
    np.testing.assert_allclose(outs[0]["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-3)
    rec = [o["int8"] for o in outs]
    mesh = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=-1),
                                devices=jax.devices()[:2])
    one_d = {True: [], False: []}
    for i, scatter in enumerate(rec[0]["scatter"]):
        local = np.stack([rc["local"][i] for rc in rec])
        mean = local.sum(0) / 2
        bound = 2 / 127 * np.abs(local).max()
        for r, rc in enumerate(rec):
            ref = mean[r * len(mean) // 2:(r + 1) * len(mean) // 2] \
                if scatter else mean
            # the packed reduction returns the SUM; the step divides by n
            assert np.abs(rc["reduced"][i] / 2 - ref).max() <= bound
        if local.ndim == 2:       # 1-D leaves: JAX's own layout
            one_d[bool(scatter)].append(i)
    for scatter, idx in one_d.items():
        if not idx:
            continue
        fn = j_qrs if scatter else j_qpsum
        spec = JP(AXES) if scatter else JP()
        f = jax.jit(shard_map(
            lambda t: [fn(v[0], AXES) / 2 for v in t], mesh=mesh,
            in_specs=([JP(AXES)] * len(idx),), out_specs=[spec] * len(idx),
            check_vma=False))
        want = f([jnp.asarray(np.stack([rc["local"][i] for rc in rec]))
                  for i in idx])
        for i, w in zip(idx, want):
            w = np.asarray(w)
            for r, rc in enumerate(rec):
                part = (w[r * len(w) // 2:(r + 1) * len(w) // 2]
                        if scatter else w)
                np.testing.assert_array_equal(rc["reduced"][i] / 2, part)
    assert len(one_d[True] + one_d[False]) >= 10
    assert any(rec[0]["scatter"]) == (wu == "zero1")
    assert outs[0]["counts"]["all_to_all"] == 2 * STEPS


def test_zero1_moment_bytes_and_eval(ranks, vit_params):
    """AdamW's moments under ZeRO-1 at dp = 2: a rank holds the bytes a
    JAX device holds (the same leaves split), which are replicated / 2
    plus the tail no dim of which 2 divides; the mesh eval step sums both
    ranks' halves of the batch."""
    out = ranks["out"][0]["vit"]
    rep, z = out["adam_bytes_False"], out["adam_bytes_True"]
    assert out["adam_layout_False"]["sharded"] == 0
    assert out["adam_layout_True"]["replicated"] > 0
    shapes = [t.shape for t in ranks["payload"]["vit"].values()]
    tail = sum(2 * 4 * int(np.prod(sh)) for sh in shapes
               if not any(d >= 2 and d % 2 == 0 for d in sh))
    assert rep == sum(2 * 4 * int(np.prod(sh)) for sh in shapes)
    assert z == (rep - tail) // 2 + tail and z < 0.55 * rep
    mesh = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=-1),
                                devices=jax.devices()[:2])
    params = jax.tree.map(jnp.asarray, vit_params)
    tx = joptim.build_optimizer("adamw", 1e-3, params=params)
    st = j_shard_state(JTrainState.create(apply_fn=_jvit().apply,
                                          params=params, tx=tx),
                       mesh, zero1=True)
    adam = st.opt_state[0]
    assert jsharding.tree_bytes_per_device((adam.mu, adam.nu)) == z
    for name in ("replicated", "zero1", "fsdp"):
        ev = out[name]["eval"]
        assert ev == ranks["out"][1]["vit"][name]["eval"]
        assert ev["count"] == 8
    assert out["zero1"]["moment_layout"]["sharded"] > 0
    assert out["replicated"]["moment_layout"]["sharded"] == 0


def test_batchnorm_step_matches_jax(ranks, resnet_vars):
    """resnet18 on 2 ranks: the BatchNorms normalise with the global
    batch's moments, as GSPMD's do."""
    mesh = jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=-1),
                                devices=jax.devices()[:2])
    jmodel = JMODELS.build("resnet18", num_classes=10, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, resnet_vars["params"])
    tx = joptim.build_optimizer("sgd", RESNET_LR, momentum=0.9,
                                params=params)
    st = JTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                            batch_stats=jax.tree.map(
                                jnp.asarray, resnet_vars["batch_stats"]))
    st = j_shard_state(st, mesh)
    step = j_make_train_step(jcls.make_loss_fn(has_batch_stats=True),
                             mesh=mesh, donate=False)
    losses = []
    for b in ranks["payload"]["resnet_batches"]:
        b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                           jsharding.batch_sharding(mesh))
        st, m = step(st, b, jax.random.key(0))
        losses.append(float(m["loss"]))
    model = TMODELS.build("resnet18", num_classes=10, dtype=torch.float32)
    want = from_flax_params({"params": jax.tree.map(np.asarray, st.params),
                             "batch_stats": jax.tree.map(
                                 np.asarray, st.batch_stats)}, like=model)
    for out in ranks["out"]:
        got = out["resnet"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in {**got["params"], **got["buffers"]}.items():
            np.testing.assert_allclose(v, want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_step_arguments_as_jax():
    loss_fn = tcls.make_loss_fn()
    m = tmesh.build_mesh(tmesh.MeshConfig(), 1, 0, device="cpu")
    for kw in (dict(weight_update="zero1"), dict(grad_comm="int8")):
        with pytest.raises(ValueError, match="need a mesh"):
            make_train_step(loss_fn, device="cpu", **kw)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(loss_fn, mesh=m, grad_comm="int8", accum_steps=2)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_train_step(loss_fn, mesh=m, grad_comm="int8",
                        rules=tsharding.FSDP_RULES)
    # tensor parallelism (item 7c): the rules and a model axis build steps
    make_train_step(loss_fn, mesh=m, rules=tsharding.TRANSFORMER_TP_RULES)
    tp = tmesh.build_mesh(tmesh.MeshConfig(data=1, model=2), 2, 0,
                          device="cpu")
    for kw in (dict(), dict(weight_update="zero1",
                            rules=tsharding.TRANSFORMER_TP_RULES)):
        make_train_step(loss_fn, mesh=tp, **kw)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_train_step(loss_fn, mesh=tp, grad_comm="int8",
                        rules=tsharding.TRANSFORMER_TP_RULES)
    # expert parallelism (item 8a): an expert axis and MOE_RULES build
    # steps; the int8 collectives replicate every parameter and refuse it
    from deeplearning_tpu_torch.parallel.moe import MOE_RULES
    ep = tmesh.build_mesh(tmesh.MeshConfig(data=1, expert=2), 2, 0,
                          device="cpu")
    make_train_step(loss_fn, mesh=ep, rules=MOE_RULES)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_train_step(loss_fn, mesh=ep, grad_comm="int8")
    seq = tmesh.build_mesh(tmesh.MeshConfig(data=1, seq=2), 2, 0,
                           device="cpu")
    make_train_step(loss_fn, mesh=seq)       # sequence parallelism runs
    for kw in (dict(weight_update="zero1"), dict(grad_comm="int8")):
        with pytest.raises(ValueError, match="data-parallel modes"):
            make_train_step(loss_fn, mesh=seq, **kw)
    for kw in (dict(weight_update="zero2"), dict(grad_comm="bf16")):
        with pytest.raises(ValueError):
            make_train_step(loss_fn, mesh=m, **kw)


def test_one_rank_mesh_step_equals_the_plain_step(vit_params):
    """A world of one (gloo, in this process): the replicated and ZeRO-1
    mesh steps leave params and moments bit-equal to the step without a
    mesh; TP rules are placed by shard_state all the same."""
    import torch.distributed as dist
    started = tmesh.initialize_distributed(device="cpu")
    try:
        sd = from_flax_params(vit_params)
        batch = {k: torch.from_numpy(v) for k, v in
                 _batches(1, 4, seed=5)[0].items()}

        def fresh():
            model = tvit.VisionTransformer(**TINY_VIT, dtype=torch.float32)
            model.load_state_dict(sd)
            return TrainState.create(model=model, tx=build_optimizer(
                "adamw", 1e-3, params=dict(model.named_parameters())))
        plain = fresh()
        make_train_step(tcls.make_loss_fn(), device="cpu")(plain, batch, 0)
        mesh = tmesh.build_mesh(device="cpu")
        for wu in ("replicated", "zero1"):
            st = shard_state(fresh(), mesh, zero1=wu == "zero1")
            make_train_step(tcls.make_loss_fn(), mesh=mesh,
                            weight_update=wu)(st, batch, 0)
            for a, b in zip(st.state_dict()["params"].values(),
                            plain.state_dict()["params"].values()):
                assert torch.equal(a, b)
            mu = st.opt_state[0]["mu"]
            assert all(torch.equal(mu[k], plain.opt_state[0]["mu"][k])
                       for k in mu)
        tp = shard_state(fresh(), tmesh.build_mesh(device="cpu"),
                         tsharding.TRANSFORMER_TP_RULES)
        assert tsharding.shard_layout_summary(tp.sharding.params)[
            "sharded"] == 0          # one rank: nothing to split
    finally:
        if started:
            dist.destroy_process_group()


# ----------------------------------------------- checkpoints and the rest
def test_zero1_checkpoint_restores_across_topologies(ranks):
    """Saved by 2 ZeRO-1 ranks (rank 0 wrote the gathered tensors): the
    ranks restored their own slices; here one process restores it plain
    and onto a replicated one-rank mesh, moments bit-equal, and the
    sidecar says the topology changed."""
    out = [o["ckpt"] for o in ranks["out"]]
    assert all(o["same_local"] and o["step"] == 1 for o in out)
    side = out[0]["sidecar"]
    assert side["weight_update"] == "zero1"
    assert side["process_count"] == side["device_count"] == 2
    assert side["mesh_shape"]["data"] == 2 and side["platform"] == "cpu"
    assert side["shard_layout"]["sharded"] > 0
    assert not out[0]["changed_vs_self"]
    payload = ranks["payload"]
    ckpt = CheckpointManager(os.path.join(ranks["dir"], "ckpt"))

    def fresh():
        model = tvit.VisionTransformer(**TINY_VIT, dtype=torch.float32)
        model.load_state_dict(payload["vit"])
        return TrainState.create(model=model, tx=build_optimizer(
            "adamw", 1e-3, params=dict(model.named_parameters())))

    from torch_ranks import _leaves
    plain, step = ckpt.restore_verified(fresh())
    mesh = tmesh.build_mesh(tmesh.MeshConfig(), 1, 0, device="cpu")
    placed, step2 = elastic_restore(ckpt, fresh(), mesh)
    assert step == step2 == 1
    for st in (plain, placed):
        got = [t.numpy() for t in _leaves(st.opt_state)]
        assert len(got) == len(out[0]["moments"])
        for a, b in zip(got, out[0]["moments"]):
            np.testing.assert_array_equal(a, b)
        for k, p in st.params.items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          out[0]["params"][k])
    from deeplearning_tpu_torch.elastic.topology import current_topology
    assert topology_changed(side, current_topology(mesh))


def test_agree_preempt_step_two_ranks(ranks):
    assert [o["feed"]["preempt"] for o in ranks["out"]] == [5, 5]


def test_loader_rank_slices_concatenate_to_the_batch(ranks):
    feed = ranks["payload"]["feed"]
    loader = DataLoader(ArraySource(**feed), global_batch=8, seed=3)
    loader.set_epoch(1)
    single = list(loader)
    outs = [o["feed"] for o in ranks["out"]]
    assert [o["host_batch"] for o in outs] == [4, 4]
    assert len(outs[0]["batches"]) == len(single) == 5
    for i, b in enumerate(single):
        for k in b:
            np.testing.assert_array_equal(
                np.concatenate([o["batches"][i][k] for o in outs]),
                np.asarray(b[k]))


def _single_process_coco(images):
    ev = CocoEvaluator(num_classes=NUM_CLASSES, use_cpp=False)
    for i, im in enumerate(images):
        ev.add_image(i, gt_boxes=im["gt_boxes"][im["gt_valid"]],
                     gt_labels=im["gt_labels"][im["gt_valid"]],
                     det_boxes=im["det_boxes"][im["det_valid"]],
                     det_scores=im["det_scores"][im["det_valid"]],
                     det_labels=im["det_labels"][im["det_valid"]])
    return ev.summarize()


@pytest.mark.parametrize("n_images,n_proc", [(8, 2), (9, 4)])
def test_gather_and_evaluate_stacked_equals_single_process(n_images,
                                                            n_proc):
    images, shards = _shards(n_images, n_proc)
    baseline = _single_process_coco(images)

    def fake_allgather(local):
        return {k: np.stack([s[k] for s in shards]) for k in local}

    result = gather_and_evaluate(shards[0], NUM_CLASSES,
                                 allgather=fake_allgather, use_cpp=False)
    for k, v in baseline.items():
        assert result[k] == pytest.approx(v, abs=1e-9), k


def test_gather_and_evaluate_on_two_ranks(ranks):
    baseline = _single_process_coco(_shards()[0])
    for out in ranks["out"]:
        for k, v in baseline.items():
            assert out["feed"]["coco"][k] == pytest.approx(v, abs=1e-9), k


def test_cli_trains_zero1_int8_on_two_ranks(ranks):
    for out in ranks["out"]:
        assert out["cli"]["rc"] == 0
    side = ranks["out"][0]["cli"]["sidecar"]
    (step, doc), = side.items()
    assert int(step) == 2 and doc["weight_update"] == "zero1"
    assert doc["process_count"] == 2 and doc["mesh_str"] == "data=2"
    with open(os.path.join(ranks["dir"], "cli", "ckpt", "checksums.json")
              ) as f:
        assert list(json.load(f)) == ["2"]


def test_topology_functions_match_jax():
    """``topology_str`` and ``topology_changed`` give JAX's answers on
    JAX's fields; the port's also reports a change of the recorded
    weight-update mode (ROADMAP "Differences from JAX that stay")."""
    from deeplearning_tpu.elastic import topology as jtopo
    from deeplearning_tpu_torch.elastic import topology as ttopo
    base = {"device_count": 2, "process_count": 2, "platform": "cpu",
            "mesh_shape": {"data": 2, "fsdp": 1}, "mesh_str": "data=2"}
    cases = [None, {}, base, {**base, "device_count": 4},
             {**base, "mesh_shape": {"data": 1, "fsdp": 2}},
             {**base, "weight_update": "replicated"}]
    for saved in cases:
        for cur in (base, {**base, "process_count": 1}):
            assert ttopo.topology_changed(saved, cur) == \
                jtopo.topology_changed(saved, cur)
        assert ttopo.topology_str(saved) == jtopo.topology_str(saved)
    z1 = {**base, "weight_update": "zero1"}
    assert ttopo.topology_changed(z1, {**base, "weight_update":
                                       "replicated"})
    assert not jtopo.topology_changed(z1, {**base, "weight_update":
                                           "replicated"})
    doc = ttopo.current_topology(tmesh.build_mesh(tmesh.MeshConfig(), 1, 0,
                                                  device="cpu"))
    assert doc == {"device_count": 1, "process_count": 1,
                   "platform": "cpu", "mesh_shape": {
                       "data": 1, "fsdp": 1, "seq": 1, "model": 1,
                       "expert": 1}, "mesh_str": "1"}
