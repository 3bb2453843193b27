"""The port's sequence and pipeline parallelism (deeplearning_tpu_torch/
parallel/{collectives ppermute and all_to_all_tiled, _seq_adapter,
ring_attention, ulysses, pipeline, pipeline_train}, the seq-parallel mesh
step, the loader's data x fsdp slices and the train CLI's options) vs the
JAX package, on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py (its flash
kernels in interpret mode); the port runs on gloo ranks spawned by
tests/torch_ranks.py (scenario ``seq_pipe``, one spawn at 2 ranks and one
at 4, one torch thread each), where K1's wrappers take their plain
versions because the tensors lie on the CPU. The same seeded numpy inputs
go to both sides. Tolerances:

- ring (plain and flash) and Ulysses (default and flash inner) on each
  rank's chunks, and the attn_fn adapters on replicated (B, N, H, D)
  inputs (N = 13 padded on the plain paths, 16 on the flash paths):
  forward and the gradients of sum(out²) within 2e-5 (rtol and atol) of
  JAX's at seq = 2 and 4; every rank holds the whole adapter gradient
  (no sum over the seq ranks);
- one SGD step of a 10-token ViT with each adapter, flash and plain, at
  data 1 x seq 2 and data 2 x seq 2: loss rtol 1e-5, params within 1e-5
  of JAX's mesh step;
- ``pipeline_apply`` at (S, M) = (2, 2), (2, 4), (4, 4) and the
  heterogeneous path: outputs and gradients within 2e-5 of JAX's;
  ``pack_stages`` exactly JAX's;
- the pipelined ViT at S = 2 and 4 (M = 4): loss rtol 1e-5, gradients of
  the embedding, the head and this rank's stage within 5e-5; two steps
  of the pipeline train step with SGD and momentum: losses rtol 1e-5,
  params within 1e-5 of JAX's ``make_pipeline_train_step`` (with Adam
  the key bias, whose gradient is zero in exact arithmetic, would move
  by a full step of either sign on round-off);
- the loader's slices and the CLI's checks: exact.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.ops.pallas.flash_attention import (
    flash_attention as j_flash_attention)
from deeplearning_tpu.parallel import mesh as jmesh_mod
from deeplearning_tpu.parallel import pipeline as jpipe
from deeplearning_tpu.parallel import pipeline_train as jpt
from deeplearning_tpu.parallel.ring_attention import (
    make_ring_attention as j_ring, make_ring_attn_fn as j_ring_fn)
from deeplearning_tpu.parallel.sharding import batch_sharding
from deeplearning_tpu.parallel.ulysses import (
    make_ulysses_attention as j_ulysses, make_ulysses_attn_fn as j_uly_fn)
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu.train import optim as joptim
from deeplearning_tpu.train.steps import shard_state as j_shard_state
from deeplearning_tpu_torch.data.loader import ArraySource, DataLoader
from deeplearning_tpu_torch.parallel import pipeline as tpipe
from deeplearning_tpu_torch.train import __main__ as cli
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_ranks import PP_LR, PP_VIT, SGD, SP_CLI, SP_VIT, run_ranks
from torch_threads import one_torch_thread  # noqa: F401

JP = jax.sharding.PartitionSpec
ODD_N = 13
CLI_RUNS = [
    ("ring", ["train.mesh_seq_axis=2", "train.seq_parallel=ring"]),
    ("ring_naive", ["train.mesh_seq_axis=2", "model.attn=naive",
                    "data.image_size=16"]),
    ("ulysses", ["train.mesh_seq_axis=2", "train.seq_parallel=ulysses"]),
    ("pipeline", ["train.pipeline_stages=2", "train.microbatches=4",
                  "optim.name=adam", "optim.lr=0.003"])]
PP_MICRO = {2: [2, 4], 4: [4]}


def _f32(g, *shape, scale=1.0):
    return (g.normal(size=shape) * scale).astype(np.float32)


def _jmesh(n, **axes):
    return jmesh_mod.build_mesh(jmesh_mod.MeshConfig(**axes),
                                devices=jax.devices()[:n])


def _params(model, shape, seed):
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros(shape))
    return seeded_tree(shapes, seed=seed)["params"]


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(0)
    sp_vit = _params(jvit.VisionTransformer(**SP_VIT, dtype=jnp.float32),
                     (1, 12, 12, 3), 1)
    pp_vit = _params(jvit.VisionTransformer(**PP_VIT, dtype=jnp.float32),
                     (1, 16, 16, 3), 2)
    pp_images = _f32(g, 8, 16, 16, 3, scale=0.1)
    pp_labels = g.integers(0, 3, 8)
    pp_images[np.arange(8), pp_labels, pp_labels, 0] += 3.0
    common = {
        "bnhd": _f32(g, 3, 2, 16, 4, 16), "odd_n": ODD_N,
        "sp_flax": sp_vit, "sp_vit": from_flax_params(sp_vit),
        "sp_batch": {"image": _f32(g, 8, 12, 12, 3),
                     "label": g.integers(0, 10, 8)},
        "pp_micro": PP_MICRO,
        "het": {"params": [{"w1": _f32(g, 6, 3, scale=.5),
                            "w2": _f32(g, 3, 6, scale=.5)},
                           {"w": _f32(g, 6, 6, scale=.5),
                            "b": _f32(g, 6, scale=.1)}],
                "x": _f32(g, 4, 2, 6)},
        "pp_flax": pp_vit, "pp_vit": from_flax_params(pp_vit),
        "pp_batch": {"image": pp_images, "label": pp_labels},
        "feed": {"image": np.arange(40 * 3, dtype=np.float32).reshape(40, 3),
                 "label": np.arange(40, dtype=np.int64)},
        "cli_runs": CLI_RUNS}
    out = {}
    for n in (2, 4):
        p = dict(common, qkv=_f32(g, 3, 2, 4, 8 * n, 16))
        for m in PP_MICRO[n]:
            p[f"pp_{n}_{m}"] = {"params": {"w": _f32(g, n, 8, 8, scale=.5),
                                           "b": _f32(g, n, 8, scale=.1)},
                                "x": _f32(g, m, 4, 8)}
        out[n] = p
    return out


class _Spawned:
    """The ranks' results by rank count, waited for on first use."""

    def __init__(self, runs):
        self._runs = runs

    def __getitem__(self, n):
        return self._runs[n].result()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, inputs):
    """One spawn a rank count (tests/torch_ranks.py:seq_pipe), the two at
    once and from the module's start: the tests that need no rank (the
    first ones) run while the ranks do."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        yield _Spawned({n: pool.submit(
            run_ranks, "seq_pipe", n, tmp_path_factory.mktemp(f"sp{n}"),
            {k: v for k, v in inputs[n].items() if not k.endswith("_flax")})
            for n in (2, 4)})


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _sum_sq_grads(fn, *xs):
    """JAX's fn(*xs) and the gradients of sum(fn(*xs) ** 2)."""
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out.astype(jnp.float32) ** 2), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(xs))), has_aux=True))(*xs)
    return np.asarray(out), [np.asarray(x) for x in grads]


# ------------------------- without ranks (run while the ranks start)
def test_pack_stages_equals_jax():
    g = np.random.default_rng(3)
    stages = [{"a": _f32(g, 3, 2), "b": _f32(g, 4)},
              {"w": _f32(g, 5, 5)},
              {"x": {"y": _f32(g, 2)}, "z": _f32(g, 1, 3)}]
    jpacked, junpack = jpipe.pack_stages(jax.tree.map(jnp.asarray, stages))
    tstages = [{k: (torch.from_numpy(v) if not isinstance(v, dict) else
                    {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                for k, v in st.items()} for st in stages]
    packed, unpack = tpipe.pack_stages(tstages)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    for i, st in enumerate(tstages):
        back = unpack[i](packed[i])
        want = junpack[i](jpacked[i])
        for k in st:
            if isinstance(st[k], dict):
                for kk in st[k]:
                    np.testing.assert_array_equal(back[k][kk].numpy(),
                                                  np.asarray(want[k][kk]))
            else:
                np.testing.assert_array_equal(back[k].numpy(),
                                              np.asarray(want[k]))
    stacked = tpipe.stack_stage_params([{"w": torch.ones(2)},
                                        {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)
    with pytest.raises(TypeError, match="float leaves"):
        tpipe.pack_stages([{"i": torch.zeros(3, dtype=torch.int32)}])
    with pytest.raises(TypeError, match="float leaves"):
        jpipe.pack_stages([{"i": jnp.zeros(3, jnp.int32)}])


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli_sp", os.path.join(os.path.dirname(__file__), "..",
                                         "tools", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


JAX_ERRORS = [
    ["train.pipeline_stages=2", "train.mesh_seq_axis=2"],
    ["train.pipeline_stages=2", "train.ema=true"],
    ["train.pipeline_stages=2", "train.accum_steps=2"],
    ["train.weight_update=zero1", "train.mesh_seq_axis=2"],
    ["train.grad_comm=int8", "train.pipeline_stages=2"],
    ["train.seq_parallel=nope", "train.mesh_seq_axis=2"],
    ["train.pipeline_stages=2", "train.microbatches=3"],
    ["train.pipeline_stages=2", "train.microbatches=4",
     "data.global_batch=6", "data.n_train=12"],
    ["train.pipeline_stages=2", "train.mesh_model_axis=2"],
    ["train.weight_update=zero1", "train.mesh_model_axis=2"],
    ["train.grad_comm=int8", "train.mesh_model_axis=2"]]


@pytest.mark.parametrize("opts", JAX_ERRORS,
                         ids=["pp_seq", "pp_ema", "pp_accum", "zero1_seq",
                              "int8_pp", "flavor", "micro_pp", "batch_micro",
                              "pp_model", "zero1_model", "int8_model"])
def test_cli_raises_jax_errors(opts):
    """Each of tools/train.py's ValueErrors, with its message, before any
    process group starts."""
    import torch.distributed as dist
    argv = [a for a in SP_CLI if not a.startswith("train.device")] + opts
    with pytest.raises(ValueError) as want:
        _jax_cli().main(argv)
    with pytest.raises(ValueError) as got:
        cli.main(SP_CLI + opts)
    assert str(got.value) == str(want.value)
    assert not dist.is_initialized()


def test_cli_tensor_parallel_names_item_7c_and_sdpa_is_refused():
    """A model axis (item 7c) runs as tools/train.py builds it: at one
    process, JAX's mesh error from the gloo world the CLI starts and
    destroys; the ring on model.attn=sdpa is refused."""
    import torch.distributed as dist
    with pytest.raises(ValueError,
                       match="1 devices not divisible by fixed axes 2"):
        cli.main(SP_CLI + ["train.mesh_model_axis=2"])
    assert not dist.is_initialized()
    cfg = cli.Config()
    mesh_kw = {"attn_fn": None}
    bad = cli.Config(model=cli.ModelCfg(attn="sdpa"),
                     train=cli.TrainCfg(mesh_seq_axis=2))
    with pytest.raises(ValueError, match="not model.attn=sdpa"):
        cli._seq_attn_fn(bad, None, mesh_kw)
    with pytest.raises(ValueError, match="takes attn_fn"):
        cli._seq_attn_fn(cfg, None, {})


# -------------------------------------------------- ring and Ulysses
@pytest.mark.parametrize("n", [2, 4])
def test_ring_and_ulysses_match_jax(n, ranks, inputs):
    """Each rank's chunk of the output and of dq/dk/dv equals JAX's
    shard_map over n seq devices, for the ring's plain and flash paths and
    Ulysses with the default and the flash inner attention."""
    mesh = _jmesh(n, data=-1, seq=n)
    sh = jax.sharding.NamedSharding(mesh, JP(None, None, "seq", None))
    q, k, v = (jax.device_put(jnp.asarray(x), sh) for x in inputs[n]["qkv"])
    fns = {"ring": j_ring(mesh), "ring_flash": j_ring(mesh, use_flash=True),
           "ulysses": j_ulysses(mesh),
           "ulysses_flash": j_ulysses(mesh, attn_fn=j_flash_attention,
                                      check_vma=False)}
    nl = q.shape[2] // n
    for name, fn in fns.items():
        want, wgrads = _sum_sq_grads(fn, q, k, v)
        for r, out in enumerate(ranks[n]):
            got, grads = out["attention"][name]
            sl = slice(r * nl, (r + 1) * nl)
            _close(got, want[:, :, sl], 2e-5, f"{name} rank {r} out")
            for g_, w_, t in zip(grads, wgrads, "qkv"):
                _close(g_, w_[:, :, sl], 2e-5, f"{name} rank {r} d{t}")


@pytest.mark.parametrize("n", [2, 4])
def test_adapters_match_jax_on_every_rank(n, ranks, inputs):
    """The (B, N, H, D) attn_fn adapters: padded plain paths at N = 13,
    flash paths at N = 16; every seq rank holds the whole output and the
    whole gradient of the replicated inputs, equal to JAX's (a gradient
    summed over the seq ranks would be n times too large)."""
    mesh = _jmesh(n, data=-1, seq=n)
    full = [jnp.asarray(x) for x in inputs[n]["bnhd"]]
    odd = [x[:, :ODD_N] for x in full]
    for name, fn, xs in (
            ("ring_fn", j_ring_fn(mesh), odd),
            ("ulysses_fn", j_uly_fn(mesh), odd),
            ("ring_fn_flash", j_ring_fn(mesh, use_flash=True), full),
            ("ulysses_fn_flash", j_uly_fn(mesh, use_flash=True), full)):
        want, wgrads = _sum_sq_grads(fn, *xs)
        for r, out in enumerate(ranks[n]):
            got, grads = out["attention"][name]
            _close(got, want, 2e-5, f"{name} rank {r}")
            for g_, w_, t in zip(grads, wgrads, "qkv"):
                _close(g_, w_, 2e-5, f"{name} rank {r} d{t}")


@pytest.mark.parametrize("n", [2, 4])
def test_refusals_carry_jax_messages(n, ranks, inputs):
    """Heads that do not divide the axis, valid_len with a custom inner
    attention, a dropped sm_scale, kv_mask on the flash ring, a
    non-dividing N on the flash adapters and attention dropout raise
    JAX's errors with JAX's messages."""
    mesh = _jmesh(n, data=-1, seq=n)
    errs = ranks[n][0]["attention"]["errors"]
    heads = 3 * n // 2 if n > 2 else 3
    x = jax.device_put(jnp.zeros((1, heads, 8 * n, 8)),
                       jax.sharding.NamedSharding(
                           mesh, JP(None, None, "seq", None)))
    with pytest.raises(ValueError) as e:
        j_ulysses(mesh)(x, x, x)
    assert errs["heads"] == f"ValueError: {e.value}"
    odd = [jnp.zeros((2, ODD_N, 4, 16))] * 3
    for key, fn in (("flash_pad", j_ring_fn(mesh, use_flash=True)),
                    ("flash_pad_ulysses", j_uly_fn(mesh, use_flash=True))):
        with pytest.raises(ValueError) as e:
            fn(*odd)
        assert errs[key] == f"ValueError: {e.value}"
    with pytest.raises(NotImplementedError) as e:
        j_ring_fn(mesh)(*odd, dropout_rate=0.1, deterministic=False)
    assert errs["dropout"] == f"NotImplementedError: {e.value}"
    assert errs["valid_len"].startswith("ValueError: valid_len masking is "
                                        "only implemented")
    assert errs["sm_scale"].startswith("ValueError: explicit sm_scale")
    assert errs["ring_mask"].startswith("NotImplementedError: kv_mask needs")
    for out in ranks[n]:
        assert out["attention"]["errors"] == errs


# ---------------------------------------------- the seq-parallel steps
@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_step_matches_jax_mesh_step(n, ranks, inputs):
    """One SGD step at data n/2 x seq 2: the ring (n = 2) or Ulysses
    (n = 4) adapter in JAX's mesh step; every port variant (ring and
    Ulysses, flash and plain) on every rank lands on its params."""
    p = inputs[n]
    mesh = _jmesh(n, data=n // 2, seq=2)
    make = j_ring_fn if n == 2 else j_uly_fn
    model = jvit.VisionTransformer(**SP_VIT, dtype=jnp.float32,
                                   attn_fn=make(mesh))
    params = jax.tree.map(jnp.asarray, p["sp_flax"])
    tx = joptim.build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                                params=params)
    state = j_shard_state(JTrainState.create(apply_fn=model.apply,
                                             params=params, tx=tx), mesh)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in
                            p["sp_batch"].items()}, batch_sharding(mesh))
    state, m = j_make_train_step(jcls.make_loss_fn(), mesh=mesh)(
        state, batch, jax.random.key(0))
    want = from_flax_params(jax.tree.map(np.asarray, state.params))
    per = 8 // (n // 2)
    for r, out in enumerate(ranks[n]):
        steps = out["sp_steps"]
        data = r // 2
        assert steps["rows"] == (data * per, (data + 1) * per)
        for name in ("ring_plain", "ring_flash", "ulysses_plain",
                     "ulysses_flash"):
            np.testing.assert_allclose(steps[name]["loss"],
                                       float(m["loss"]), rtol=1e-5)
            for k, v in steps[name]["params"].items():
                _close(v, want[k].numpy(), 1e-5, f"rank {r} {name} {k}")


# ------------------------------------------------------------ pipeline
def _stage_fn_j(p, act):
    return jnp.tanh(act @ p["w"] + p["b"])


@pytest.mark.parametrize("n,m", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_apply_matches_jax(n, m, ranks, inputs):
    """Outputs on every rank, the input's gradient (summed over the
    stages, as JAX's transposes sum it) and each rank's stage gradient
    equal JAX's GPipe schedule and its gradient."""
    case = inputs[n][f"pp_{n}_{m}"]
    mesh = _jmesh(n, data=-1, model=n)
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    x = jnp.asarray(case["x"])

    def loss(sp, xx):
        y = jpipe.pipeline_apply(_stage_fn_j, sp, xx, mesh)
        return jnp.sum(y ** 2), y
    (_, y), (dp, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    ref = x
    for i in range(n):
        ref = _stage_fn_j({k: v[i] for k, v in params.items()}, ref)
    _close(y, ref, 2e-5, "JAX vs sequential")
    for r, out in enumerate(ranks[n]):
        got = out["pipelines"][f"pp_{m}"]
        _close(got["y"], y, 2e-5, f"rank {r} y")
        _close(got["dx"], dx, 2e-5, f"rank {r} dx")
        for k, g_ in got["dparams"].items():
            _close(g_, np.asarray(dp[k])[r:r + 1], 2e-5, f"rank {r} d{k}")
        assert got_bad_micro(out, n)


def got_bad_micro(out, n):
    return out["pipelines"]["bad_micro"] == (
        f"ValueError: microbatches ({n + 1}) must be divisible by pipeline "
        f"stages ({n}): the (M,...) input is sharded P('model') for "
        "storage, so a non-multiple silently truncates outputs")


def test_heterogeneous_pipeline_matches_jax(ranks, inputs):
    het = inputs[2]["het"]
    mesh = _jmesh(2, data=-1, model=2)
    fns = [lambda p, a: jnp.tanh(a @ p["w1"] @ p["w2"]),
           lambda p, a: jnp.tanh(a @ p["w"] + p["b"])]
    plist = jax.tree.map(jnp.asarray, het["params"])
    x = jnp.asarray(het["x"])

    def loss(pl):
        y = jpipe.pipeline_apply_heterogeneous(fns, pl, x, mesh)
        return jnp.sum(y ** 2), y
    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(plist)
    for r, out in enumerate(ranks[2]):
        got = out["pipelines"]["het"]
        _close(got["y"], y, 2e-5, f"rank {r} y")
        for k, g_ in got["dparams"].items():
            _close(g_, grads[r][k], 2e-5, f"rank {r} stage {r} d{k}")


def _flat_from_jax_pipeline(tree, k_per):
    """A JAX {'outer', 'stages'} tree as the port's flat ViT names."""
    flat = dict(tree["outer"])
    for sub, leaves in tree["stages"].items():
        k = int(sub[3:])
        s = jax.tree.leaves(leaves)[0].shape[0]
        for j in range(s):
            flat[f"blocks_{j * k_per + k}"] = jax.tree.map(
                lambda a, j=j: np.asarray(a)[j], leaves)
    return from_flax_params(jax.tree.map(np.asarray, flat))


def _port_stage_name(name, rank, k_per):
    """stages.sub<k>.<rest> of stage ``rank`` -> blocks.<i>.<rest>."""
    _, sub, rest = name.split(".", 2)
    return f"blocks.{rank * k_per + int(sub[3:])}.{rest}"


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_train_matches_jax(n, ranks, inputs):
    """S = n stages, 4 microbatches: the pipelined ViT's loss and the
    gradients of the embedding, the head and each rank's stage equal
    JAX's, then two SGD steps of the pipeline train step land on JAX's
    params; eval counts top-1. JAX's gradient is read off its first SGD
    step: with momentum from zero, params move by lr x the gradient."""
    p = inputs[n]
    mesh = _jmesh(n, data=-1, model=n)
    model = jvit.VisionTransformer(**PP_VIT, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, p["pp_flax"])
    outer, stages, k_per = jpt.split_vit_params(params, n)
    pp = {"outer": outer, "stages": stages}
    batch = {k: jnp.asarray(v) for k, v in p["pp_batch"].items()}
    tx = joptim.build_optimizer("sgd", PP_LR, momentum=0.9, params=pp)
    state = jpt.shard_pipeline_state(JTrainState.create(
        apply_fn=None, params=pp, tx=tx), mesh)
    step, eval_step = jpt.make_pipeline_train_step(model, mesh, tx, n,
                                                   k_per, 4)
    before = _flat_from_jax_pipeline(jax.tree.map(np.asarray, pp), k_per)
    losses, after = [], []
    for _ in range(2):
        state, m = step(state, batch, jax.random.key(0))
        losses.append(float(m["loss"]))
        after.append(_flat_from_jax_pipeline(
            jax.tree.map(np.asarray, state.params), k_per))
    want_g = {k: (before[k] - after[0][k]) / PP_LR for k in before}
    want_p = after[1]
    counts = eval_step(state, batch)
    for r, out in enumerate(ranks[n]):
        got = out["pipeline_train"]
        np.testing.assert_allclose(got["loss"], losses[0], rtol=1e-5)
        for name, g_ in got["grads"].items():
            ref = (want_g[name[len("outer."):]] if name.startswith("outer.")
                   else want_g[_port_stage_name(name, r, k_per)][None])
            _close(g_, ref.numpy(), 5e-5, f"rank {r} grad {name}")
        np.testing.assert_allclose([x["loss"] for x in got["metrics"]],
                                   losses, rtol=1e-5)
        assert got["eval"] == {"top1": int(counts["top1"]),
                               "count": int(counts["count"])}
        for name, v in got["state"].items():
            if name.startswith("outer."):
                _close(v, want_p[name[len("outer."):]].numpy(), 1e-5, name)
                continue
            for j in range(n):
                _close(v[j], want_p[_port_stage_name(name, j, k_per)]
                       .numpy(), 1e-5, f"{name} stage {j}")


# ------------------------------------------------------------- the feed
@pytest.mark.parametrize("n", [2, 4])
def test_loader_slices_follow_the_data_index(n, ranks, inputs):
    """data n/2 x seq 2: the seq ranks of one data index read the same
    rows, and the data groups' slices concatenated are the batch."""
    whole = DataLoader(ArraySource(**inputs[n]["feed"]), global_batch=8,
                       seed=3)
    whole.set_epoch(1)
    batches = [dict(b) for b in whole]
    data = n // 2
    for out in ranks[n]:
        got = out["loader"]
        assert got["host_batch"] == 8 // data
        i = got["coords"]["data"]
        for b, want in zip(got["batches"], batches):
            for k in want:
                np.testing.assert_array_equal(
                    b[k], np.asarray(want[k])[i * 8 // data:
                                              (i + 1) * 8 // data])


# -------------------------------------------------------------- the CLI
def test_cli_seq_and_pipeline_runs(ranks):
    """The train CLI's Trainer on two gloo ranks: model.attn=flash_hb
    takes the ring's flash path, which refuses N = 17; the ring (flash
    path, N = 10; plain path, N = 17 padded), Ulysses and the pipeline (2
    stages, 4 microbatches) each train an epoch and evaluate; both ranks
    agree; the pipeline's checkpoint holds the whole stacked state and
    restores bit-equal into a fresh placed state; the unsplit ViT the
    pipeline runs its modules from holds no weights (meta)."""
    outs = [o["cli"] for o in ranks[2]]
    assert outs[0]["flash_odd"] == (
        "ValueError: the seq axis size (2) must divide N=17 for the flash "
        "ring path (masking needs the lax path)")
    for name, _ in CLI_RUNS:
        assert outs[0][name] == {**outs[1][name]}, name
        ev = outs[0][name]["eval"]
        assert outs[0][name]["step"] == 2 and np.isfinite(
            list(ev.values())).all() and "top1" in ev
    pipe = outs[0]["pipeline"]
    assert pipe["restored"]
    assert pipe["vit_devices"] == ["meta"]
    assert pipe["shapes"]["stages.sub0.attn.qkv.weight"] == (2, 384, 128)
    assert pipe["shapes"]["outer.head.weight"] == (10, 128)
    # the ring's and Ulysses' flash paths train to the same weights
    assert outs[0]["ring"]["eval"] == pytest.approx(
        outs[0]["ulysses"]["eval"], rel=1e-5)
