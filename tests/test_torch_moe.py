"""The port's mixture of experts (deeplearning_tpu_torch/parallel/moe.py,
the Swin-MoE blocks, the classification loss's harvest of what JAX sows,
and expert parallelism through the mesh step) vs the JAX package, on the
CPU.

Inputs and weights are numpy-made from a seed (the flax trees'
shapes come from ``jax.eval_shape``), float32, JAX matmuls at highest
precision (tests/conftest.py). Tolerances:

- ``MoEMlp`` at top_k 1 and 2, with tokens dropped (capacity_factor 0.5)
  and without (8.0): output, aux loss, the three routing metrics and the
  input gradients within 1e-5; JAX's identical-experts case within 1e-5;
- ``swin_moe_micro_patch2_window7`` at 56²: eval logits 1e-4; the
  classification loss (aux terms in) rtol 1e-5, its gradients atol 1e-5,
  and its ``moe/*`` metrics 1e-5;
- expert parallelism on gloo ranks (this file, run as a script: the ranks
  import torch and the port, never JAX): 2 ranks at expert 2 and 4 ranks
  at data 2 x expert 2, one SGD step of JAX's
  test_expert_parallel_grads_match_unsharded configuration, its gradients
  held against JAX's ``MeshConfig(data=-1, expert=2)`` mesh on the virtual
  devices at that test's atol 1e-4 / rtol 1e-3, the loss and metrics
  rtol 1e-5; an AdamW checkpoint written at expert 2 restored unsplit
  with params and moments bit-equal.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":       # the test process (the ranks: torch only)
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning_tpu.core.registry import MODELS as JMODELS
    from deeplearning_tpu.parallel import moe as jmoe
    from deeplearning_tpu.parallel import mesh as jmesh
    from deeplearning_tpu.parallel import sharding as jsharding
    from deeplearning_tpu.train import TrainState as JTrainState
    from deeplearning_tpu.train import classification as jcls
    from deeplearning_tpu_torch import models  # noqa: F401  (registry)
    from deeplearning_tpu_torch.core import rng as trng
    from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
    from deeplearning_tpu_torch.parallel import moe as tmoe
    from deeplearning_tpu_torch.train import classification as tcls
    from deeplearning_tpu_torch.train import optim as toptim
    from deeplearning_tpu_torch.train.state import TrainState
    from deeplearning_tpu_torch.utils.convert import from_flax_params
    from test_torch_detection import seeded_tree
    from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# JAX's test_expert_parallel_grads_match_unsharded model, drop path off (the
# port's step trains it in train mode)
EP_MODEL = dict(num_classes=4, patch_size=2, embed_dim=32, depths=(2, 2),
                num_heads=(2, 4), num_experts=2, drop_path_rate=0.0)
EXPERT_LEAF = "stage0_block1.moe_mlp.experts.fc1_kernel"


def _close(got, want, tol, what, rtol=None):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol if rtol is None else rtol, atol=tol,
                               err_msg=what)


def _flax_tree(jm, sample, seed=0):
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(0), sample)
    return seeded_tree({"params": shapes["params"]}, seed=seed)


# ------------------------------------------------------------- the layer
@pytest.mark.parametrize("top_k,capacity_factor",
                         [(1, 0.5), (1, 8.0), (2, 0.5), (2, 8.0)])
def test_moe_layer_matches_jax(top_k, capacity_factor):
    """Output, aux loss, routing metrics and input gradients of one
    ``MoEMlp`` (4 experts, 48 tokens of width 16), with dropped tokens at
    capacity factor 0.5 and none at 8.0."""
    g = np.random.default_rng(0)
    x = g.normal(size=(2, 24, 16)).astype(np.float32)
    r = g.normal(size=(2, 24, 16)).astype(np.float32)
    jm = jmoe.MoEMlp(num_experts=4, top_k=top_k,
                     capacity_factor=capacity_factor, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    params = seeded_tree({"params": shapes["params"]})["params"]

    def run(xx):
        (out, aux), sown = jm.apply({"params": params}, xx,
                                    mutable=["moe_metrics"])
        return jnp.sum(out * r) + aux, (out, aux, sown["moe_metrics"])
    (_, (want, want_aux, metrics)), want_dx = jax.jit(
        jax.value_and_grad(run, has_aux=True))(jnp.asarray(x))

    tm = tmoe.MoEMlp(16, 4, top_k=top_k, capacity_factor=capacity_factor)
    tm.load_state_dict(from_flax_params(params))
    tx = torch.from_numpy(x).requires_grad_()
    with tmoe.collect_moe() as sown:
        out, aux = tm(tx)
    (out * torch.from_numpy(r)).sum().add(aux).backward()
    _close(out.detach(), want, 1e-5, "output")
    _close(aux.detach(), want_aux, 1e-5, "aux")
    _close(tx.grad, want_dx, 1e-5, "input gradient")
    (got,) = sown["moe_metrics"]
    for name, value in got.items():
        _close(value, metrics[name][0], 1e-5, name)
    assert sown["losses"] == []           # the layer returns it; blocks sow
    if capacity_factor < 1:
        assert float(got["drop_rate"]) > 0
    else:
        assert float(got["drop_rate"]) == 0


def test_identical_experts_reduce_to_plain_mlp():
    """JAX's TestMoETopKGateNormalization: with every expert the same and
    nothing dropped, the normalised top-2 combine is the one MLP."""
    torch.manual_seed(0)
    moe = tmoe.MoEMlp(8, num_experts=2, top_k=2, capacity_factor=8.0,
                      aux_weight=0.0)
    moe.experts.init_weights(torch.Generator().manual_seed(0))
    ex = moe.experts
    with torch.no_grad():
        for p in (ex.fc1_kernel, ex.fc1_bias, ex.fc2_kernel, ex.fc2_bias):
            p.copy_(p[:1].expand_as(p))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 6, 8)).astype(np.float32))
    with torch.no_grad():
        out, aux = moe(x)
        y = torch.nn.functional.gelu(x @ ex.fc1_kernel[0] + ex.fc1_bias[0],
                                     approximate="tanh")
        want = y @ ex.fc2_kernel[0] + ex.fc2_bias[0]
    assert aux is None                    # no_grad, no collector
    _close(out, want, 1e-5, "identical experts")


def test_collection_is_per_forward():
    """Nothing is kept outside ``collect_moe()``, a no-grad forward there
    computes no aux, and a collector holds only its own forwards."""
    model = TMODELS.build("swin_moe_micro_patch2_window7", num_classes=4,
                          dtype=torch.float32).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 56, 56, 3)).astype(np.float32))
    moes = [m for m in model.modules() if isinstance(m, tmoe.MoEMlp)]
    assert len(moes) == 2
    with torch.no_grad():
        assert moes[0](torch.zeros(1, 4, 32))[1] is None
        model(x)                                  # a serve-like forward
        with tmoe.collect_moe() as first:
            model(x)
        with tmoe.collect_moe() as second:
            model(x)
    assert len(first["losses"]) == len(second["losses"]) == 2
    assert len(first["moe_metrics"]) == 2
    for a, b in zip(first["losses"], second["losses"]):
        assert torch.equal(a, b)
    assert tmoe._collector() is None


def test_swin_moe_micro_matches_jax():
    """swin_moe_micro_patch2_window7 at 56²: eval logits; the
    classification loss with its aux terms, its gradients and its moe/*
    metrics (JAX's TestMoEObservability) against JAX's loss_fn."""
    name = "swin_moe_micro_patch2_window7"
    jm = JMODELS.build(name, num_classes=4, dtype=jnp.float32)
    g = np.random.default_rng(1)
    x = g.normal(size=(4, 56, 56, 3)).astype(np.float32)
    labels = g.integers(0, 4, 4)
    variables = _flax_tree(jm, jnp.zeros((1, 56, 56, 3)))
    tm = TMODELS.build(name, num_classes=4, dtype=torch.float32)
    tm.load_state_dict(from_flax_params(variables, like=tm))

    want_logits = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    jstate = JTrainState.create(apply_fn=jm.apply,
                                params=variables["params"],
                                tx=optax.sgd(0.0))
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jcls.make_loss_fn()(p, jstate, batch, jax.random.key(0)),
        has_aux=True))(variables["params"])

    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)), want_logits, 1e-4, "logits")
    state = TrainState.create(model=tm, tx=toptim.sgd(0.0))
    loss, aux = tcls.make_loss_fn()(
        state.params, state, {"image": torch.from_numpy(x),
                              "label": torch.from_numpy(labels)},
        trng.step_key(0, 0))
    _close(loss.detach(), want_loss, 1e-5, "loss", rtol=1e-5)
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    want = from_flax_params(want_grads, like=tm)
    assert set(want) == set(names)
    for n, gr in zip(names, grads):
        _close(gr, want[n], 1e-5, n)
    keys = ("moe/drop_rate", "moe/capacity_util", "moe/max_expert_load")
    for k in keys:
        _close(aux["metrics"][k].detach(), want_aux["metrics"][k], 1e-5, k)
    assert 0.0 <= float(aux["metrics"]["moe/drop_rate"]) <= 1.0
    assert 0.0 < float(aux["metrics"]["moe/capacity_util"]) <= 1.0
    assert float(aux["metrics"]["moe/max_expert_load"]) >= 1.0


# ------------------------------------------------- expert parallelism
def _spawn(n, tmp_path, payload, timeout=300):
    """This file as ``n`` gloo ranks (``_rank_main``); their results."""
    d = str(tmp_path)
    torch.save(payload, os.path.join(d, "in.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(n), d],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """The 2- and 4-rank spawns, started at once, and meanwhile JAX's
    gradients on its expert mesh, its loss and its metrics."""
    from concurrent.futures import ThreadPoolExecutor
    jm = JMODELS.build("swin_moe_tiny_patch4_window7_224",
                       dtype=jnp.float32, **EP_MODEL)
    params = _flax_tree(jm, jnp.zeros((1, 56, 56, 3)), seed=3)["params"]
    g = np.random.default_rng(4)
    x = g.normal(size=(4, 56, 56, 3)).astype(np.float32)
    payload = {"weights": from_flax_params(params), "image": x,
               "label": np.zeros(4, np.int64)}
    with ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(_spawn, n, tmp_path_factory.mktemp(f"ep{n}"),
                               payload) for n in (2, 4)}
        mesh = jmesh.build_mesh(jmesh.MeshConfig(data=-1, expert=2))
        ps = jax.device_put(params, jsharding.shard_params_tree(
            params, mesh, jmoe.MOE_RULES))
        assert any(not leaf.sharding.is_fully_replicated
                   for leaf in jax.tree.leaves(ps))
        state = JTrainState.create(apply_fn=jm.apply, params=ps,
                                   tx=optax.sgd(0.0))
        batch = jax.device_put({"image": jnp.asarray(x),
                                "label": jnp.zeros(4, jnp.int32)},
                               jsharding.batch_sharding(mesh))
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: jcls.make_loss_fn()(p, state, batch,
                                          jax.random.key(0)),
            has_aux=True))(ps)
        want = {"grads": {k: v.numpy() for k, v in from_flax_params(
            jax.tree.map(np.asarray, grads)).items()},
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in aux["metrics"].items()}}
        yield want, {n: r.result() for n, r in runs.items()}


@pytest.mark.parametrize("n", [2, 4], ids=["expert2", "data2_expert2"])
def test_expert_parallel_step_matches_jax_mesh(ep, n):
    """One SGD step at rate 1 on the mesh under MOE_RULES: each rank holds
    1 of the 2 experts, and the gradients (the parameter moves, gathered)
    match JAX's on its expert mesh; the loss and moe/* metrics too; the
    eval sums are the same on every rank."""
    want, runs = ep
    for rank, got in enumerate(runs[n]):
        assert got["coords"]["expert"] == rank % 2
        assert got["local_expert_shape"] == (1, 32, 128)
        assert got["native"] == sorted(
            k for k in want["grads"] if ".experts." in k)
        assert set(got["grads"]) == set(want["grads"])
        for k, v in got["grads"].items():
            _close(v, want["grads"][k], 1e-4, f"rank {rank} {k}", rtol=1e-3)
        _close(got["metrics"]["loss"], want["loss"], 1e-5, "loss", rtol=1e-5)
        for k, v in want["metrics"].items():
            _close(got["metrics"][k], v, 1e-5, k, rtol=1e-5)
        assert got["eval"] == runs[n][0]["eval"]
        assert got["eval"]["count"] == 4


def test_expert_parallel_checkpoint_restores_unsplit(ep):
    """An AdamW state stepped at expert 2, checkpointed (gathered whole)
    and restored by ``elastic_restore`` onto data 2 without rules: params
    and moments bit-equal to what was saved; a rank's expert bytes half
    the unsplit model's."""
    _, runs = ep
    for got in runs[2]:
        assert got["ckpt_step"] == 1
        for part in ("params", "moments"):
            saved, back = got["saved"][part], got["restored"][part]
            assert set(saved) == set(back) and saved
            for k in saved:
                assert np.array_equal(saved[k], back[k]), k
        assert got["expert_bytes"] * 2 == got["expert_bytes_unsplit"]


# ------------------------------------------------------ the gloo ranks
def _np(t):
    return t.detach().cpu().numpy().copy()


def _ep_state(weights, opt):
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.train import TrainState as State
    from deeplearning_tpu_torch.train.optim import build_optimizer
    with torch.device("meta"):
        model = MODELS.build("swin_moe_tiny_patch4_window7_224",
                             dtype=torch.float32, img_size=56, **EP_MODEL)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          assign=True)
    params = dict(model.named_parameters())
    tx = (build_optimizer("sgd", 1.0, momentum=0.0, params=params)
          if opt == "sgd" else build_optimizer("adamw", 1e-3, params=params))
    return State.create(model=model, tx=tx)


def _moments(tree, out):
    """{"<moment>/<param name>": array} of Adam's mu / nu dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("mu", "nu"):
                out.update({f"{k}/{n}": _np(t) for n, t in v.items()})
            else:
                _moments(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _moments(v, out)
    return out


def _gathered(state):
    tree = state.state_dict()
    return {"params": {k: _np(v) for k, v in tree["params"].items()},
            "moments": _moments(tree["opt_state"], {})}


def _rank_main(rank, n, d):
    torch.set_num_threads(1)
    sys.path[:0] = [REPO, HERE]
    import deeplearning_tpu_torch.models  # noqa: F401
    import torch.distributed as dist
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    from deeplearning_tpu_torch.elastic.resume import elastic_restore
    from deeplearning_tpu_torch.elastic.topology import current_topology
    from deeplearning_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                      initialize_distributed)
    from deeplearning_tpu_torch.parallel.moe import MOE_RULES
    from deeplearning_tpu_torch.parallel.sharding import (
        host_local_slice, tree_bytes_per_device)
    from deeplearning_tpu_torch.train import make_eval_step
    from deeplearning_tpu_torch.train.classification import (make_loss_fn,
                                                             make_metric_fn)
    from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                     shard_state)
    initialize_distributed(f"file://{os.path.join(d, 'store')}", n, rank,
                           device="cpu")
    payload = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    w = payload["weights"]
    mesh = build_mesh(MeshConfig(data=n // 2, expert=2), device="cpu")
    lo, hi = host_local_slice(4, mesh)
    batch = {"image": torch.from_numpy(payload["image"][lo:hi]),
             "label": torch.from_numpy(payload["label"][lo:hi])}
    state = shard_state(_ep_state(w, "sgd"), mesh, MOE_RULES)
    out = {"coords": dict(mesh.coords),
           "native": sorted(state.sharding.native),
           "local_expert_shape": tuple(state.params[EXPERT_LEAF].shape)}
    step = make_train_step(make_loss_fn(), mesh=mesh, rules=MOE_RULES)
    state, metrics = step(state, batch, 0)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    after = state.state_dict()["params"]
    out["grads"] = {k: _np(w[k] - after[k]) for k in after}
    ev = make_eval_step(make_metric_fn(), mesh=mesh)(state, batch)
    out["eval"] = {k: float(v) for k, v in ev.items()}
    if n == 2:
        st = shard_state(_ep_state(w, "adamw"), mesh, MOE_RULES)
        out["expert_bytes"] = tree_bytes_per_device(
            {k: v for k, v in st.params.items() if ".experts." in k})
        out["expert_bytes_unsplit"] = tree_bytes_per_device(
            {k: v for k, v in w.items() if ".experts." in k})
        st, _ = make_train_step(make_loss_fn(), mesh=mesh,
                                rules=MOE_RULES)(st, batch, 0)
        ck = CheckpointManager(os.path.join(d, "ckpt"))
        ck.save(1, st, topology=current_topology(state=st))
        out["saved"] = _gathered(st)
        dp = build_mesh(MeshConfig(data=2), device="cpu")
        back, out["ckpt_step"] = elastic_restore(ck, _ep_state(w, "adamw"),
                                                 dp)
        out["restored"] = _gathered(back)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
