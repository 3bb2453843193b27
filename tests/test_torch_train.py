"""Port training step (deeplearning_tpu_torch/train, core/{rng,precision},
ops/losses, evaluation/metrics, utils/convert.from_optax_state) vs the
JAX package on the CPU.

A tiny ViT (img 32, patch 8, depth 2, dim 64, 4 heads, 10 classes, float32)
on the same weights through utils/convert.from_flax_params; images,
labels and gradients made from a seed with numpy. Tolerances, stated per
test: gradients 1e-4 relative; the optimizer fed the SAME numpy
gradients 1e-6 (Adam's first update is about lr * sign(g), so whole steps
would amplify tiny gradient differences); schedules 1e-7 of the peak rate
(float32 formulas whose cos/pow round differently in the last place in
numpy and XLA).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.ops.attention import get_attn_fn as j_get_attn_fn
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import make_eval_step as j_make_eval_step
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import optim as joptim
from deeplearning_tpu.train import schedules as jsched
from deeplearning_tpu.core import precision as jprecision
from deeplearning_tpu.ops import losses as jlosses
from deeplearning_tpu_torch.core import precision as tprecision
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.ops import losses as tlosses
from deeplearning_tpu_torch.ops.attention import get_attn_fn as t_get_attn_fn
from deeplearning_tpu_torch.train import TrainState, make_eval_step
from deeplearning_tpu_torch.train import make_train_step
from deeplearning_tpu_torch.train import bench as tbench
from deeplearning_tpu_torch.train import classification as tcls
from deeplearning_tpu_torch.train import optim as toptim
from deeplearning_tpu_torch.train import schedules as tsched
from deeplearning_tpu_torch.utils.convert import (from_flax_params,
                                                  from_optax_state)
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
            depth=2, num_heads=4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Force pallas interpret mode on CPU (the JAX flash_hb path)."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


@pytest.fixture(scope="module")
def jparams():
    """numpy leaves: the donating JAX step must not delete the shared
    weights."""
    model = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"])


def _batch(n=4, seed=0, nan=False):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    if nan:
        image[0, 0, 0, 0] = np.nan
    return {"image": image,
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _tbatch(batch):
    return {"image": torch.from_numpy(batch["image"]),
            "label": torch.from_numpy(batch["label"].astype(np.int64))}


def _jmodel(attn="naive"):
    return jvit.VisionTransformer(**TINY, dtype=jnp.float32,
                                  attn_fn=j_get_attn_fn(attn))


def _tmodel(jparams, attn="naive", **kw):
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                   attn_fn=t_get_attn_fn(attn), **kw)
    model.load_state_dict(from_flax_params(jparams))
    return model


def _assert_tree_close(port_tree, jax_tree, **tol):
    want = from_flax_params(jax.tree.map(np.asarray, jax_tree))
    assert set(port_tree) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(port_tree[name].detach().numpy(),
                                   w.numpy(), err_msg=name, **tol)


# ------------------------------------------------------------ loss / grads
@pytest.mark.parametrize("attn", ["naive", "flash_hb"])
def test_loss_and_grads_match_jax(jparams, attn):
    batch = _batch()
    jstate = JTrainState.create(apply_fn=_jmodel(attn).apply,
                                params=jparams, tx=optax.sgd(0.0))
    jloss_fn = jcls.make_loss_fn(label_smoothing=0.1)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jparams, jstate, jax.tree.map(jnp.asarray, batch), jax.random.key(1))

    model = _tmodel(jparams, attn)
    state = TrainState.create(model=model, tx=toptim.sgd(0.0))
    params = state.params
    loss, aux = tcls.make_loss_fn(label_smoothing=0.1)(
        params, state, _tbatch(batch), trng.step_key(1, 0))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["metrics"]["accuracy"].item(),
                               float(jaux["metrics"]["accuracy"]))
    _assert_tree_close(grads, jgrads, rtol=1e-4, atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 7)).astype(np.float32)
    labels = np.array([0, 3, -1, 6, 2, -1], np.int32)
    weights = rng.uniform(size=6).astype(np.float32)
    soft = rng.dirichlet(np.ones(7), 6).astype(np.float32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    for ls in (0.0, 0.1):
        for w in (None, weights):
            want = jlosses.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), ls,
                                         None if w is None
                                         else jnp.asarray(w))
            got = tlosses.cross_entropy(tl, tlab, ls, None if w is None
                                        else torch.from_numpy(w))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.soft_target_cross_entropy(tl, torch.from_numpy(soft)).item(),
        float(jlosses.soft_target_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(soft))),
        rtol=1e-6)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for max_norm in (None, 0.5, 100.0):
        jc, jn = jprecision.clip_by_global_norm(tree, max_norm)
        tc, tn = tprecision.clip_by_global_norm(ttree, max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6)
    assert tprecision.get_policy("bf16").compute_dtype == torch.bfloat16
    assert tprecision.get_policy("f32").compute_dtype == torch.float32


# ---------------------------------------------------------------- schedules
SCHEDULES = [("constant", dict(base_lr=1e-3)),
             ("warmup_cosine", dict(base_lr=1e-3, total_steps=100,
                                    warmup_steps=10)),
             ("warmup_cosine", dict(base_lr=1e-3, total_steps=10_000,
                                    warmup_steps=100)),
             ("cosine_lambda", dict(base_lr=0.01, total_steps=100)),
             ("yolox_warmcos", dict(base_lr=0.01, total_steps=100,
                                    warmup_steps=10, no_aug_steps=15)),
             ("poly", dict(base_lr=0.01, total_steps=100, warmup_steps=10)),
             ("multistep", dict(base_lr=0.1, milestones=(30, 60),
                                warmup_steps=5))]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedule_trace_matches_build_schedule(name, kw):
    want = jsched.build_schedule(name, **kw)
    got = tsched.build_schedule(name, **kw)
    w = np.array([float(want(t)) for t in range(121)])
    g = np.array([got(t) for t in range(121)])
    np.testing.assert_allclose(g, w, rtol=1e-7, atol=1.2e-7 * kw["base_lr"])


# -------------------------------------------------------------------- masks
def test_decay_and_freeze_masks_match_jax(jparams):
    params = dict(_tmodel(jparams).named_parameters())
    for got, want in (
            (toptim.decay_mask(params), joptim.decay_mask(jparams)),
            (toptim.freeze_mask(params, ("blocks_1", "patch_embed/proj")),
             joptim.freeze_mask(jparams, ("blocks_1", "patch_embed/proj")))):
        want = {k: bool(v) for k, v in from_flax_params(want).items()}
        assert got == want
    assert toptim.decay_mask(params)["blocks.0.attn.qkv.weight"]
    assert not toptim.decay_mask(params)["blocks.0.norm1.weight"]
    # whole-component match: blocks_1 does not catch blocks_10
    assert not toptim.freeze_mask({"blocks.10.mlp.fc1.weight":
                                   torch.zeros(2, 2)},
                                  ("blocks_1",))["blocks.10.mlp.fc1.weight"]


# ---------------------------------------------------------------- optimizer
OPTIMIZERS = [("sgd", dict(weight_decay=1e-4)),
              ("sgd", dict(nesterov=True)),
              ("adam", {}),
              ("adamw", dict(weight_decay=0.05)),
              ("adamw", dict(weight_decay=0.05, clip_grad_norm=0.5)),
              ("adamw", dict(weight_decay=0.05,
                             freeze=("blocks_1", "patch_embed")))]


def _grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), jparams)


def _txs(name, kw, jparams, params):
    sched = dict(base_lr=1e-2, total_steps=100, warmup_steps=2)
    jtx = joptim.build_optimizer(
        name, jsched.build_schedule("warmup_cosine", **sched),
        params=jparams, **kw)
    ttx = toptim.build_optimizer(
        name, tsched.build_schedule("warmup_cosine", **sched),
        params=params, **kw)
    return jtx, ttx


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_matches_optax_on_the_same_grads(jparams, name, kw):
    params = {n: p.detach().clone() for n, p in
              _tmodel(jparams).named_parameters()}
    jtx, ttx = _txs(name, kw, jparams, params)
    jp, jst, tst = jparams, jtx.init(jparams), ttx.init(params)
    for step in range(5):
        g = _grads(jparams, step)
        updates, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, updates)
        tupd, tst = ttx.update(from_flax_params(g), tst, params)
        toptim.apply_updates(params, tupd)
        _assert_tree_close(params, jp, rtol=1e-6, atol=1e-7)
    if "freeze" in kw:
        frozen = from_flax_params(jparams)["blocks.1.attn.qkv.weight"]
        torch.testing.assert_close(params["blocks.1.attn.qkv.weight"],
                                   frozen, atol=0, rtol=0)


@pytest.mark.parametrize("name,kw", OPTIMIZERS[::2] + OPTIMIZERS[3:4],
                         ids=["sgd-wd", "adam", "adamw-clip", "adamw"])
def test_optax_state_carries_across(jparams, name, kw):
    """JAX 2 steps == JAX 1 step -> from_optax_state -> port 1 step."""
    params = {n: p.detach().clone() for n, p in
              _tmodel(jparams).named_parameters()}
    jtx, ttx = _txs(name, kw, jparams, params)
    g0, g1 = _grads(jparams, 10), _grads(jparams, 11)
    jst = jtx.init(jparams)
    u, jst = jtx.update(jax.tree.map(jnp.asarray, g0), jst, jparams)
    jp1 = optax.apply_updates(jparams, u)
    port_params = {k: v.clone() for k, v in
                   from_flax_params(jax.tree.map(np.asarray, jp1)).items()}
    tst = from_optax_state(jax.tree.map(np.asarray, jst))
    u, jst = jtx.update(jax.tree.map(jnp.asarray, g1), jst, jp1)
    jp2 = optax.apply_updates(jp1, u)
    tupd, tst = ttx.update(from_flax_params(g1), tst, port_params)
    toptim.apply_updates(port_params, tupd)
    _assert_tree_close(port_params, jp2, rtol=1e-6, atol=1e-7)
    assert jax.tree.structure(ttx.init(params)) == jax.tree.structure(tst)


# --------------------------------------------------------------- the steps
def _states(jparams, attn="naive", use_ema=False):
    jtx = joptim.build_optimizer("sgd", 0.05, weight_decay=1e-4,
                                 params=jparams)
    jstate = JTrainState.create(apply_fn=_jmodel(attn).apply,
                                params=jax.tree.map(jnp.asarray, jparams),
                                tx=jtx, use_ema=use_ema, ema_decay=0.99)
    model = _tmodel(jparams, attn)
    params = dict(model.named_parameters())
    ttx = toptim.build_optimizer("sgd", 0.05, weight_decay=1e-4,
                                 params=params)
    return jstate, TrainState.create(model=model, tx=ttx, use_ema=use_ema,
                                     ema_decay=0.99)


def test_train_step_matches_jax(jparams):
    """Two full steps (SGD with momentum and decay at constant lr, EMA on):
    loss and grad_norm per step 1e-5, params and EMA after 1e-5."""
    jstate, state = _states(jparams, use_ema=True)
    jstep = j_make_train_step(jcls.make_loss_fn(label_smoothing=0.1))
    step = make_train_step(tcls.make_loss_fn(label_smoothing=0.1),
                           device="cpu")
    for i in range(2):
        batch = _batch(seed=20 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jax.random.key(0))
        state, m = step(state, batch, trng.root_key(0))
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert m["bad_step"].dtype == torch.int32
        assert m["bad_step"].item() == int(jm["bad_step"]) == 0
    assert state.step == int(jstate.step) == 2
    _assert_tree_close(state.params, jstate.params, rtol=1e-5, atol=1e-6)
    _assert_tree_close(state.ema_params, jstate.ema_params, rtol=1e-5,
                       atol=1e-6)


def test_accum_steps_match_single_step(jparams):
    batch = _batch(n=8, seed=5)
    out = []
    for accum in (1, 2):
        _, state = _states(jparams)
        step = make_train_step(tcls.make_loss_fn(), accum_steps=accum,
                               device="cpu")
        state, m = step(state, batch, trng.root_key(0))
        out.append((state.params, m))
    (p1, m1), (p2, m2) = out
    for name in p1:
        torch.testing.assert_close(p1[name], p2[name], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"].item(),
                               m2["grad_norm"].item(), rtol=1e-5)


def test_ema_warmup_decay():
    """d = decay * (1 - exp(-(step + 1) / 2000)) on the step before the
    increment; the EMA starts as a copy of the params."""
    model = torch.nn.Linear(3, 2)
    state = TrainState.create(model=model, tx=toptim.sgd(0.1, momentum=None),
                              use_ema=True, ema_decay=0.9998)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    state.apply_gradients(grads)
    d = 0.9998 * (1 - np.exp(-1 / 2000.0))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[n] - 0.1)
        torch.testing.assert_close(state.ema_params[n],
                                   before[n] * d + p.detach() * (1 - d))
    assert state.step == 1 and state.eval_params is state.ema_params


def test_eval_step_counts_match_jax(jparams):
    batch = _batch(n=16, seed=7)
    jstate, state = _states(jparams)
    want = j_make_eval_step(jcls.make_metric_fn())(
        jstate, jax.tree.map(jnp.asarray, batch))
    got = make_eval_step(tcls.make_metric_fn(), device="cpu")(state, batch)
    for key in ("top1", "top5", "count"):
        assert got[key].dtype == torch.int32
        assert got[key].item() == int(want[key]), key
    np.testing.assert_allclose(got["loss_sum"].item(),
                               float(want["loss_sum"]), rtol=1e-5)


def test_bad_step_flags_a_nan_batch(jparams):
    _, state = _states(jparams)
    step = make_train_step(tcls.make_loss_fn(), device="cpu")
    _, m = step(state, _batch(nan=True), trng.root_key(0))
    assert m["bad_step"].item() == 1 and not np.isfinite(m["loss"].item())


def test_multi_gpu_options_name_their_slice():
    """ZeRO-1 and the int8 collectives need a mesh (JAX's ValueError);
    rules need one too; on a mesh the tensor-parallel rules build a
    step (item 7c is in)."""
    from deeplearning_tpu_torch.parallel import mesh as tmesh
    from deeplearning_tpu_torch.parallel import sharding as tsharding
    loss_fn = tcls.make_loss_fn()
    for kw in (dict(weight_update="zero1"), dict(grad_comm="int8")):
        with pytest.raises(ValueError, match="need a mesh"):
            make_train_step(loss_fn, device="cpu", **kw)
    with pytest.raises(ValueError):
        make_train_step(loss_fn, device="cpu", weight_update="zero2")
    mesh = tmesh.build_mesh(tmesh.MeshConfig(), 1, 0, device="cpu")
    assert callable(make_train_step(loss_fn, mesh=mesh,
                                    rules=tsharding.TRANSFORMER_TP_RULES))
    with pytest.raises(ValueError, match="pass mesh="):
        make_train_step(loss_fn, device="cpu", rules=tsharding.FSDP_RULES)


def test_step_and_bench_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tcls.make_loss_fn())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(tcls.make_metric_fn())
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main([])


def test_bench_cpu_smoke(capsys):
    """A tiny config runs on the CPU and prints one JSON line with no MFU
    (a CPU time is no device measurement)."""
    import json
    assert tbench.main(["--device", "cpu", "--model", "vit_micro_patch4_56",
                        "--depth", "1", "--batch", "2", "--steps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "vit_b16_train_mfu" and rec["value"] is None
    assert rec["device"] == "cpu" and rec["attn"] == "flash_hb"
    assert rec["opt_state_bytes_per_device"] > 0


def test_analytic_step_flops_of_vit_b16():
    model = tvit.VisionTransformer()      # ViT-B/16 widths, 12 layers
    assert 3 * tbench.vit_forward_flops(model, 128) == pytest.approx(
        1.35e13, rel=5e-3)


def test_step_keys_are_deterministic():
    a = torch.rand(4, generator=trng.step_key(trng.root_key(7), 3))
    b = torch.rand(4, generator=trng.step_key(trng.root_key(7), 3))
    c = torch.rand(4, generator=trng.step_key(trng.root_key(7), 4))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    assert trng.fold_in(1, 2) != trng.fold_in(2, 1)


def test_profile_sorts_kernels_by_kind():
    from deeplearning_tpu_torch.train.profile import kind_of
    assert kind_of("void (anonymous namespace)::bwd_dkv_bf16_mma<64, 4>"
                   ) == "flash attention"
    # the Hopper (wgmma) forward and dK/dV kernels are flash attention too
    assert kind_of("void (anonymous namespace)::fwd_bf16_wgmma<64, 4>"
                   "((anonymous namespace)::FwdMaps, (anonymous namespace)"
                   "::Params)") == "flash attention"
    assert kind_of("void (anonymous namespace)::bwd_dkv_bf16_wgmma<64, 4, "
                   "__nv_bfloat16>(...)") == "flash attention"
    assert kind_of("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == "gemm"
    assert kind_of("void at::native::multi_tensor_apply_kernel<...>"
                   ) == "optimizer"
    assert kind_of("void at::native::vectorized_elementwise_kernel<4>"
                   ) == "elementwise / other"
