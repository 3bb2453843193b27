"""Port Swin (deeplearning_tpu_torch/models/classification/swin.py) vs the
JAX Swin, on the same weights through utils/convert.from_flax_params.

Small configurations, float32, inputs and weights made from a seed with
numpy (the flax tree's shapes come from ``jax.eval_shape``, so no JAX init
is compiled). The JAX fused window attention runs interpreted, as its own
tests run it. Tolerances: logits 1e-4 (tests/conftest.py sets JAX matmuls
to highest precision; the CPU's float32 matmuls are full precision); one
train step's loss and gradient norm 1e-5 relative.

Also the repairs of the serve CLI and the train bench that let them build
a Swin model, and the analytic FLOPs of Swin-T.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.train import TrainState as JTrainState
from deeplearning_tpu.train import classification as jcls
from deeplearning_tpu.train import make_train_step as j_make_train_step
from deeplearning_tpu_torch import hub, models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.serve import __main__ as serve_cli
from deeplearning_tpu_torch.train import TrainState, make_train_step
from deeplearning_tpu_torch.train import bench as tbench
from deeplearning_tpu_torch.train import classification as tcls
from deeplearning_tpu_torch.train import optim as toptim
from deeplearning_tpu_torch.utils.convert import from_flax_params
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Force pallas interpret mode on CPU (the JAX use_pallas path)."""
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _jax_weights(jmodel, size, seed=0):
    """A flax parameter tree of numpy arrays for ``jmodel`` at ``size``²
    inputs: kernels N(0, 1/fan_in), biases and tables N(0, 0.1²), norm
    scales 1 + N(0, 0.1²), v2's logit scale log(10) + N(0, 0.1²)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) >= 2 and name != "logit_scale":
            value = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        value += {"scale": 1.0, "logit_scale": np.log(10.0)}.get(name, 0.0)
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


# name, input size, keywords for both factories
CASES = {
    # shifted 7x7 windows at 14x14, a merge, an unshifted 7x7 last stage
    "micro": ("swin_micro_patch2_window7", 28, {}),
    "micro_fused": ("swin_micro_patch2_window7", 28, {"use_pallas": True}),
    # the window shrinks to the grid: 6x6 (N = 36), then 3x3 (N = 9)
    "micro_small_fused": ("swin_micro_patch2_window7", 12,
                          {"use_pallas": True}),
    "v2": ("swinv2_tiny_patch4_window7_224", 56,
           {"depths": (2, 2), "patch_size": 2}),
    "mlp": ("swin_mlp_tiny_c24_patch4_window8_256", 64, {"depths": (2, 2)}),
    "mini_ape": ("swin_mini_patch2_window7_ape", 56, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax(case):
    name, size, kw = CASES[case]
    jmodel = JMODELS.build(name, num_classes=10, dtype=jnp.float32, **kw)
    params = _jax_weights(jmodel, size)
    x = _images(2, size, seed=1)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        params, jnp.asarray(x)))
    model = TMODELS.build(name, num_classes=10, dtype=torch.float32,
                          img_size=size, **kw)
    state = from_flax_params(params)
    # no buffer leaks into the state: its keys are the flax tree's
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_swin_t_state_dict_is_the_flax_tree():
    """Swin-T's 173 flax leaves, names and shapes, against the port's
    state_dict (the converter turns the HWIO patch kernel into a linear
    weight)."""
    jmodel = JMODELS.build("swin_tiny_patch4_window7_224", num_classes=10)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_params(tree)
    model = TMODELS.build("swin_tiny_patch4_window7_224", num_classes=10)
    assert len(state) == 173
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    assert model.state_dict()["patch_embed.weight"].shape == (96, 48)
    # the host-side tables are buffers, not state
    names = {n for n, _ in model.named_buffers()}
    assert "stage0_block0.attn.relative_position_index" in names


def test_train_step_matches_jax():
    """One SGD step of the micro model through the fused path on both
    sides (JAX: interpreted kernel, backward through the reference)."""
    name, size = "swin_micro_patch2_window7", 28
    jmodel = JMODELS.build(name, num_classes=10, dtype=jnp.float32,
                           use_pallas=True)
    params = _jax_weights(jmodel, size, seed=2)
    rng = np.random.default_rng(3)
    batch = {"image": _images(4, size, seed=4),
             "label": rng.integers(0, 10, 4).astype(np.int32)}
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=jax.tree.map(jnp.asarray,
                                                    params["params"]),
                                tx=optax.sgd(0.1))
    jstep = j_make_train_step(jcls.make_loss_fn(label_smoothing=0.1))
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.key(0))

    model = TMODELS.build(name, num_classes=10, dtype=torch.float32,
                          img_size=size, use_pallas=True)
    model.load_state_dict(from_flax_params(params))
    state = TrainState.create(model=model, tx=toptim.sgd(0.1, momentum=None))
    step = make_train_step(tcls.make_loss_fn(label_smoothing=0.1),
                           device="cpu")
    state, m = step(state, batch, trng.root_key(0))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    assert m["bad_step"].item() == 0


def test_remat_gives_the_same_gradients():
    x = torch.from_numpy(_images(2, 12, seed=5))
    grads = []
    for remat in (False, True):
        model = TMODELS.build("swin_micro_patch2_window7", num_classes=10,
                              dtype=torch.float32, img_size=12,
                              use_pallas=True, drop_path_rate=0.3,
                              remat=remat).train()
        loss = model(x, rng=trng.step_key(trng.root_key(0), 1)).square().sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_unported_and_wrong_options_raise():
    with pytest.raises(NotImplementedError, match="moe"):
        TMODELS.build("swin_moe_micro_patch2_window7", num_classes=10)
    with pytest.raises(NotImplementedError, match="moe"):
        TMODELS.build("swin_micro_patch2_window7", moe=True)
    with pytest.raises(NotImplementedError, match="v1"):
        TMODELS.build("swinv2_tiny_patch4_window7_224", use_pallas=True)
    model = TMODELS.build("swin_micro_patch2_window7", num_classes=10,
                          img_size=28)
    with pytest.raises(ValueError, match="img_size"):
        model(torch.zeros(1, 56, 56, 3))


def test_factories_mirror_the_jax_registry():
    jax_swins = sorted(n for n in JMODELS.keys() if n.startswith("swin"))
    assert len(jax_swins) == 15
    assert hub.list_models("swin") == jax_swins


def test_shift_masks_are_buffers_that_move_with_the_model():
    model = TMODELS.build("swin_micro_patch2_window7", num_classes=10,
                          img_size=28)
    assert model.stage0_block1.shift == 3
    assert model.stage0_block1.attn_mask.shape == (4, 49, 49)
    assert model.stage0_block0.attn_mask is None
    assert model.stage1_block1.shift == 0       # the 7x7 grid is one window
    assert model.stage1_block1.attn_mask is None
    assert "stage0_block1.attn_mask" in dict(model.named_buffers())
    assert not any("attn_mask" in k for k in model.state_dict())


def test_swin_t_forward_flops_near_the_published_figure():
    """4.5 GMAC (9.0 GFLOP) an image at 224² (Swin paper, Table 1)."""
    model = TMODELS.build("swin_tiny_patch4_window7_224")
    flops = tbench.swin_forward_flops(model, 1, 224)
    assert flops == pytest.approx(9.0e9, rel=0.05)
    assert tbench.forward_flops(model, 128, 224) == pytest.approx(
        128 * flops)


# ------------------------------------------------------------- the repairs
def test_serve_cli_serves_a_swin_model(tmp_path, monkeypatch, capsys):
    path = tmp_path / "two.npy"
    np.save(path, _images(2, 28, seed=6))
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{path}\n"))
    rc = serve_cli.main(["--model", "swin_micro_patch2_window7", "--size",
                         "28", "--device", "cpu", "--buckets", "1,2",
                         "--num-classes", "5", "--topk", "2"])
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert rc == 0
    assert [a["image"] for a in out] == [0, 1]
    assert all(len(a["top"]) == 2 for a in out)
    with pytest.raises(ValueError, match="Swin"):
        serve_cli.main(["--model", "swin_micro_patch2_window7", "--size",
                        "28", "--device", "cpu", "--attn", "sdpa"])


def test_model_kwargs_by_family():
    assert hub.model_kwargs("swin_tiny_patch4_window7_224", "naive") == {
        "use_pallas": False}
    assert hub.model_kwargs("swin_tiny_patch4_window7_224", "flash",
                            224) == {"use_pallas": True, "img_size": 224}
    kw = hub.model_kwargs("vit_base_patch16_224", "naive", 224)
    assert kw == {"attn_fn": None, "img_size": 224}


def test_bench_cpu_smoke_of_a_swin_model(capsys):
    assert tbench.main(["--device", "cpu", "--model",
                        "swin_micro_patch2_window7", "--size", "28",
                        "--batch", "2", "--steps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "swin_t_train_mfu" and rec["value"] is None
    assert rec["size"] == 28 and rec["device"] == "cpu"
    assert rec["step_flops"] > 0 and np.isfinite(rec["loss1"])


def test_window_bench_needs_the_card(monkeypatch):
    from deeplearning_tpu_torch.ops import window_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        window_bench.main([])


def test_profile_sorts_the_window_kernel_by_kind():
    from deeplearning_tpu_torch.train.profile import kind_of
    assert kind_of("void (anonymous namespace)::win_bf16_mma<32, 4>"
                   "((anonymous namespace)::Params)") == "window attention"
    assert kind_of("void (anonymous namespace)::win_bf16_wgmma<32, true>"
                   "((anonymous namespace)::WinMaps, (anonymous namespace)"
                   "::Params)") == "window attention"
    assert kind_of("void (anonymous namespace)::fwd_bf16_mma<64, 4>"
                   "((anonymous namespace)::Params)") == "flash attention"
