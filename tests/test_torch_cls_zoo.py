"""The port's classification CNN zoo (deeplearning_tpu_torch/models/
classification/{lenet,cnns,mobile,convnext,repvgg,transfg}.py) vs the JAX
package, on the CPU, and the two CLIs on the train CLI's default model.

Every factory is built at full width at the small input sizes JAX's own
tests use (tests/test_classification_models.py: 64², VGG-11 at 64²,
GoogLeNet at 96²; LeNet at 28²), in float32; the weights are a numpy-made
flax tree (``seeded_tree``) converted by ``utils/convert.from_flax_params``.
The other factories of those families are held to JAX's variable names
and shapes. Tolerances: eval logits rtol / atol 1e-4 (JAX matmuls at highest
precision, tests/conftest.py); the BatchNorm running statistics after one
train-mode forward rtol / atol 1e-4 (a deep layer's variance moves by a
few 1e-5 with the summation order); RepVGG's fold equal to JAX's within 1e-6 and
its deploy forward equal to the train form's eval forward within 1e-4;
TransFG's logits and embedding 1e-4 and ``contrastive_loss`` 1e-6.
"""

import functools
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.models.classification import repvgg as jrepvgg
from deeplearning_tpu.models.classification import transfg as jtransfg
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.core import rng as trng
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.models.classification import repvgg as trepvgg
from deeplearning_tpu_torch.models.classification import transfg as ttransfg
from deeplearning_tpu_torch.utils.convert import from_flax_params
from test_torch_detection import seeded_tree
from torch_threads import one_torch_thread  # noqa: F401

# name, input size, port keywords (the size flax infers), both packages'
CASES = [
    ("mnist_cnn", 28, {"img_size": 28}, {}),
    ("mnist_fcn", 28, {"img_size": 28}, {}),
    ("vgg11", 64, {"img_size": 64}, {}),
    ("googlenet", 96, {"img_size": 96}, {}),
    ("shufflenet_v2_x1_0", 64, {}, {}),
    ("mobilenet_v2", 64, {}, {}),
    ("efficientnet_b0", 64, {}, {}),
    ("convnext_tiny", 64, {}, {"drop_path_rate": 0.1}),
    ("coatnet_0", 64, {}, {}),
    ("repvgg_a0", 64, {}, {}),
    ("transfg_small", 64, {"img_size": 64},
     {"embed_dim": 64, "depth": 3, "num_heads": 4, "num_parts": 5}),
]


def _images(n, size, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _pair(name, size, port_kw, kw, num_classes=7):
    """(flax module, its numpy variable tree, the port module loaded with
    it, in eval mode). The port module is built on the meta device (no
    initialisation to pay for) and takes the converted tensors as its
    own."""
    jm = JMODELS.build(name, num_classes=num_classes, dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(0), jnp.zeros((1, size, size, 3)))
    variables = seeded_tree(shapes)
    with torch.device("meta"):
        tm = TMODELS.build(name, num_classes=num_classes,
                           dtype=torch.float32, **port_kw, **kw)
    tm.load_state_dict(from_flax_params(variables, like=tm), assign=True)
    assert all(t.device.type == "cpu" for t in tm.state_dict().values())
    return jm, variables, tm.eval()


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("name,size,port_kw,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_factory_matches_jax(name, size, port_kw, kw):
    """Eval logits of every new family against JAX's; with BatchNorm, the
    running statistics after one train-mode forward against JAX's
    ``batch_stats``."""
    jm, variables, tm = _pair(name, size, port_kw, kw)
    x = _images(2, size)
    bn = "batch_stats" in variables

    def both(v, images):       # one compile: eval logits, train stats
        out = jm.apply(v, images, train=False)
        if not bn:
            return out, None
        return out, jm.apply(v, images, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(0)})[1]
    want, mutated = jax.jit(both)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if isinstance(want, dict):
        for key in ("logits", "embedding"):
            _close(got[key], want[key], 1e-4, f"{name} {key}")
        return
    _close(got, want, 1e-4, f"{name} logits")
    if not bn:
        return
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x), rng=trng.step_key(0, 0))
    want_sd = from_flax_params({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]},
                               like=tm)
    got_sd = tm.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert stats
    for k in stats:
        _close(got_sd[k], want_sd[k], 1e-4, f"{name} {k}")


# the other widths and depths of the families above
OTHER_FACTORIES = ["vgg13", "vgg16", "vgg19",
                   *(f"efficientnet_b{i}" for i in range(1, 8)),
                   "convnext_small", "convnext_base", "repvgg_a1",
                   "repvgg_a2", "repvgg_b0", "repvgg_b1"]


@pytest.mark.parametrize("name", OTHER_FACTORIES)
def test_every_other_factory_has_jaxs_variables(name):
    """The port's parameters and BatchNorm statistics, name for name and
    shape for shape, are the converted flax tree's at 64² (the logits
    test above holds each family's arithmetic once)."""
    jm = JMODELS.build(name, num_classes=7, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    with torch.device("meta"):
        tm = TMODELS.build(name, num_classes=7, dtype=torch.float32,
                           **({"img_size": 64} if name.startswith("vgg")
                              else {}))
    want = from_flax_params(jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes), like=tm)
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()
        if not k.endswith("num_batches_tracked")}


def test_googlenet_aux_logits_in_train_mode():
    """Train mode returns (logits, (aux1, aux2)), which the classification
    loss weighs 0.3; eval mode the logits alone (JAX's
    test_googlenet_aux_heads)."""
    from deeplearning_tpu_torch.ops import losses
    from deeplearning_tpu_torch.train import classification as tcls
    from deeplearning_tpu_torch.train import optim as toptim
    from deeplearning_tpu_torch.train.state import TrainState
    model = TMODELS.build("googlenet", num_classes=5, dtype=torch.float32,
                          img_size=96)
    x = torch.from_numpy(_images(2, 96))
    model.train()
    logits, (aux1, aux2) = model(x, rng=trng.step_key(0, 0))
    assert logits.shape == aux1.shape == aux2.shape == (2, 5)
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    model.eval()
    assert model(x).shape == (2, 5)
    # the loss adds 0.3 x each aux head's cross entropy
    state = TrainState.create(model=model, tx=toptim.sgd(0.0))
    labels = torch.tensor([1, 3])
    loss, _ = tcls.make_loss_fn(has_batch_stats=False)(
        state.params, state, {"image": x, "label": labels},
        trng.step_key(0, 0))
    want = sum(w * losses.cross_entropy(t, labels) for w, t in
               ((1.0, logits), (0.3, aux1), (0.3, aux2)))
    _close(loss.detach(), want.detach(), 1e-6, "googlenet loss")


def test_repvgg_reparameterize_matches_jax():
    """The fold on the port's state dict equals JAX's on its tree, and the
    deploy model's forward equals the train form's eval forward."""
    jm, variables, tm = _pair("repvgg_a0", 64, {}, {})
    with torch.device("meta"):
        deploy = TMODELS.build("repvgg_a0", num_classes=7,
                               dtype=torch.float32, deploy=True)
    want = from_flax_params(jrepvgg.reparameterize(
        variables["params"], variables["batch_stats"]), like=deploy)
    got = trepvgg.reparameterize(tm.state_dict())
    deploy.load_state_dict(got, assign=True)
    assert set(got) == set(want) == set(deploy.state_dict())
    for k in got:
        _close(got[k], want[k], 1e-6, k)
    x = torch.from_numpy(_images(2, 64))
    with torch.no_grad():
        _close(deploy.eval()(x), tm(x), 1e-4, "deploy vs train form")


def test_transfg_contrastive_loss_matches_jax():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(6, 16)).astype(np.float32)
    z[2] = 0.0                                  # a zero row stays finite
    labels = np.array([0, 1, 0, 2, 1, 0])
    want = jtransfg.contrastive_loss(jnp.asarray(z), jnp.asarray(labels))
    got = ttransfg.contrastive_loss(torch.from_numpy(z),
                                    torch.from_numpy(labels))
    _close(got, want, 1e-6, "contrastive loss")
    good = ttransfg.contrastive_loss(torch.tensor([[1.0, 0], [1.0, 0],
                                                   [0, 1.0], [0, 1.0]]),
                                     torch.tensor([0, 0, 1, 1]))
    assert float(good) < float(got)


def test_mnist_smoke_config_trains_and_serves(tmp_path, monkeypatch, capsys):
    """configs/mnist_smoke.yaml (the train CLI's default model, 1 input
    channel) through the port's train CLI for a few CPU steps; then
    ``--model mnist_cnn`` (3 channels, as the serve CLI feeds frames)
    through the serve CLI's stdin mode."""
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    from deeplearning_tpu_torch.train import __main__ as train_cli
    # the logger's TensorBoard backend off: importing it takes seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    work = tmp_path / "run"
    assert train_cli.main(["--cfg", "configs/mnist_smoke.yaml",
                           "train.device=cpu", "data.n_train=128",
                           "train.epochs=1", f"train.workdir={work}"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "top1" in last
    path = tmp_path / "two.npy"
    np.save(path, _images(2, 28, seed=5))
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{path}\n"))
    rc = serve_cli.main(["--model", "mnist_cnn", "--num-classes", "10",
                         "--size", "28", "--device", "cpu",
                         "--buckets", "1,4", "--topk", "3"])
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert rc == 0
    assert [a["image"] for a in out[:2]] == [0, 1]
    assert all(len(a["top"]) == 3 for a in out[:2])
