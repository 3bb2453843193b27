"""The port's structural audit over fake-mode traces
(deeplearning_tpu_torch/analysis/audit.py) vs the JAX package's jaxpr
audit (deeplearning_tpu/analysis/jaxpr.py), on the CPU.

- On toy functions the port's counts equal JAX's for the same
  computation: the peak intermediate, products (``dot_general`` /
  ``aten.mm``), transfers, and collectives with their operand bytes
  (``psum`` is ``all_reduce``).
- The walk computes nothing and launches nothing: a depth-2 ViT-B/16 on
  K1 (``flash_hb``) shows its 2 forward, 2 dQ and 2 dK/dV kernel nodes
  and no launch; a scalar read is a transfer.
- Every builtin row is ok on the CPU, and the ZeRO-1 rows hold on two
  gloo ranks (tests/torch_ranks.py scenario "audits").
- K1's FLOP formula makes ``FlopCounterMode`` count attention: ViT-B/16
  on K1 counts what it counts on the naive path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.analysis import jaxpr as jaudit
from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch.analysis import audit
from deeplearning_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

X = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
W = np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32)


def _fake(*arrays):
    mode = audit.fake_mode()
    return [audit.fake_tensor(mode, a.shape) for a in arrays]


def test_peak_intermediate_equals_jax():
    jfn = lambda x: (x[:, :, None] * x[:, None, :]).sum()  # noqa: E731
    want = jaudit.peak_intermediate(jfn, jnp.asarray(X))
    assert audit.peak_intermediate(jfn, *_fake(X)) == want == 8 * 16 * 16
    assert audit.assert_peak_intermediate_below(jfn, tuple(_fake(X)),
                                                want) == want
    with pytest.raises(AssertionError, match="exceeds budget"):
        audit.assert_peak_intermediate_below(jfn, tuple(_fake(X)), 100)


def test_products_and_transfers_equal_jax():
    jfn = lambda x, w: (x @ w) @ w.T + 1.0  # noqa: E731
    x, w = jnp.asarray(X), jnp.asarray(W)
    assert audit.count_ops(jfn, "aten.mm", *_fake(X, W)) == \
        jaudit.count_primitive(jfn, "dot_general", x, w) == 2
    assert audit.count_transfers(jfn, *_fake(X, W)) == \
        jaudit.count_transfers(jfn, x, w) == 0
    # a host read is a transfer (a jaxpr cannot hold one)
    assert audit.count_transfers(lambda x: x * x.sum().item(),
                                 *_fake(X)) == 1


def test_collectives_and_bytes_equal_jax():
    def jfn(x):
        return jax.lax.psum(x, "i") + jax.lax.all_gather(x, "i").sum(0)

    env = [("i", 2)]
    x = jnp.asarray(X)
    jcount = jaudit.count_collectives(jfn, x, axis_env=env)
    jbytes = jaudit.collective_bytes(jfn, x, axis_env=env)

    def tfn(t):
        f = torch.ops._c10d_functional
        return f.all_reduce(t, "sum", "0") + \
            f.all_gather_into_tensor(t, 2, "0").view(2, 8, 16).sum(0)

    names = {"psum": "all_reduce", "all_gather": "all_gather"}
    assert audit.count_collectives(tfn, *_fake(X)) == \
        {names[k]: v for k, v in jcount.items()} == \
        {"all_reduce": 1, "all_gather": 1}
    assert audit.collective_bytes(tfn, *_fake(X)) == \
        {names[k]: v for k, v in jbytes.items()}
    assert audit.count_collectives(lambda t: t * 2, *_fake(X)) == {} == \
        jaudit.count_collectives(lambda t: t * 2, x)


@pytest.fixture(scope="module")
def vit2():
    model, _ = hub.load("vit_base_patch16_224", num_classes=10, seed=0,
                        device="cpu", depth=2, dtype=torch.float32,
                        **hub.model_kwargs("vit_base_patch16_224",
                                           "flash_hb"))
    return model


def test_vit_on_k1_traces_its_kernel_nodes_without_a_launch(vit2):
    fa.reset_launch_counts()
    mode = audit.fake_mode()
    x = audit.fake_tensor(mode, (2, 224, 224, 3))
    events = audit.trace(vit2, x)
    names = [ev.name for ev in events]
    assert names.count("dltpu.flash_fwd") == 2
    assert not any(ev.transfer for ev in events)
    assert all(v == 0 for v in fa.launch_counts().values())
    # the forward's output: (B, H, N, D) in a (B, N, H, D) buffer
    fwd = next(ev for ev in events if ev.name == "dltpu.flash_fwd")
    assert fwd.out_elements == [2 * 12 * 197 * 64, 2 * 12 * 197]


def test_builtin_audits_all_pass_on_the_cpu():
    fa.reset_launch_counts()
    rows = {r["name"]: r for r in audit.run_audits(device="cpu")}
    assert all(r["ok"] for r in rows.values()), \
        [r for r in rows.values() if not r["ok"]]
    assert set(rows) == {"nms_k3_n4096", "nms_reference_n4096",
                         "roi_align_onepass", "train_step_mnist",
                         "train_step_vit_b16_flash_hb_depth2",
                         "zoo_multimodel"}
    assert rows["nms_k3_n4096"]["ops"] == {"dltpu.nms_sweep": 1}
    assert rows["nms_reference_n4096"]["peak_elements"] >= 4096 ** 2
    assert rows["train_step_vit_b16_flash_hb_depth2"]["ops"] == {
        "dltpu.flash_fwd": 2, "dltpu.flash_bwd_dq": 2,
        "dltpu.flash_bwd_dkv": 2}
    assert all(v == 0 for v in fa.launch_counts().values())
    # a broken audit reports instead of raising
    bad = audit.Audit("bad", lambda x: x.reshape(3, 5), (torch.zeros(4),))
    row = bad.run()
    assert row["ok"] is False and "error" in row


def test_zero1_rows_hold_on_two_gloo_ranks(tmp_path):
    """JAX reads the compiled HLO; the port reads launch_counts() and the
    operand bytes of one real step per mode."""
    from torch_ranks import run_ranks
    results = run_ranks("audits", 2, tmp_path, {}, timeout=240)
    for res in results:
        rows = {r["name"]: r for r in res["rows"]}
        assert set(rows) == {"train_step_zero1_dp2",
                             "train_step_replicated_dp2"}
        assert all(r["ok"] for r in rows.values()), rows
        assert rows["train_step_zero1_dp2"]["collective_calls"][
            "reduce_scatter"] >= 1
        assert res["counts"] == {"all_reduce": 1, "all_gather": 1}
        assert res["bytes"] == {"all_reduce": 128, "all_gather": 128 * 3}


def test_k1_flop_formula_counts_attention(vit2):
    from deeplearning_tpu_torch.export.serialize import flops_estimate
    x = torch.zeros(1, 224, 224, 3)
    k1 = flops_estimate(vit2, x)
    naive, _ = hub.load("vit_base_patch16_224", num_classes=10, seed=0,
                        device="cpu", depth=2, dtype=torch.float32,
                        **hub.model_kwargs("vit_base_patch16_224", "naive"))
    assert k1 == flops_estimate(naive, x)
    assert k1 > 2 * fa.flops(1, 12, 197, 64)
