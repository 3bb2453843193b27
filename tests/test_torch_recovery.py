"""The port's robust half (deeplearning_tpu_torch/train/recovery,
elastic/{signals,preempt,heartbeat}, obs/flight's SIGTERM hooks,
analysis/strict) vs the JAX package, on the CPU.

- ``RecoveryManager``: one script of seed / maybe_snapshot /
  mark_verified / on_divergence / cooldown_scale calls on a toy state in
  both frameworks gives equal results, ``stats()``, anchor steps and
  exceptions (the JAX tests/test_recovery.py cases are its model);
  ``damp_update`` within 1e-6; ``poison_state`` and ``snapshot_state``
  on a ``TrainState``.
- The signal registry chains as JAX's (tests/test_elastic.py), the guard
  flushes and flags, ``flush_pending`` writes the deferred dump.
- Heartbeat records equal JAX's for the same calls (time fields apart).
- ``strict.resolve`` gives JAX's sets for every spelling JAX and the port
  share, ``threads`` / ``all`` included, and ``maybe_enable_threads``
  arms the sanitizer for ``threads``; the NaN hooks name
  the first module whose output, or whose output's gradient, holds a NaN.
"""

import json
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.analysis import strict as jstrict
from deeplearning_tpu.elastic import heartbeat as jhb
from deeplearning_tpu.train import recovery as jrec
from deeplearning_tpu_torch.analysis import strict
from deeplearning_tpu_torch.elastic import heartbeat as thb
from deeplearning_tpu_torch.elastic import preempt, signals
from deeplearning_tpu_torch.obs import flight
from deeplearning_tpu_torch.train import recovery as trec


def _deliver(signum):
    os.kill(os.getpid(), signum)
    # the handler runs on the main thread at the next bytecode boundary
    for _ in range(100):
        time.sleep(0.001)


# ------------------------------------------------------- RecoveryManager
def _run_script(rec, full):
    """One fixed call sequence; every result in a comparable form."""
    def value(tree):
        return round(float(np.asarray(tree["w"])[0]), 6)

    log = []

    def call(name, *args):
        try:
            out = getattr(mgr, name)(*args)
        except rec.RecoveryExhausted as exc:
            out = ("RecoveryExhausted", str(exc))
        if name == "on_divergence" and isinstance(out, tuple) and \
                not isinstance(out[0], str):
            out = (out[0], value(out[1]))
        log.append((name, args, out, mgr.anchor_step, mgr.stats()))

    mgr = rec.RecoveryManager(rec.RecoveryPolicy(
        anchor_every=2, max_recoveries=2, budget_steps=10,
        cooldown_steps=3, lr_decay=0.25))
    call("on_divergence", 1)                  # no anchor yet
    mgr.seed(0, full(0.0))
    for step in range(1, 8):
        mgr.maybe_snapshot(step, full(float(step)))
    log.append(("pending", [s for s, _ in mgr._pending]))
    for step in (2, 3, 5):
        call("mark_verified", step)
    call("on_divergence", 6)
    for step in (2, 4, 6, 7):
        call("cooldown_scale", step)
    call("on_divergence", 7)
    call("on_divergence", 8)                  # budget spent
    call("on_divergence", 30)                 # 6 and 7 aged out
    return log


def test_recovery_manager_matches_jax():
    jlog = _run_script(jrec, lambda v: {"w": jnp.full((3,), v)})
    tlog = _run_script(trec, lambda v: {"w": torch.full((3,), v)})
    assert tlog == jlog
    assert jlog[-1][-1]["skipped_windows"] == [[4, 6], [4, 7], [4, 30]]
    assert jlog[0][2][0] == "RecoveryExhausted"


def _toy_state():
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train import optim as toptim
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    return model, TrainState.create(
        model=model, tx=toptim.build_optimizer(
            "adamw", 0.1, params=dict(model.named_parameters())),
        batch_stats=dict(model.named_buffers()))


def test_rollback_copy_survives_mutation_and_policy_values():
    """The anchor is handed out as is; loading it into a state, poisoning
    that state and stepping it leaves the anchor intact for a second
    rollback."""
    _, state = _toy_state()
    ones = {n: torch.ones_like(p) for n, p in state.params.items()}
    mgr = trec.RecoveryManager(trec.RecoveryPolicy(anchor_every=2))
    mgr.seed(0, state)
    state.apply_gradients(ones)
    state.apply_gradients(ones)
    mgr.maybe_snapshot(2, state)
    want = trec.snapshot_state(state)
    mgr.mark_verified(3)
    for bad in (4, 5):
        step, tree = mgr.on_divergence(bad)
        assert step == 2
        state.load_state_dict(tree)
        trec.poison_state(state)
        state.apply_gradients(ones)
    for name, p in want["params"].items():
        assert torch.equal(tree["params"][name], p)
    for name, mu in want["opt_state"][0]["mu"].items():
        assert torch.equal(tree["opt_state"][0]["mu"][name], mu)
    assert tree["step"] == 2
    for mod in (jrec, trec):
        with pytest.raises(ValueError, match="rollback|abort"):
            mod.RecoveryPolicy(mode="retry")


@pytest.mark.parametrize("scale", [0.1, 0.25, 1.0])
def test_damp_update_matches_jax(scale):
    rng = np.random.default_rng(0)
    old = {k: rng.normal(size=s).astype(np.float32)
           for k, s in (("a", (4, 3)), ("b", (7,)))}
    new = {k: v + rng.normal(size=v.shape).astype(np.float32)
           for k, v in old.items()}
    want = jrec.damp_update({k: jnp.asarray(v) for k, v in old.items()},
                            {k: jnp.asarray(v) for k, v in new.items()},
                            scale)
    got = trec.damp_update({k: torch.from_numpy(v) for k, v in old.items()},
                           {k: torch.from_numpy(v) for k, v in new.items()},
                           scale)
    for k in old:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)


def test_snapshot_and_poison_a_train_state():
    model, state = _toy_state()
    state.apply_gradients({n: torch.ones_like(p)
                           for n, p in state.params.items()})
    snap = trec.snapshot_state(state)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    assert trec.poison_state(state) is state
    assert all(torch.isnan(p).all() for p in state.params.values())
    assert torch.equal(model[1].running_var, snap["buffers"]["1.running_var"])
    state.load_state_dict(snap)
    assert state.step == 1 and all(torch.equal(state.params[n], p)
                                   for n, p in before.items())
    assert torch.equal(state.opt_state[0]["mu"]["0.weight"],
                       snap["opt_state"][0]["mu"]["0.weight"])


# ------------------------------------------------------ signals, preempt
class TestSignalChaining:
    """SIGUSR1 stands in for SIGTERM, as in the JAX tests: the same
    registry path, no risk of killing the test process."""

    def test_chain_then_graceful_owner(self):
        calls = []
        signal.signal(signal.SIGUSR1, lambda s, f: calls.append("prev"))
        sub_a = lambda s, f: calls.append("a")          # noqa: E731
        sub_g = lambda s, f: calls.append("graceful")   # noqa: E731
        try:
            assert signals.subscribe(signal.SIGUSR1, sub_a)
            assert signals.installed(signal.SIGUSR1)
            _deliver(signal.SIGUSR1)
            assert calls == ["a", "prev"]
            calls.clear()
            assert signals.subscribe(signal.SIGUSR1, sub_g, graceful=True)
            _deliver(signal.SIGUSR1)
            assert calls == ["a", "graceful"]
        finally:
            signals.unsubscribe(signal.SIGUSR1, sub_a)
            signals.unsubscribe(signal.SIGUSR1, sub_g)
        assert signals.subscribers(signal.SIGUSR1) == []

    def test_failing_subscriber_never_starves_the_rest(self):
        calls = []

        def bad(s, f):
            raise RuntimeError("boom")

        ok = lambda s, f: calls.append("ok")            # noqa: E731
        graceful = lambda s, f: None                    # noqa: E731
        for fn, g in ((bad, False), (ok, False), (graceful, True)):
            assert signals.subscribe(signal.SIGUSR1, fn, graceful=g)
        try:
            _deliver(signal.SIGUSR1)
            assert calls == ["ok"]
        finally:
            for fn in (bad, ok, graceful):
                signals.unsubscribe(signal.SIGUSR1, fn)


def test_guard_flushes_and_flags():
    flushed = []
    guard = preempt.PreemptionGuard(signums=(signal.SIGUSR2,))
    guard.add_flush(lambda: flushed.append(1))
    assert guard.install()
    try:
        before = len(flight.get_recorder().events("preempt_signal"))
        _deliver(signal.SIGUSR2)
        assert guard.requested() and guard.signum == signal.SIGUSR2
        assert flushed == [1]
        assert len(flight.get_recorder().events("preempt_signal")) == \
            before + 1
        _deliver(signal.SIGUSR2)          # double delivery: landing already
        assert flushed == [1]
    finally:
        guard.uninstall()
    assert signals.subscribers(signal.SIGUSR2) == []
    programmatic = preempt.PreemptionGuard(signums=())
    assert not programmatic.requested()
    programmatic.request()
    assert programmatic.requested()
    assert preempt.EXIT_PREEMPTED == 75
    assert preempt.agree_preempt_step(7) == 7    # no process group


def test_sigterm_dump_waits_for_the_step_boundary(tmp_path):
    """With a graceful owner on SIGTERM the flight hook only marks its
    dump pending; ``flush_pending`` writes it once."""
    path = str(tmp_path / "flightrec.json")
    flight.configure(path)
    guard = preempt.PreemptionGuard(signums=(signal.SIGTERM,))
    assert flight.install_signal_handler() and guard.install()
    try:
        _deliver(signal.SIGTERM)
        assert guard.requested() and not os.path.exists(path)
        assert flight.flush_pending() == path
        assert json.load(open(path))["reason"] == "sigterm"
        assert flight.flush_pending() is None
    finally:
        guard.uninstall()
        flight.get_recorder().path = None


# ------------------------------------------------------------- heartbeat
def test_heartbeat_records_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(thb.RUN_ID_VAR, "run-7")
    monkeypatch.setenv(thb.REPLICA_VAR, "2")
    docs = []
    for mod in (jhb, thb):
        beat = mod.Heartbeat(step=3)
        beat.touch("eval")
        assert (beat.step, beat.activity, beat.phase) == (3, 1, "eval")
        path = str(tmp_path / f"{mod.__name__}.json")
        writer = mod.HeartbeatWriter(path, beat, interval_s=0.05).start()
        deadline = time.monotonic() + 5.0
        while mod.read_heartbeat(path) is None and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert mod.read_heartbeat(path)["pid"] == os.getpid()
        beat.touch("step", step=9)
        writer.stop()                      # the final write: exit watermark
        doc = mod.read_heartbeat(path)
        doc.pop("time")
        docs.append(doc)
    assert docs[1] == docs[0] and docs[0]["step"] == 9
    assert thb.read_heartbeat(str(tmp_path / "missing.json")) is None
    torn = tmp_path / "torn.json"
    torn.write_text('{"step": 3, "activ')
    assert thb.read_heartbeat(str(torn)) is None
    assert thb.ENV_VAR == jhb.ENV_VAR == "DLTPU_HEARTBEAT"


# ---------------------------------------------------------------- strict
@pytest.mark.parametrize("value", [None, True, False, "", "0", "1", "true",
                                   "On", "none", "transfers", "nans",
                                   "transfers,nans", " Transfers , nans "])
def test_strict_resolve_matches_jax(value, monkeypatch):
    monkeypatch.setenv("DLTPU_STRICT", "nans")     # read when value is None
    assert strict.resolve(value) == jstrict.resolve(value)


@pytest.mark.parametrize("value", ["threads", "all", "nans,threads"])
def test_strict_threads_names_item_8(value):
    """The ``threads`` mode (item 8c): resolved as JAX resolves it, and
    ``maybe_enable_threads`` arms the sanitizer for it."""
    from deeplearning_tpu_torch.analysis import threadsan
    modes = strict.resolve(value)
    assert modes == jstrict.resolve(value) and "threads" in modes
    assert not threadsan.enabled()
    try:
        assert strict.maybe_enable_threads(modes)
        assert threadsan.enabled()
    finally:
        threadsan.disable()
        threadsan.reset()
    assert not strict.maybe_enable_threads(strict.resolve("nans"))
    assert not threadsan.enabled()
    with pytest.raises(ValueError, match="unknown strict mode"):
        strict.resolve("transfer")


def test_strict_guard_is_inert_on_the_cpu():
    assert not strict.guard_enforced()
    assert not strict.guard_enforced("host_to_device", device="cpu")
    with strict.strict_section(frozenset({"transfers"})):
        assert torch.ones(2).sum().item() == 2.0
    with pytest.raises(ValueError, match="kind"):
        strict.no_transfers("sideways")


def test_debug_nans_names_the_first_module_with_a_nan():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 2), torch.nn.Tanh())
    with torch.no_grad():
        model[2].weight[0, 0] = float("nan")
    x = torch.randn(3, 4)
    with strict.debug_nans(model=model):
        with pytest.raises(FloatingPointError, match=r"'2' \(Linear\)"):
            model(x)
    model(x)                                  # hooks removed on exit

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    class Poison(torch.nn.Module):
        def forward(self, x):
            return NanGrad.apply(x)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), Poison(),
                                torch.nn.Linear(8, 2))
    with strict.debug_nans(model=model):
        loss = model(x).sum()
        with pytest.raises(FloatingPointError,
                           match=r"gradient .* '0' \(Linear\)"):
            loss.backward()
    with strict.debug_nans():
        w = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(w).sum().backward()
