"""The port's thread sanitizer, lock graph and strict ``threads`` mode
(deeplearning_tpu_torch/analysis/{threadsan,concurrency,strict}.py) vs the
JAX package's (deeplearning_tpu/analysis/{threadsan,concurrency}.py), on
the CPU.

- JAX's ``TestThreadsan`` scenarios (tests/test_concurrency.py) run
  through both sanitizers: a proxied module, a seeded inversion, a
  release of an unheld lock, an RLock re-entry and a static seed joining
  the runtime check give the same outcome and the same ``status()`` and
  ``autopsy()`` keys (and values, lock sites apart).
- ``lock_order_graph`` over one source placed under both package names
  gives the same locks, edges and cycles up to the path prefix; the
  port's own tree has locks, spawn sites and no cycle.
- Every module of ``DEFAULT_MODULES`` builds its locks through its
  ``threading`` attribute, so ``enable()`` watches them.
- A CPU zoo's load-vs-evict race under ``DLTPU_STRICT=threads`` is
  lock-clean (JAX's tests/test_zoo_serving.py:425), and so is the serve
  CLI armed from the environment.
"""

import importlib
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from deeplearning_tpu.analysis import concurrency as jconc
from deeplearning_tpu.analysis import threadsan as jsan
from deeplearning_tpu_torch.analysis import concurrency as tconc
from deeplearning_tpu_torch.analysis import strict as tstrict
from deeplearning_tpu_torch.analysis import threadsan as tsan

SANITIZERS = {"jax": jsan, "port": tsan}


@pytest.fixture(params=sorted(SANITIZERS))
def san(request):
    """One armed-clean sanitizer; disarmed and reset afterwards, so the
    rest of the process sees raw threading."""
    mod = SANITIZERS[request.param]
    mod.reset()
    yield mod
    mod.disable()
    mod.reset()


@pytest.fixture
def both():
    for mod in SANITIZERS.values():
        mod.reset()
    yield SANITIZERS
    for mod in SANITIZERS.values():
        mod.disable()
        mod.reset()


# ------------------------------------- JAX's TestThreadsan, both modules
def test_proxy_patch_and_restore(san):
    fake = types.ModuleType("dltpu_fake_fleet")
    fake.threading = threading
    assert san.enable([fake], seed_static=False) == ["dltpu_fake_fleet"]
    lk = fake.threading.Lock()
    assert isinstance(lk, san.InstrumentedLock)
    assert fake.threading.current_thread() is threading.current_thread()
    san.disable()
    assert fake.threading is threading
    assert not san.enabled()


def test_single_thread_order_inversion_raises(san):
    a = san.InstrumentedLock()
    b = san.InstrumentedLock()
    with a:
        with b:
            pass
    with pytest.raises(san.LockOrderError) as exc:
        with b:
            with a:
                pass
    report = exc.value.report
    assert report["violation"]["kind"] == "lock-order-inversion"
    assert a.site in report["violation"]["cycle"]
    assert b.site in report["violation"]["cycle"]
    assert set(report) >= {"ring", "edges", "static_edges", "locks",
                           "violations", "held_here"}
    assert san.status()["violations"] == 1


def test_release_unheld_raises(san):
    a = san.InstrumentedLock()
    a._inner.acquire()             # held, never recorded
    with pytest.raises(san.LockOrderError, match="release-unheld"):
        a.release()


def test_rlock_reentry_is_not_an_edge(san):
    r = san.InstrumentedLock(reentrant=True)
    with r:
        with r:
            pass
    assert san.status()["runtime_edges"] == 0


def test_static_seed_joins_runtime_check(san):
    a = san.InstrumentedLock()
    b = san.InstrumentedLock()

    def meta(lock):
        path, line = lock.site.rsplit(":", 1)
        return {"path": path, "line": int(line), "name": "x"}

    n = san.seed_static_edges({
        "locks": {"LA": meta(a), "LB": meta(b)},
        "edges": [{"src": "LA", "dst": "LB", "path": "x.py", "line": 1,
                   "func": "f"}]})
    assert n == 1
    # the runtime never saw a -> b: the STATIC edge alone closes the cycle
    with pytest.raises(san.LockOrderError):
        with b:
            with a:
                pass


def _scenario(san):
    """One run of every outcome: edges, an RLock re-entry, a seeded
    inversion; returns (status, autopsy, violation kind)."""
    a = san.InstrumentedLock()
    b = san.InstrumentedLock()
    r = san.InstrumentedLock(reentrant=True)
    with r:
        with r:
            with a:
                pass
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
    except san.LockOrderError as exc:
        kind = exc.report["violation"]["kind"]
    return san.status(), san.autopsy(), kind


def test_status_and_autopsy_equal_jax(both):
    jst, jrep, jkind = _scenario(both["jax"])
    tst, trep, tkind = _scenario(both["port"])
    assert tkind == jkind == "lock-order-inversion"
    assert tst == jst
    assert set(trep) == set(jrep)
    assert len(trep["ring"]) == len(jrep["ring"])
    assert [ev["action"] for ev in trep["ring"]] == \
        [ev["action"] for ev in jrep["ring"]]
    assert set(trep["ring"][0]) == set(jrep["ring"][0])
    assert len(trep["edges"]) == len(jrep["edges"])
    # each site is "<path from the checkout root>:<line>" of this file
    assert all(s.startswith("tests/test_torch_threadsan.py:")
               for s in trep["locks"])
    assert trep["locks"] == jrep["locks"]
    assert both["port"].acquires() == 7


# ------------------------------------------------------- the lock graph
CYCLE_MODULE = """\
import threading

A = threading.Lock()
B = threading.Lock()


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv_lock = threading.RLock()

    def put(self):
        with self._lock:
            with self._cv_lock:
                pass

    def drain(self):
        self._cv_lock.acquire()
        with A:
            pass
        self._cv_lock.release()


def f():
    with A:
        with B:
            pass


def g():
    with B:
        with A:
            pass


def start():
    threading.Thread(target=f, daemon=True).start()
"""


def _strip(graph, prefix):
    """The graph with ``prefix`` taken off every path and lock id."""
    cut = lambda s: s.replace(prefix, "<pkg>")  # noqa: E731
    return {
        "locks": {cut(k): {**v, "path": cut(v["path"])}
                  for k, v in graph["locks"].items()},
        "edges": [{**e, "src": cut(e["src"]), "dst": cut(e["dst"]),
                   "path": cut(e["path"])} for e in graph["edges"]],
        "cycles": [[cut(n) for n in c] for c in graph["cycles"]],
        "spawn_sites": [{**s, "path": cut(s["path"])}
                        for s in graph["spawn_sites"]]}


def test_lock_order_graph_equals_jax(tmp_path):
    for pkg in ("deeplearning_tpu", "deeplearning_tpu_torch"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "pool.py").write_text(CYCLE_MODULE)
        (tmp_path / pkg / "plain.py").write_text("X = 1\n")
    jg = jconc.lock_order_graph(str(tmp_path), ("deeplearning_tpu",))
    tg = tconc.lock_order_graph(str(tmp_path))     # the port's scan
    assert _strip(tg, "deeplearning_tpu_torch") == \
        _strip(jg, "deeplearning_tpu")
    assert len(tg["locks"]) == 4 and len(tg["edges"]) == 4
    assert tg["cycles"] == [["deeplearning_tpu_torch/pool.py::A",
                             "deeplearning_tpu_torch/pool.py::B"]]
    assert len(tg["spawn_sites"]) == 1


def test_port_tree_has_locks_spawns_and_no_cycle():
    g = tconc.lock_order_graph()
    assert g["cycles"] == []
    assert len(g["locks"]) >= 20 and len(g["spawn_sites"]) >= 5
    assert all(meta["path"].startswith("deeplearning_tpu_torch/")
               for meta in g["locks"].values())
    paths = {meta["path"] for meta in g["locks"].values()}
    assert "deeplearning_tpu_torch/serve/zoo.py" in paths


def test_default_modules_build_their_locks_through_threading():
    """A ``from threading import Lock`` would stay raw under enable()."""
    import ast
    assert len(tsan.DEFAULT_MODULES) == len(jsan.DEFAULT_MODULES) - 1
    assert {m.replace("deeplearning_tpu_torch.", "")
            for m in tsan.DEFAULT_MODULES} == \
        {m.replace("deeplearning_tpu.", "")
         for m in jsan.DEFAULT_MODULES} - {"obs.fleet"}
    for name in tsan.DEFAULT_MODULES:
        mod = importlib.import_module(name)
        assert mod.threading is threading
        with open(mod.__file__) as f:
            al = tconc._ThreadingAliases(ast.walk(ast.parse(f.read())))
        assert al.lock_ctors == set() and "threading" in al.modules


# ------------------------------------------------- strict threads mode
def test_enable_seeds_the_static_graph_and_watches_the_fleet(both):
    san = both["port"]
    from deeplearning_tpu_torch.serve import zoo as tzoo
    patched = san.enable()
    assert "deeplearning_tpu_torch.serve.zoo" in patched
    zoo = tzoo.ModelZoo()
    assert isinstance(zoo._lock, san.InstrumentedLock)
    assert zoo._lock.site.startswith("deeplearning_tpu_torch/serve/zoo.py:")
    st = san.status()
    assert st["enabled"] and st["modules_patched"] == len(patched)
    assert st["static_edges"] == len(tconc.lock_order_graph()["edges"])


def test_enable_lets_a_failed_static_seed_raise(both, monkeypatch):
    """By decision: JAX's enable() swallows it."""
    def broken(*a, **k):
        raise RuntimeError("static graph unavailable")
    monkeypatch.setattr(tconc, "lock_order_graph", broken)
    with pytest.raises(RuntimeError, match="static graph"):
        both["port"].enable([types.ModuleType("m")])
    monkeypatch.setattr(jconc, "lock_order_graph", broken)
    both["jax"].enable([types.ModuleType("m")])


class _FakeEngine:
    """Engine-shaped stand-in for the zoo (tests/test_torch_zoo.py's)."""

    def __init__(self, nbytes=400):
        self.buckets = (1, 4)
        self.image_size = 8
        self.trace_count = self.compile_count = 2
        self._nbytes = nbytes
        self.name, self.task = "fake", "classify"

    def variables_nbytes(self):
        return self._nbytes

    def bucket_for(self, n):
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def pad_to_bucket(self, images, bucket):
        pad = np.zeros((bucket - images.shape[0],) + images.shape[1:],
                       images.dtype)
        return np.concatenate([images, pad], axis=0)

    def run(self, bucket, padded):
        return torch.from_numpy(padded.sum(axis=(1, 2, 3)))

    def stats(self):
        return {"model": self.name, "trace_count": self.trace_count}


def _pressure_zoo(limit=1000, alert=0.9):
    """JAX's pressure_zoo: the stubbed reading sums the resident bytes."""
    from deeplearning_tpu_torch.serve import ModelZoo
    holder = {}

    def snap():
        zoo = holder["zoo"]
        in_use = sum(zoo._resident_bytes.get(a, 0) for a in zoo._engines)
        return {"devices": [{"bytes_limit": limit, "bytes_in_use": in_use,
                             "usage_frac": in_use / limit}]}

    zoo = ModelZoo(alert_frac=alert, hbm_snapshot_fn=snap)
    holder["zoo"] = zoo
    for alias in ("a", "b", "c"):
        zoo.register(alias, engine_factory=lambda: _FakeEngine(nbytes=400),
                     est_bytes=400, batch_buckets=(1, 4), image_size=8)
    return zoo


def test_zoo_load_vs_evict_race_is_lock_clean(both, monkeypatch):
    """JAX's TestZooRaceUnderThreadSanitizer: admin load against pressure
    eviction on one alias with DLTPU_STRICT=threads, then 8 threads
    submitting through the batcher."""
    from deeplearning_tpu_torch.serve import MicroBatcher
    san = both["port"]
    monkeypatch.setenv("DLTPU_STRICT", "threads")
    assert tstrict.maybe_enable_threads(tstrict.resolve())
    zoo = _pressure_zoo()
    errors = []
    deadline = time.monotonic() + 1.0

    def hammer(step):
        while time.monotonic() < deadline:
            try:
                step()
            except san.LockOrderError as exc:
                errors.append(exc)
                return

    def admin():
        zoo.load("a", wait=True, timeout_s=5.0)
        zoo.touch("a")
        zoo.engine("a")

    def pressure():
        zoo.load("b", wait=True, timeout_s=5.0)
        zoo.evict("a")
        zoo.enforce_pressure()

    workers = [threading.Thread(target=hammer, args=(fn,), daemon=True)
               for fn in (admin, pressure)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(15.0)
    assert not any(t.is_alive() for t in workers), "race workers wedged"
    assert errors == [], errors[0].report
    for alias in ("a", "b"):
        if zoo.state(alias) == "warm":
            assert zoo.engine(alias) is not None
        else:
            assert zoo.engine(alias) is None

    img = np.ones((8, 8, 3), np.float32)
    answers = []
    for alias in ("a", "b"):       # 800 of 1 000 bytes: under the alert
        assert zoo.load(alias, wait=True, timeout_s=5.0) == "warm"
    with MicroBatcher(zoo=zoo, max_wait_ms=1.0) as mb:
        def client(i):
            for _ in range(4):
                answers.append(mb.submit(img, model="ab"[i % 2])
                               .result(timeout=30.0))
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(30.0)
    assert len(answers) == 32 and all(float(a) == 192.0 for a in answers)
    st = san.status()
    assert st["violations"] == 0 and st["locks_instrumented"] > 0
    assert st["runtime_edges"] >= 0 and san.acquires() > 0


def test_serve_cli_arms_the_sanitizer_from_the_environment(
        both, monkeypatch, tmp_path, capsys):
    """DLTPU_STRICT=threads: the serve CLI enables the sanitizer before
    it builds the engine and the batcher, and serves lock-clean."""
    from deeplearning_tpu_torch.serve import __main__ as serve_cli
    monkeypatch.setenv("DLTPU_STRICT", "threads")
    img = tmp_path / "img.npy"
    np.save(img, np.zeros((28, 28, 3), np.float32))
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO(f"{img}\n"))
    assert serve_cli.main(["--model", "mnist_cnn", "--num-classes", "10",
                           "--size", "28", "--buckets", "1",
                           "--device", "cpu"]) == 0
    st = both["port"].status()
    assert st["enabled"] and st["violations"] == 0
    assert st["locks_instrumented"] > 0 and both["port"].acquires() > 0
    assert '"top' in capsys.readouterr().out
