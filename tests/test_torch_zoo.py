"""The port's serving zoo (deeplearning_tpu_torch/serve/{zoo,batcher,
health,__main__}, parallel/collectives, obs/{metrics,xla}) vs the JAX
package, on the CPU at a tiny size.

- The block quantizers: payloads and scales bit-equal to JAX's on seeded
  arrays (an all-zero block, a padded length, magnitudes from 1e-8 to 1e8).
- int8 residency: a tiny ViT and a RetinaNet of one bottleneck block a
  stage (its 2 048-channel BatchNorm statistics are quantized leaves), on
  the JAX engine's own quantized tree: the dequantized state dict
  equals ``from_flax_params`` of JAX's dequantized tree bit for bit,
  ``variables_nbytes()`` equals the JAX engine's, and the outputs are within
  1e-4 of the JAX int8 engine's.
- The zoo policy scenarios of tests/test_zoo_serving.py, each run through
  JAX's ``ModelZoo`` and the port's with the same fake engines and stubbed
  snapshots: equal transcripts (``stats()`` less timings, ``Rejected``
  reasons, ``zoo_health`` codes and payloads).
- The brownout / standby / drain sequences, the same metric operations'
  Prometheus text on both registries, ``parse_zoo_spec`` / ``build_zoo``
  against ``tools/serve.py``'s, the quarantine counter.
- A three-tenant e2e (tiny ViT float32, tiny ViT int8, tiny Swin) through
  ``MicroBatcher(zoo=...)``: answers bit-equal to solo port engines and
  within 1e-4 of JAX's, trace counts unchanged, evict then reload.
- The HTTP zoo routes with ``--device cpu``.
"""

import functools
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core.registry import MODELS as JMODELS
from deeplearning_tpu.data import quarantine as jquarantine
from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.obs import flight as jflight
from deeplearning_tpu.obs import metrics as jmetrics
from deeplearning_tpu.parallel import collectives as jcoll
from deeplearning_tpu.serve import InferenceEngine as JaxEngine
from deeplearning_tpu.serve import engine as jengine_mod
from deeplearning_tpu import serve as jserve
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch import serve as tserve
from deeplearning_tpu_torch.core.registry import MODELS as TMODELS
from deeplearning_tpu_torch.data import quarantine as tquarantine
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.obs import flight as tflight
from deeplearning_tpu_torch.obs import metrics as tmetrics
from deeplearning_tpu_torch.obs import xla as txla
from deeplearning_tpu_torch.ops.attention import get_attn_fn
from deeplearning_tpu_torch.parallel import collectives as tcoll
from deeplearning_tpu_torch.serve import __main__ as serve_cli
from deeplearning_tpu_torch.utils.convert import (from_flax_params,
                                                  variable_names)

from test_torch_detection import seeded_tree
from test_torch_swin import _jax_weights
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import serve as jserve_cli  # noqa: E402  (tools/serve.py)

TINY = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
            depth=2, num_heads=4)


@pytest.fixture(autouse=True)
def _clean_obs_globals():
    """Both packages' zoos bump their process-wide registry and flight
    ring: keep every test hermetic."""
    def reset():
        for metrics, flight in ((jmetrics, jflight), (tmetrics, tflight)):
            metrics.disable()
            rec = flight.get_recorder()
            rec.clear()
            rec.path = None
            rec.config = None
    reset()
    yield
    reset()


# ------------------------------------------------------- block quantizers
@pytest.mark.parametrize("n,scale", [(1000, 1.0), (256 * 37, 1e-8),
                                     (5000, 1e8), (300, 1e-3)])
def test_block_quantizers_equal_jax(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    x[:256] = 0.0                                   # an all-zero block
    mixed = x[256:512]                              # mixed magnitudes
    mixed *= 10.0 ** rng.integers(-6, 6, mixed.size)
    jx, jpad = jcoll._pad_to(jnp.asarray(x), 256)
    tx, tpad = tcoll._pad_to(torch.from_numpy(x), 256)
    assert jpad == tpad == (-n) % 256
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jq, js = jcoll._quantize_blocks(jx.reshape(-1, 256))
    tq, ts = tcoll._quantize_blocks(tx.view(-1, 256))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcoll._dequantize_blocks(tq, ts).numpy(),
        np.asarray(jcoll._dequantize_blocks(jq, js)))


# ------------------------------------------------------- int8 residency
@functools.lru_cache(maxsize=None)
def _int8_case(kind):
    """(JAX model, flax variables, port model builder, image size,
    buckets, engine kwargs) of one int8 parity case."""
    if kind == "vit":
        jmodel = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
        variables = jax.tree.map(np.asarray, jmodel.init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
        return (jmodel, variables,
                lambda: tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                               attn_fn=get_attn_fn(
                                                   "flash_hb")),
                32, (1, 4), {})
    # one bottleneck block a stage: layer4's BatchNorm has 2 048 channels
    name, kw = "retinanet_resnet50_fpn", dict(backbone_sizes=(1, 1, 1, 1),
                                              fpn_channels=32)
    jmodel = JMODELS.build(name, num_classes=3, dtype=jnp.float32, **kw)
    variables = seeded_tree(jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.key(0),
        jnp.zeros((1, 64, 64, 3))), seed=3)
    return (jmodel, variables,
            lambda: TMODELS.build(name, num_classes=3, dtype=torch.float32,
                                  **kw),
            64, (2,), {"num_classes": 3})


@pytest.mark.parametrize("kind", ["vit", "retinanet"])
def test_int8_engine_matches_jax(kind):
    jmodel, variables, build, size, buckets, kw = _int8_case(kind)
    model = build()
    port = tserve.InferenceEngine(kind, model=model, variables=variables,
                                  image_size=size, batch_buckets=buckets,
                                  device="cpu", weight_quant="int8", **kw)
    # the caller's module keeps its float32 weights
    assert all(t.numel() for t in model.state_dict().values())
    jeng = JaxEngine(kind, model=jmodel, variables=variables,
                     image_size=size, batch_buckets=buckets,
                     use_compile_cache=False, weight_quant="int8", **kw)
    # the JAX engine's own quantized tree, dequantized
    want = from_flax_params(jax.tree.map(
        np.asarray, jengine_mod._dequantize_variables(
            jeng._variables, jeng._quant_meta, jeng._quant_treedef)),
        like=build())
    got = port.dequantized_state_dict()
    assert set(got) == set(want) == set(variable_names(build()))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if kind == "retinanet":
        # BatchNorm statistics past 1 024 elements are quantized leaves
        exact = from_flax_params(variables, like=build())
        assert any(n.endswith("running_var") and got[n].numel() >= 1024
                   and not torch.equal(got[n], exact[n]) for n in got)
    assert port.variables_nbytes() == jeng.variables_nbytes()
    assert port.stats()["weight_quant"] == "int8"
    # int8 residency keeps only payloads and scales of the large leaves
    fp32 = tserve.InferenceEngine(kind, model=build(), variables=variables,
                                  image_size=size, batch_buckets=buckets,
                                  device="cpu", precompile=False, **kw)
    assert fp32.variables_nbytes() > 3 * port.variables_nbytes()
    x = np.random.default_rng(5).normal(
        size=(3, size, size, 3)).astype(np.float32)
    out, ref = port.infer(x), jeng.infer(x)
    if kind == "vit":
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    else:
        for key in ("labels", "valid"):
            np.testing.assert_array_equal(out[key], np.asarray(ref[key]))
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(out[key], np.asarray(ref[key]),
                                       atol=1e-4, rtol=1e-4)
    assert port.trace_count == port.compile_count == len(buckets)


# ------------------------------------------------------- zoo policy
class FakeEngine:
    """Engine-shaped stand-in for both packages' zoos and batchers (their
    batchers both take a CPU tensor as the batch output)."""

    def __init__(self, buckets=(1, 4), image_size=8, nbytes=400,
                 scale=1.0, delay_s=0.0):
        self.buckets = tuple(sorted(buckets))
        self.image_size = image_size
        self.trace_count = len(self.buckets)
        self.compile_count = len(self.buckets)
        self.scale = scale
        self.delay_s = delay_s
        self._nbytes = nbytes
        self.calls = []
        self.name = "fake"
        self.task = "classify"

    def variables_nbytes(self):
        return self._nbytes

    def bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def pad_to_bucket(self, images, bucket):
        if images.shape[0] == bucket:
            return images
        pad = np.zeros((bucket - images.shape[0],) + images.shape[1:],
                       images.dtype)
        return np.concatenate([images, pad], axis=0)

    def run(self, bucket, padded):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.calls.append(bucket)
        return torch.from_numpy(self.scale * padded.sum(axis=(1, 2, 3)))

    def stats(self):
        return {"model": self.name, "trace_count": self.trace_count}


def _img(size=8, seed=0):
    return np.random.default_rng(seed).normal(
        size=(size, size, 3)).astype(np.float32)


_TIMINGS = ("idle_s", "load_seconds")


def _stats(zoo):
    st = zoo.stats()
    for row in st["models"].values():
        for key in _TIMINGS:
            row.pop(key, None)
    return st


def _health(pkg, zoo, batcher=None):
    code, payload = pkg.zoo_health(zoo, batcher)
    for row in payload["models"].values():
        for key in _TIMINGS + ("e2e_ms_p99",):
            row.pop(key, None)
    return code, payload


def _pressure_zoo(pkg, limit=1000, alert=0.9, **zoo_kwargs):
    """tests/test_zoo_serving.py's zoo: the stubbed reading is the sum of
    the resident engines' bytes."""
    holder = {}

    def snap():
        zoo = holder["zoo"]
        in_use = sum(zoo._resident_bytes.get(a, 0) for a in zoo._engines)
        return {"devices": [{"bytes_limit": limit, "bytes_in_use": in_use,
                             "usage_frac": in_use / limit}]}

    zoo = pkg.ModelZoo(alert_frac=alert, hbm_snapshot_fn=snap, **zoo_kwargs)
    holder["zoo"] = zoo
    for alias in ("a", "b", "c"):
        zoo.register(alias, engine_factory=lambda: FakeEngine(nbytes=400),
                     est_bytes=400, batch_buckets=(1, 4), image_size=8)
    return zoo


def _settle(mb, batches):
    """Wait for the dispatch loop to finish ``batches`` batches: a batch's
    telemetry lands just after its answers."""
    deadline = time.monotonic() + 10.0
    while mb.dispatched < batches and time.monotonic() < deadline:
        time.sleep(0.01)


def _rejected(pkg, fn):
    try:
        fn()
    except pkg.Rejected as r:
        return ("rejected", r.reason, r.model, r.retry_after_s > 0)
    return ("admitted",)


def scenario_registry(pkg):
    out = []
    zoo = pkg.ModelZoo()
    zoo.register("a", engine=FakeEngine())
    zoo.register("b", engine_factory=FakeEngine, batch_buckets=(1, 4),
                 image_size=8)
    out += [zoo.state("a"), zoo.engine("b") is None, zoo.models()]
    with pytest.raises(ValueError):
        zoo.register("a", engine=FakeEngine())
    with pytest.raises(KeyError):
        zoo.state("nope")
    out.append(_stats(zoo))

    def boom():
        raise RuntimeError("no such checkpoint")
    zoo.register("bad", engine_factory=boom, batch_buckets=(1,),
                 image_size=8)
    out += [zoo.load("bad", wait=True), zoo.load_errors["bad"],
            zoo.request("bad")]
    zoo.load("bad", wait=True)
    out.append(_stats(zoo))
    out.append(_health(pkg, zoo))
    return out


def scenario_lru_under_pressure(pkg):
    zoo = _pressure_zoo(pkg)
    out = [zoo.load(a, wait=True) for a in ("a", "b", "c")]
    return out + [_stats(zoo), _health(pkg, zoo)]


def scenario_touch_redirects_victim(pkg):
    zoo = _pressure_zoo(pkg)
    zoo.load("a", wait=True)
    zoo.load("b", wait=True)
    zoo.touch("a")
    zoo.load("c", wait=True)
    return [_stats(zoo)]


def scenario_nothing_evictable(pkg):
    zoo = _pressure_zoo(pkg)
    zoo.load("b", wait=True)
    zoo.load("c", wait=True)
    zoo.mark_dispatch("b", +1)
    zoo.mark_dispatch("c", +1)
    out = [_rejected(pkg, lambda: zoo.request("a")), _stats(zoo)]
    zoo.mark_dispatch("b", -1)
    zoo.mark_dispatch("c", -1)
    return out + [zoo.load("a", wait=True), _stats(zoo)]


def scenario_max_resident(pkg):
    zoo = _pressure_zoo(pkg, limit=10 ** 9, max_resident=1)
    zoo.load("a", wait=True)
    zoo.load("b", wait=True)
    zoo.mark_dispatch("b", +1)
    return [_rejected(pkg, lambda: zoo.request("c")), _stats(zoo)]


def scenario_enforce_pressure(pkg):
    zoo = _pressure_zoo(pkg, alert=0.5)
    zoo._alert_frac = 2.0              # bypass the load-time gate
    zoo.load("a", wait=True)
    zoo.load("b", wait=True)
    zoo._alert_frac = 0.5
    return [zoo.enforce_pressure(), _stats(zoo)]


def scenario_fresh_reload(pkg):
    built = []

    def make():
        eng = FakeEngine(nbytes=100 + 10 * len(built))
        built.append(eng)
        return eng

    zoo = pkg.ModelZoo()
    zoo.register("m", engine_factory=make, batch_buckets=(1, 4),
                 image_size=8)
    zoo.load("m", wait=True)
    first = zoo.engine("m")
    out = [zoo.evict("m"), zoo.state("m"), zoo.evict("m"),
           zoo.request("m"), zoo.load("m", wait=True)]
    return out + [zoo.engine("m") is not first, len(built), _stats(zoo)]


def scenario_tenant_isolation(pkg):
    ta = pkg.TenantAdmission()
    slow = ta.configure("slow", (1, 4), max_queue=8)
    fast = ta.configure("fast", (1, 4), max_queue=8)
    slow.note_drained(10, 1.0)
    fast.note_drained(1000, 1.0)
    out = [slow.retry_after_s(20), fast.retry_after_s(20),
           ta.for_model("slow") is slow]
    zoo = pkg.ModelZoo()
    zoo.register("slow", engine=FakeEngine(delay_s=0.05), max_queue=2)
    zoo.register("fast", engine=FakeEngine(scale=2.0))
    frame = _img()
    with pkg.MicroBatcher(zoo=zoo, max_wait_ms=1.0) as mb:
        verdict = None
        for _ in range(64):            # saturate slow's queue of 2
            verdict = _rejected(pkg, lambda: mb.submit(
                frame, model="slow", timeout_s=30.0))
            if verdict[0] == "rejected":
                break
        out.append(verdict)
        answers = [float(mb.submit(frame, model="fast").result(10.0))
                   for _ in range(4)]
        out.append(np.allclose(answers, 2.0 * frame.sum(), rtol=1e-5))
        out.append(mb.lane_telemetry("fast").snapshot()["rejected"])
    return out


def scenario_unknown_model(pkg):
    zoo = pkg.ModelZoo()
    zoo.register("a", engine=FakeEngine())
    with pkg.MicroBatcher(zoo=zoo) as mb:
        with pytest.raises(KeyError):
            mb.submit(_img(), model="ghost")
        return [mb.lane_depth("ghost"), mb.lane_telemetry("ghost")]


def scenario_health_states(pkg):
    zoo = pkg.ModelZoo()
    zoo.register("warmed", engine=FakeEngine())
    zoo.register("cold", engine_factory=FakeEngine, batch_buckets=(1,),
                 image_size=8)
    out = [_health(pkg, zoo)]
    zoo._state["cold"] = "loading"
    out.append(_health(pkg, zoo))
    zoo._state["cold"] = "registered"
    with pkg.MicroBatcher(zoo=zoo, standby=True) as mb:
        out.append(_health(pkg, zoo, mb))
        mb.promote()
        mb.submit(_img(), model="warmed").result(10.0)
        _settle(mb, 1)
        out.append(_health(pkg, zoo, mb)[0])
        mb.drain()
        out.append(_health(pkg, zoo, mb))
    return out


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_registry, scenario_lru_under_pressure,
    scenario_touch_redirects_victim, scenario_nothing_evictable,
    scenario_max_resident, scenario_enforce_pressure,
    scenario_fresh_reload, scenario_tenant_isolation,
    scenario_unknown_model, scenario_health_states)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_zoo_scenario_equals_jax(name):
    want = SCENARIOS[name](jserve)
    got = SCENARIOS[name](tserve)
    assert got == want


def scenario_brownout_standby_drain(pkg):
    zoo = pkg.ModelZoo()
    eng = FakeEngine(buckets=(1, 2, 8))
    zoo.register("a", engine=eng)
    zoo.register("b", engine=FakeEngine())
    frame = _img()
    out = []
    with pkg.MicroBatcher(zoo=zoo, max_wait_ms=0.0, standby=True) as mb:
        out += [mb.standby, _rejected(pkg, lambda: mb.submit(frame,
                                                              model="a"))]
        out += [mb.promote(), mb.promote(), mb.standby]
        out += [mb.set_brownout("a", 1), mb.brownout_step("a"),
                mb.brownout_step("b")]
        mb.submit(frame, model="a").result(10.0)
        out.append(list(eng.calls))       # step 1: the largest bucket
        out += [mb.set_brownout("a", 7), mb.brownout_step("a")]
        out.append([_rejected(pkg, lambda: mb.submit(frame, model="a"))
                    for _ in range(8)])   # step 3: one in four shed
        out += [mb.set_brownout("a", 0), mb.brownout_step("a"),
                mb.set_brownout("a", -2)]
        out.append([_rejected(pkg, lambda: mb.submit(frame, model="a"))
                    for _ in range(4)])
        mb.drain()
        out += [mb.draining,
                _rejected(pkg, lambda: mb.submit(frame, model="b"))]
        deadline = time.monotonic() + 10.0
        while not mb.drained and time.monotonic() < deadline:
            time.sleep(0.01)
        out.append(mb.drained)
    return out


def test_brownout_standby_and_drain_give_jax_reasons():
    assert scenario_brownout_standby_drain(tserve) == \
        scenario_brownout_standby_drain(jserve)


def test_a_freed_byte_is_counted_once():
    """The reading falls by a victim's bytes when it is evicted (the
    card's own reading does, since an eviction empties the engine's
    pool). With two idle tenants and a load that fits only once both are
    gone, the zoo must evict both: subtracting the victim's bytes from a
    reading that already dropped would admit the load after one."""
    holder = {}

    def snap():
        zoo = holder["zoo"]
        in_use = 100 + sum(zoo._resident_bytes.get(a, 0)
                           for a in zoo._engines)
        return {"devices": [{"bytes_limit": 1000, "bytes_in_use": in_use,
                             "usage_frac": in_use / 1000}]}

    zoo = tserve.ModelZoo(alert_frac=0.8, hbm_snapshot_fn=snap)
    holder["zoo"] = zoo
    for alias, nbytes in (("a", 300), ("b", 300), ("c", 450)):
        zoo.register(alias,
                     engine_factory=lambda n=nbytes: FakeEngine(nbytes=n),
                     est_bytes=nbytes, batch_buckets=(1, 4), image_size=8)
    zoo.load("a", wait=True)
    zoo.load("b", wait=True)
    # 0.1 + 0.3 + 0.3 in use; c projects 0.7 + 0.45, then 0.4 + 0.45
    # after one eviction (still >= 0.8), and 0.1 + 0.45 after both
    zoo.load("c", wait=True)
    assert zoo.evictions == 2
    assert [zoo.state(a) for a in ("a", "b", "c")] == [
        "evicted", "evicted", "warm"]


def test_demote_residency_flips_the_spec_and_evicts():
    out = {}
    for key, pkg in (("jax", jserve), ("port", tserve)):
        zoo = pkg.ModelZoo()
        zoo.register("m", engine_factory=FakeEngine, batch_buckets=(1, 4),
                     image_size=8)
        zoo.load("m", wait=True)
        out[key] = [zoo.demote_residency("m"), zoo.state("m"),
                    zoo.demote_residency("m"),
                    zoo.demote_residency("ghost"), _stats(zoo)]
    assert out["port"] == out["jax"]
    assert out["port"][:2] == [True, "evicted"]


# ------------------------------------------------------- metrics registry
def _metric_ops(metrics):
    reg = metrics.enable()
    reg.counter("dltpu_a_total", "a counter").inc(3)
    reg.counter("dltpu_a_total", labels={"model": "x"}).inc()
    reg.counter("dltpu_b_total").set_total(5)
    reg.counter("dltpu_b_total").set_total(2)     # never backwards
    reg.gauge("dltpu_g", "a gauge", labels={"model": 'q"u\\o'}).set(1.5)
    reg.gauge("dltpu_g", labels={"model": "y"}).set(float("inf"))
    hist = reg.histogram("dltpu_ms", "a histogram", buckets=(1.0, 10.0))
    for v in (0.5, 3.0, 30.0, 10.0):
        hist.observe(v)
    metrics.inc("dltpu_pushed_total", 2)
    metrics.set_gauge("dltpu_pushed", 7.0)
    metrics.observe("dltpu_pushed_ms", 4.0)
    reg.register_collector(lambda r: r.gauge("dltpu_pulled").set(9.0))
    reg.register_collector(lambda r: 1 / 0)
    with pytest.raises(TypeError):
        reg.gauge("dltpu_a_total")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    text = reg.prometheus_text()
    snap = reg.snapshot()
    snap.pop("time")
    metrics.disable()
    return text, snap


def test_metrics_text_equals_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DLTPU_RUN_ID", "run7")
    monkeypatch.setenv("DLTPU_REPLICA", "2")
    got, want = _metric_ops(tmetrics), _metric_ops(jmetrics)
    assert got == want
    assert 'dltpu_replica_info{replica="2",run_id="run7"} 1.0' in got[0]
    assert got[1]["collect_errors"] == 2      # the text's and the snapshot's
    path = str(tmp_path / "ep.json")
    for metrics in (tmetrics, jmetrics):
        assert metrics.write_endpoint("http://h:1", "serve", path) == path
        doc = metrics.read_endpoint(path)
        assert doc["url"] == "http://h:1" and doc["run_id"] == "run7"
    assert tmetrics.read_endpoint(str(tmp_path / "none.json")) is None


def test_metrics_server_and_disabled_helpers():
    tmetrics.inc("dltpu_x_total")            # disabled: a no-op
    assert tmetrics.get_registry() is None
    reg = tmetrics.enable()
    assert tmetrics.enable() is reg
    tmetrics.inc("dltpu_x_total")
    with tmetrics.MetricsServer(
            reg, port=0, healthz_fn=lambda: (200, {"status": "ok"})) as srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert "dltpu_x_total 1.0" in r.read().decode()
        assert _http(srv.url + "/healthz") == (200, {"status": "ok"})
        assert _http(srv.url + "/metrics.json")[1]["metrics"][
            "dltpu_x_total"]["value"] == 1.0
        assert _http(srv.url + "/nope")[0] == 404


def test_zoo_metrics_collector_mirrors_jax():
    """The same traffic through both CLIs' collectors: the same counters,
    zoo gauges and per-model series (the timing gauges aside)."""
    def run(pkg, metrics, cli):
        zoo = pkg.ModelZoo()
        zoo.register("a", engine=FakeEngine())
        zoo.register("b", engine=FakeEngine(scale=2.0))
        zoo.register("c", engine_factory=FakeEngine, batch_buckets=(1, 4),
                     image_size=8)
        reg = metrics.enable()
        with pkg.MicroBatcher(zoo=zoo, max_wait_ms=0.0) as mb:
            reg.register_collector(cli.make_metrics_collector(mb))
            for alias in ("a", "a", "a", "b"):
                mb.submit(_img(), model=alias).result(10.0)
            # the last batch's telemetry lands after its answer
            _settle(mb, 4)
            mb.set_brownout("b", 1)
            text = reg.prometheus_text()
        metrics.disable()
        timing = ("_per_s", "_ms_", "window_s", "occupancy", "depth_mean")
        return sorted(line for line in text.splitlines()
                      if not any(t in line for t in timing))
    got = run(tserve, tmetrics, serve_cli)
    assert got == run(jserve, jmetrics, jserve_cli)
    assert 'dltpu_serve_requests_total{model="a"} 3.0' in got
    assert 'dltpu_zoo_model_warm{model="c"} 0.0' in got
    assert "dltpu_zoo_resident 2.0" in got


def test_quarantine_counter_rises_as_jax(tmp_path):
    counts = []
    for metrics, mod in ((jmetrics, jquarantine), (tmetrics, tquarantine)):
        reg = metrics.enable()
        log = mod.QuarantineLog(str(tmp_path / f"{id(mod)}.jsonl"),
                                max_poisoned_frac=1.0)
        for i in range(3):
            log.record(i, ValueError("bad"))
        counts.append(reg.counter("dltpu_quarantine_total").value)
        metrics.disable()
    assert counts == [3.0, 3.0]


def test_hbm_snapshot_on_the_cpu_reports_no_pressure():
    snap = txla.hbm_snapshot(alert_frac=0.5)
    assert [d.get("bytes_limit") for d in snap["devices"]] == [None]
    zoo = tserve.ModelZoo()
    assert zoo.hbm_pressure()["usage_frac"] is None
    wm = txla.HbmWatermark(interval_s=0.01).start()
    time.sleep(0.05)
    wm.stop()
    assert wm.watermark()["hbm_samples"] >= 1


# ------------------------------------------------------- CLI spec
def _cli_args(extra=()):
    return serve_cli.build_parser().parse_args(
        ["--zoo", "{}", "--http", "0", "--device", "cpu", *extra])


def test_parse_zoo_spec_and_build_zoo_agree_with_tools_serve(tmp_path):
    spec = {"digits": {"model": "vit_micro_patch4_56", "buckets": [1, 2],
                       "weight_quant": "int8", "max_queue": 7,
                       "timeout_s": 3.0, "est_bytes": 1234,
                       "shed_threshold": 2},
            "plain": {"image_size": 56}}
    path = tmp_path / "zoo.json"
    path.write_text(json.dumps(spec))
    for raw in (json.dumps(spec), f"@{path}"):
        assert serve_cli.parse_zoo_spec(raw) == \
            jserve_cli.parse_zoo_spec(raw) == spec
    for bad in ("[]", "{}"):
        for parse in (serve_cli.parse_zoo_spec, jserve_cli.parse_zoo_spec):
            with pytest.raises(ValueError):
                parse(bad)
    import argparse
    jargs = argparse.Namespace(hbm_alert_frac=0.7, max_resident=2,
                               buckets="1,8", max_queue=256,
                               timeout_s=30.0)
    targs = _cli_args(["--hbm-alert-frac", "0.7", "--max-resident", "2",
                       "--buckets", "1,8"])
    jzoo, tzoo = jserve_cli.build_zoo(spec, jargs), serve_cli.build_zoo(
        spec, targs)
    assert _stats(tzoo) == _stats(jzoo)
    assert (tzoo.max_resident, tzoo.alert_frac()) == (2, 0.7)
    plain = tzoo.spec("plain")
    assert plain.model_name == "plain" and plain.buckets == (1, 8)
    assert plain.engine_kwargs["device"] == "cpu"
    assert tzoo.spec("digits").est_bytes == 1234


def test_cli_refuses_zoo_without_http_and_both_modes(capsys):
    for argv in (["--zoo", "{}"], ["--model", "m", "--zoo", "{}", "--http",
                                   "0"], []):
        with pytest.raises(SystemExit):
            serve_cli.main(argv)


# ------------------------------------------------------- three-tenant e2e
@functools.lru_cache(maxsize=None)
def _tenants():
    """JAX variables and reference probabilities of the three tenants:
    a tiny ViT (float32 and int8 residency) and the micro Swin."""
    rng = np.random.default_rng(12)
    jv = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
    vit_vars = jax.tree.map(np.asarray, jv.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    js = JMODELS.build("swin_micro_patch2_window7", num_classes=10,
                       dtype=jnp.float32)
    swin_vars = _jax_weights(js, 28)
    q8 = jax.tree.map(np.asarray, jengine_mod._dequantize_variables(
        *jengine_mod._quantize_variables(vit_vars)))
    images = {"vit": rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
              "swin": rng.normal(size=(6, 28, 28, 3)).astype(np.float32)}

    def probs(model, variables, x):
        return np.asarray(jax.nn.softmax(jax.jit(functools.partial(
            model.apply, train=False))(variables, jnp.asarray(x)), -1))
    refs = {"vit": probs(jv, vit_vars, images["vit"]),
            "vit8": probs(jv, q8, images["vit"]),
            "swin": probs(js, swin_vars, images["swin"])}
    return {"vit": vit_vars, "swin": swin_vars}, images, refs


def _port_engine(alias, variables, precompile=True):
    if alias.startswith("vit"):
        model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                       attn_fn=get_attn_fn("flash_hb"))
        return tserve.InferenceEngine(
            "vit", model=model, variables=variables["vit"], image_size=32,
            batch_buckets=(1, 4), device="cpu", precompile=precompile,
            weight_quant="int8" if alias == "vit8" else "fp32")
    model = TMODELS.build("swin_micro_patch2_window7", num_classes=10,
                          dtype=torch.float32, img_size=28, use_pallas=True)
    return tserve.InferenceEngine(
        "swin", model=model, variables=variables["swin"], image_size=28,
        batch_buckets=(1, 4), device="cpu", precompile=precompile)


def test_three_tenants_through_the_zoo_batcher():
    variables, images, refs = _tenants()
    aliases = ("vit", "vit8", "swin")
    pressure = {"base": 0.0}
    holder = {}

    def snap():
        frac = pressure["base"] + 0.2 * len(holder["zoo"]._engines)
        return {"devices": [{"bytes_limit": 10 ** 12,
                             "bytes_in_use": int(frac * 1e12),
                             "usage_frac": frac}]}

    zoo = tserve.ModelZoo(alert_frac=0.9, hbm_snapshot_fn=snap)
    holder["zoo"] = zoo
    for alias in aliases:
        zoo.register(alias, engine_factory=functools.partial(
            _port_engine, alias, variables), batch_buckets=(1, 4),
            image_size=28 if alias == "swin" else 32, est_bytes=100)
        assert zoo.load(alias, wait=True) == "warm"
        assert zoo.engine(alias).trace_count == 2
    solo = {alias: _port_engine(alias, variables) for alias in aliases}
    warm = {a: (zoo.engine(a).trace_count, zoo.engine(a).compile_count)
            for a in aliases}

    def frames(alias):
        return images["swin" if alias == "swin" else "vit"]

    # mixed traffic: the tenants' submits interleaved; a long max_wait
    # closes each lane's batch at its bucket of 4, so every batch is one
    # tenant's next four frames, as the solo engine's bucket-4 run
    with tserve.MicroBatcher(zoo=zoo, max_wait_ms=5000.0) as mb:
        handles = [(alias, i, mb.submit(frames(alias)[i], model=alias))
                   for i in range(4) for alias in aliases]
        got = {a: [] for a in aliases}
        for alias, i, h in handles:
            got[alias].append(h.result(timeout=60.0))
    for alias in aliases:
        np.testing.assert_array_equal(np.stack(got[alias]),
                                      solo[alias].infer(frames(alias)[:4]))
        np.testing.assert_allclose(np.stack(got[alias]), refs[alias][:4],
                                   atol=1e-4, rtol=0)
    with tserve.MicroBatcher(zoo=zoo, max_wait_ms=0.0) as mb:
        # one at a time: bucket 1
        for alias in aliases:
            for i in (4, 5):
                one = mb.submit(frames(alias)[i], model=alias).result(60.0)
                np.testing.assert_array_equal(
                    one, solo[alias].infer(frames(alias)[i])[0])
                np.testing.assert_allclose(one, refs[alias][i], atol=1e-4,
                                           rtol=0)
        for a in aliases:
            eng = zoo.engine(a)
            assert (eng.trace_count, eng.compile_count) == warm[a]
        st = zoo.stats()["models"]
        assert 0 < st["vit8"]["bytes"] < st["vit"]["bytes"] / 3
        # pressure: the LRU tenant goes, and the next request reloads it
        for alias in ("vit8", "swin"):
            zoo.touch(alias)
        pressure["base"] = 0.35
        assert zoo.enforce_pressure() == 1
        assert zoo.state("vit") == "evicted"
        pressure["base"] = 0.0
        again = mb.submit(images["vit"][0], model="vit").result(120.0)
        np.testing.assert_array_equal(again, solo["vit"].infer(
            images["vit"][0])[0])
    assert zoo.state("vit") == "warm"
    assert zoo.loads == 4 and zoo.evictions == 1


# ------------------------------------------------------- HTTP routes
def _http(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read()
            return resp.status, json.loads(body)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_zoo_routes_on_the_cpu(tmp_path, monkeypatch):
    ep = tmp_path / "endpoint.json"
    monkeypatch.setenv("DLTPU_ENDPOINT_FILE", str(ep))
    spec = {"vit": {"model": "vit_micro_patch4_56", "image_size": 56,
                    "num_classes": 5, "preload": True},
            "cold": {"model": "vit_micro_patch4_56", "image_size": 56,
                     "num_classes": 5, "weight_quant": "int8"}}
    args = _cli_args(["--buckets", "1,2", "--attn", "flash_hb"])
    zoo = serve_cli.build_zoo(serve_cli.parse_zoo_spec(json.dumps(spec)),
                              args)
    assert zoo.state("vit") == "warm" and zoo.state("cold") == "registered"
    x = np.random.default_rng(3).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    want = zoo.engine("vit").infer(x)
    with tserve.MicroBatcher(zoo=zoo, max_wait_ms=2.0) as mb:
        server = serve_cli.serve_http(mb, {}, 2, 30.0, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_port}"
        try:
            assert json.loads(ep.read_text())["url"] == url
            code, body = _http(url + "/predict/vit", _npy(x))
            assert code == 200 and len(body["results"]) == 2
            assert body["results"][0]["top"][0][0] == int(np.argmax(want[0]))
            assert _http(url + "/predict/ghost", _npy(x[0]))[0] == 404
            assert _http(url + "/predict/vit", b"junk")[0] == 400
            code, models = _http(url + "/models")
            assert models["models"]["vit"]["warm"] and \
                not models["models"]["cold"]["warm"]
            code, health = _http(url + "/healthz")
            assert code == 200 and health["status"] == "ready"
            code, stats = _http(url + "/stats")
            assert stats["zoo"]["resident"] == 1 and "hbm" in stats
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            assert 'dltpu_zoo_model_warm{model="vit"} 1.0' in text
            assert 'dltpu_serve_requests_total{model="vit"} 2.0' in text
            assert _http(url + "/metrics.json")[1]["metrics"][
                "dltpu_zoo_resident"]["value"] == 1.0
            # a cold tenant hot-loads on its first request
            code, body = _http(url + "/predict/cold", _npy(x[0]))
            assert code == 200 and zoo.state("cold") == "warm"
            assert zoo.engine("cold").weight_quant == "int8"
            # brownout step 2 demotes the tenant to int8 residency
            code, body = _http(url + "/admin/brownout/vit/2", b"",
                               method="POST")
            assert body == {"model": "vit", "step": 2, "demoted": True}
            assert zoo.state("vit") == "evicted"
            assert _http(url + "/admin/brownout/vit/x", b"",
                         method="POST")[0] == 400
            code, body = _http(url + "/admin/load/vit", b"", method="POST")
            assert code == 200 and body["state"] in ("loading", "warm")
            assert zoo.load("vit", wait=True) == "warm"
            assert zoo.engine("vit").weight_quant == "int8"
            code, body = _http(url + "/admin/evict/cold", b"", method="POST")
            assert body == {"model": "cold", "state": "evicted",
                            "evicted": True}
            assert _http(url + "/admin/evict/ghost", b"",
                         method="POST")[0] == 404
            assert _http(url + "/admin/promote", b"", method="POST")[1] == \
                {"promoted": False, "standby": False}
            code, body = _http(url + "/admin/drain", b"", method="POST")
            assert body["draining"]
            code, body = _http(url + "/predict/vit", _npy(x[0]))
            assert code == 429 and body["reason"] == "draining"
            assert _http(url + "/healthz")[1]["status"] == "draining"
            assert _http(url + "/admin/nope", b"", method="POST")[0] == 404
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)
