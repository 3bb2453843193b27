"""The port's serving slice as a whole (deeplearning_tpu_torch/serve) vs
the JAX serving engine, plus the batcher, admission, health and CLI
contracts, on the CPU at a tiny size.

Also the port's import boundary: an AST scan proves that
``deeplearning_tpu_torch`` and ``chip_smoke.py`` import nothing of JAX
or of the JAX package (``sys.modules`` cannot tell: this image imports
jax at interpreter start).
"""

import ast
import functools
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.models.classification import vit as jvit
from deeplearning_tpu.ops.attention import get_attn_fn as j_get_attn_fn
from deeplearning_tpu.serve import InferenceEngine as JaxEngine
from deeplearning_tpu_torch.models.classification import vit as tvit
from deeplearning_tpu_torch.ops.attention import get_attn_fn as t_get_attn_fn
from deeplearning_tpu_torch.serve import (AdmissionController,
                                          DeadlineExceeded, DispatchWatch,
                                          InferenceEngine, MicroBatcher,
                                          Rejected, health)
from deeplearning_tpu_torch.serve import __main__ as serve_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
def jax_variables():
    model = jvit.VisionTransformer(**TINY, dtype=jnp.float32)
    return model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                      train=False)


@pytest.fixture(scope="module")
def port_engine(jax_variables):
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32,
                                   attn_fn=t_get_attn_fn("flash_hb"))
    return InferenceEngine(model=model, variables=jax_variables,
                           image_size=32, batch_buckets=(1, 4),
                           device="cpu")


def _images(n, seed=0, size=32):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


# ------------------------------------------------------- slice vs JAX
def test_engine_matches_jax_engine(jax_variables, port_engine):
    jmodel = jvit.VisionTransformer(**TINY, dtype=jnp.float32,
                                    attn_fn=j_get_attn_fn("flash_hb"))
    jeng = JaxEngine(model=jmodel, variables=jax_variables, image_size=32,
                     batch_buckets=(1, 4), use_compile_cache=False)
    x = _images(6)                     # chunks: bucket 4, then 2 padded
    want = jeng.infer(x)
    got = port_engine.infer(x)
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_engine.infer(x[:1]), want[:1],
                               atol=1e-5, rtol=0)
    # steady state adds no new forward builds
    assert port_engine.trace_count == port_engine.compile_count == 2
    assert port_engine.stats()["warm"]


def test_microbatcher_demux_equals_infer(port_engine):
    images = _images(6, seed=2)
    direct = port_engine.infer(images)
    with MicroBatcher(port_engine, max_wait_ms=20.0) as mb:
        handles = [mb.submit(img) for img in images]
        rows = [h.result(timeout=10.0) for h in handles]
    np.testing.assert_array_equal(np.stack(rows), direct)
    snap = mb.telemetry.snapshot()
    assert snap["submitted"] == 6 and snap["completed"] == 6
    assert port_engine.trace_count == 2


def test_engine_rejects_unported_modes():
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32)
    # TTA is held against JAX in tests/test_torch_serve_ckpt_tta.py, int8
    # residency in tests/test_torch_zoo.py::test_int8_engine_matches_jax;
    # a classifier's flip-TTA is no detector's
    with pytest.raises(ValueError, match="yolox_tta"):
        InferenceEngine(model=model, image_size=32, device="cpu",
                        precompile=False, tta=True, task="detect")
    with pytest.raises(ValueError, match="fp32 or int8"):
        InferenceEngine(model=model, image_size=32, device="cpu",
                        precompile=False, weight_quant="int4")
    # every detection family is ported: a classifier named as a detector
    # is refused as in JAX, with ValueError
    with pytest.raises(ValueError, match="no detection predict path"):
        InferenceEngine(model=model, image_size=32, device="cpu",
                        precompile=False, task="detect")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("vit_micro_patch4_56", image_size=56)


# ------------------------------------------- batcher policy (fake engine)
class _SlowFakeEngine:
    """The batcher contract is just buckets / bucket_for / pad_to_bucket /
    run / image_size, so saturation tests need no model (run blocks until
    released, deterministically)."""

    name = "fake"
    task = "classify"
    compile_count = 3

    def __init__(self, buckets=(1, 2, 8), size=4):
        self.buckets = tuple(sorted(buckets))
        self.image_size = size
        self.release = threading.Event()
        self.ran_buckets = []

    def bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def pad_to_bucket(self, images, bucket):
        n = images.shape[0]
        pad = np.zeros((bucket - n, *images.shape[1:]), images.dtype)
        return np.concatenate([images, pad], axis=0)

    def run(self, bucket, images):
        self.release.wait(timeout=10.0)
        self.ran_buckets.append(bucket)
        return torch.from_numpy(images.sum(axis=(1, 2, 3)))

    def stats(self):
        return {"model": self.name}


def test_rejects_on_a_full_queue():
    eng = _SlowFakeEngine()
    img = np.ones((4, 4, 3), np.float32)
    with MicroBatcher(eng, max_wait_ms=1.0, max_queue=2) as mb:
        first = mb.submit(img)              # dispatcher blocks in run()
        time.sleep(0.1)
        held = [mb.submit(img), mb.submit(img)]   # fills max_queue=2
        with pytest.raises(Rejected) as ei:
            mb.submit(img)
        assert ei.value.retry_after_s > 0 and ei.value.reason == "queue_full"
        eng.release.set()
        assert first.result(timeout=10.0) == pytest.approx(48.0)
        for h in held:
            h.result(timeout=10.0)
    assert mb.telemetry.snapshot()["rejected"] == 1


def test_deadline_cancels_before_dispatch():
    eng = _SlowFakeEngine()
    img = np.ones((4, 4, 3), np.float32)
    with MicroBatcher(eng, max_wait_ms=1.0) as mb:
        blocker = mb.submit(img)
        time.sleep(0.1)
        doomed = mb.submit(img, timeout_s=0.01)
        time.sleep(0.1)
        eng.release.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10.0)
        blocker.result(timeout=10.0)
    assert mb.telemetry.snapshot()["timed_out"] == 1
    assert eng.ran_buckets == [1]


def test_overload_sheds_to_largest_bucket():
    eng = _SlowFakeEngine(buckets=(1, 2, 8))
    eng.release.set()
    img = np.ones((4, 4, 3), np.float32)
    adm = AdmissionController(eng.buckets, max_queue=64, shed_threshold=1)
    mb = MicroBatcher(eng, max_wait_ms=0.0, admission=adm, start=False)
    handles = [mb.submit(img) for _ in range(4)]
    mb.start()
    for h in handles:
        h.result(timeout=10.0)
    mb.close()
    assert 8 in eng.ran_buckets
    assert mb.telemetry.snapshot()["shed_batches"] >= 1


def test_drain_rejects_new_work_and_health_reports_it():
    eng = _SlowFakeEngine()
    eng.release.set()
    img = np.ones((4, 4, 3), np.float32)
    with MicroBatcher(eng, max_wait_ms=1.0) as mb:
        mb.submit(img).result(timeout=10.0)
        assert health(eng, mb)[0] == 200
        mb.drain()
        with pytest.raises(Rejected) as ei:
            mb.submit(img)
        assert ei.value.reason == "draining"
        code, payload = health(eng, mb)
        assert code == 503 and payload["status"] == "draining"
        assert payload["drained"]


def test_health_warming_and_wedged():
    model = tvit.VisionTransformer(**TINY, dtype=torch.float32)
    cold = InferenceEngine(model=model, image_size=32, device="cpu",
                           batch_buckets=(1, 4), precompile=False)
    code, payload = health(cold)
    assert code == 503 and payload["status"] == "warming"
    eng = _SlowFakeEngine()
    img = np.ones((4, 4, 3), np.float32)
    with MicroBatcher(eng, max_wait_ms=1.0) as mb:
        watch = DispatchWatch(mb, deadline_s=0.05)
        mb.submit(img)                      # dispatcher blocks in run()
        assert watch.verdict() != "wedged"
        time.sleep(0.2)
        code, payload = health(eng, mb, wedge=watch)
        assert code == 503 and payload["wedged"]
        eng.release.set()


# ------------------------------------------------------------------ CLI
def test_cli_stdin_line_protocol(tmp_path, monkeypatch, capsys):
    path = tmp_path / "two.npy"
    np.save(path, _images(2, seed=5, size=56))
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{path}\nmissing.png\n"))
    rc = serve_cli.main(["--model", "vit_micro_patch4_56", "--size", "56",
                         "--device", "cpu", "--buckets", "1,2",
                         "--num-classes", "5", "--topk", "2"])
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert rc == 0
    assert [a["image"] for a in out[:2]] == [0, 1]
    assert all(len(a["top"]) == 2 for a in out[:2])
    assert "error" in out[2] and out[2]["path"] == "missing.png"


def _http(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_predict_healthz_stats(port_engine):
    with MicroBatcher(port_engine, max_wait_ms=5.0) as mb:
        server = serve_cli.serve_http(mb, {}, 3, 10.0, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_port}"
        try:
            code, body = _http(url + "/predict", _npy(_images(2, seed=9)))
            assert code == 200 and len(body["results"]) == 2
            want = port_engine.infer(_images(2, seed=9))
            top = body["results"][0]["top"][0]
            assert top[0] == int(np.argmax(want[0]))
            assert _http(url + "/healthz")[0] == 200
            code, stats = _http(url + "/stats")
            assert stats["engine"]["warm"] and stats["completed"] >= 2
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)


def test_http_429_and_504():
    eng = _SlowFakeEngine()
    img = np.ones((4, 4, 3), np.float32)
    with MicroBatcher(eng, max_wait_ms=1.0, max_queue=2) as mb:
        server = serve_cli.serve_http(mb, {}, 1, 10.0, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_port}"
        try:
            first = mb.submit(img)          # dispatcher blocks in run()
            time.sleep(0.1)
            code, body = _http(url + "/predict", _npy(img),
                               {"X-Deadline-Ms": "50"})
            assert code == 504 and body["error"] == "deadline_exceeded"
            # the expired request still holds its slot until the
            # dispatcher pops it: one more fills max_queue=2
            held = mb.submit(img)
            code, body = _http(url + "/predict", _npy(img))
            assert code == 429 and body["retry_after_s"] > 0
            eng.release.set()
            first.result(timeout=10.0)
            held.result(timeout=10.0)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)


# ------------------------------------------------------- import boundary
_FORBIDDEN = ("jax", "flax", "optax", "orbax", "deeplearning_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in _FORBIDDEN          # deeplearning_tpu_torch is its own


def test_port_imports_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "deeplearning_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20 and os.path.exists(files[0])
    scanned = {os.path.relpath(f, os.path.join(REPO, "deeplearning_tpu_torch"))
               for f in files}
    assert {"core/config.py", "core/logging.py", "core/checkpoint.py",
            "data/loader.py", "data/device_prefetch.py", "data/mixup.py",
            "data/samplers.py", "data/transforms.py",
            "train/async_metrics.py", "train/trainer.py",
            "train/__main__.py", "analysis/strict.py", "train/recovery.py",
            "elastic/preempt.py", "elastic/signals.py",
            "elastic/heartbeat.py", "data/build.py", "data/quarantine.py",
            "data/datasets.py", "data/zip_cache.py", "data/native_decode.py",
            "native/build.py", "train/lr_finder.py", "ops/matcher.py",
            "train/multiscale.py", "train/detection.py",
            "evaluation/coco_eval.py", "data/coco.py",
            "data/label_convert.py", "core/experiment.py",
            "train/evolve.py", "evaluation/voc.py", "obs/metrics.py",
            "obs/xla.py", "parallel/collectives.py", "serve/zoo.py",
            "ops/tta.py", "parallel/mesh.py", "parallel/sharding.py",
            "elastic/topology.py", "elastic/resume.py",
            "evaluation/distributed.py", "parallel/ring_attention.py",
            "parallel/ulysses.py", "parallel/_seq_adapter.py",
            "parallel/pipeline.py", "parallel/pipeline_train.py"} <= scanned
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), m) for m in mods
                    if _forbidden(m)]
    assert not bad, bad
    assert _forbidden("deeplearning_tpu.ops") and not _forbidden(
        "deeplearning_tpu_torch.ops")


# ---------------------------------- chip_smoke: served rows vs their batch
def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RowEngine:
    """An engine whose answer for an image depends on its row in the batch,
    as a detector's bits do on the card."""

    def run(self, bucket, batch):
        assert batch.shape[0] == bucket
        return {"score": torch.from_numpy(batch.sum(axis=(1, 2, 3))
                                          + np.arange(bucket))}


def test_served_rows_held_at_their_batch_row():
    cs = _chip_smoke()
    engine = _RowEngine()
    images = np.random.default_rng(0).normal(size=(5, 4, 4, 3))
    pad = np.zeros((2, 4, 4, 3))
    # arrival order, not index order: image 3 rode row 0 of the first batch
    runs = [(4, images[[3, 0, 4, 1]]),
            (4, np.concatenate([images[[2]], pad, pad[:1]]))]
    rows = [None] * 5
    for b, batch in runs:
        out = engine.run(b, batch)["score"].numpy()
        for j in range(b):
            hit = [i for i in range(5) if np.array_equal(batch[j], images[i])]
            if hit:
                rows[hit[0]] = {"score": out[j]}
    cs._hold_served_rows("row engine", engine, images, rows, runs, 2)
    # the same answers against index-order rows would not hold
    index_order = {"score": engine.run(4, images[:4])["score"].numpy()}
    assert not np.array_equal(rows[3]["score"], index_order["score"][3])
    swapped = list(rows)
    swapped[0], swapped[1] = rows[1], rows[0]
    with pytest.raises(RuntimeError, match="engine.run of its batch"):
        cs._hold_served_rows("row engine", engine, images, swapped, runs, 2)
    with pytest.raises(RuntimeError, match="one engine.run a batch"):
        cs._hold_served_rows("row engine", engine, images, rows, runs, 3)
    with pytest.raises(RuntimeError, match="went out in one batch"):
        cs._hold_served_rows("row engine", engine, images, rows, runs[:1], 1)
