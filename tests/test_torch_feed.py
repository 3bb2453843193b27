"""The port's input feed (deeplearning_tpu_torch/data, train/async_metrics,
core/{config,logging}) vs the JAX package, on the CPU.

Tolerances, stated per test: loader batches, index orders, element specs,
transforms and samplers are numpy on both sides and must be EQUAL (same
seeds, same ``np.random.Generator`` draws); deferred metrics give JAX's
values exactly (float32 values and float32 window sums, read as float64)
and the same fetch counts. Mixup and cutmix draw from ``torch.Generator``
where JAX draws from ``jax.random``, so they are held by property: rows
sum to 1 (1e-6), the first label's weight is λ for mixup (the image is
λ·x + (1-λ)·flip(x), 1e-6) and the unpasted share for cutmix (exactly),
and one seed gives one batch (bit for bit). The prefetcher's CUDA path
(pinned staging, side stream) is held on the card
(tests/test_torch_kernels_card.py); here its CPU pass-through keeps the
loader protocol, relays a worker's error with its traceback and leaves no
thread behind. No assertion reads a clock.

The robust half of the feed, equal to JAX's: the quarantine (serial and
threaded loaders substitute and fill the batch, escalate past
``max_poisoned_frac``, route ``bad_sample`` through the log; the manifest
rows equal JAX's but for the time), ``read_split_data``'s split, the
folder loaders' batches with ``augment="none"``, the native JPEG decode
bit for bit (both build the same source), and ``ZipImageSource`` on
``.npy`` and PNG members.
"""

import itertools
import json
import os
import threading
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.core import config as jconfig
from deeplearning_tpu.core import logging as jlogging
from deeplearning_tpu.data import loader as jloader
from deeplearning_tpu.data import mixup as jmixup
from deeplearning_tpu.data import samplers as jsamplers
from deeplearning_tpu.data import build as jbuild
from deeplearning_tpu.data import datasets as jdatasets
from deeplearning_tpu.data import native_decode as jnative
from deeplearning_tpu.data import quarantine as jquarantine
from deeplearning_tpu.data import transforms as jtransforms
from deeplearning_tpu.data import zip_cache as jzip
from deeplearning_tpu.elastic import faults as jfaults
from deeplearning_tpu.train import async_metrics as jasync
from deeplearning_tpu_torch.core import config as tconfig
from deeplearning_tpu_torch.core import logging as tlogging
from deeplearning_tpu_torch.data import DevicePrefetcher
from deeplearning_tpu_torch.data import loader as tloader
from deeplearning_tpu_torch.data import mixup as tmixup
from deeplearning_tpu_torch.data import samplers as tsamplers
from deeplearning_tpu_torch.data import build as tbuild
from deeplearning_tpu_torch.data import datasets as tdatasets
from deeplearning_tpu_torch.data import native_decode as tnative
from deeplearning_tpu_torch.data import quarantine as tquarantine
from deeplearning_tpu_torch.data import transforms as ttransforms
from deeplearning_tpu_torch.data import zip_cache as tzip
from deeplearning_tpu_torch.elastic import faults as tfaults
from deeplearning_tpu_torch.train import async_metrics as tasync


def _arrays(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _assert_same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_and_order_equal_jax(shuffle):
    """Index order and batches over three epochs, a reseed, drop-last."""
    arrays = _arrays()
    for size, seed, epoch in itertools.product((7, 23), (0, 5), (0, 1, 4)):
        np.testing.assert_array_equal(
            tloader.epoch_indices(size, shuffle=shuffle, seed=seed,
                                  epoch=epoch, drop_last_to=3),
            jloader.epoch_indices(size, shuffle=shuffle, seed=seed,
                                  epoch=epoch, drop_last_to=3))
    j = jloader.DataLoader(jloader.ArraySource(**arrays), 5,
                           shuffle=shuffle, seed=3)
    t = tloader.DataLoader(tloader.ArraySource(**arrays), 5,
                           shuffle=shuffle, seed=3)
    assert len(t) == len(j) == 4
    for epoch in (0, 1, 2):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        _assert_same_batches(t, j)
    j.reseed(2)
    t.reseed(2)
    _assert_same_batches(t, j)
    # an infinite loader runs epochs back to back from self.epoch
    j.infinite = t.infinite = True
    _assert_same_batches(itertools.islice(t, 9), itertools.islice(j, 9))


def test_threaded_workers_equal_serial_and_jax():
    arrays = _arrays(n=40, seed=1)

    def fetch(i):
        return {"image": arrays["image"][i] * 2.0, "label": arrays["label"][i]}
    serial = tloader.DataLoader(tloader.MapSource(40, fetch), 8, seed=7)
    threaded = tloader.DataLoader(tloader.MapSource(40, fetch), 8, seed=7,
                                  num_workers=3, lookahead=2)
    jax_loader = jloader.DataLoader(jloader.MapSource(40, fetch), 8, seed=7)
    for epoch in (0, 1):
        for ld in (serial, threaded, jax_loader):
            ld.set_epoch(epoch)
        _assert_same_batches(threaded, serial)
        _assert_same_batches(serial, jax_loader)
    assert threaded.last_data_wait is not None
    assert serial.last_data_wait is None


def test_element_spec_matches_jax():
    arrays = _arrays()
    tr = jtransforms.classification_eval_transform((6, 6), crop_frac=1.0)
    want = jloader.DataLoader(jloader.ArraySource(**arrays), 5,
                              transform=tr).element_spec()
    got = tloader.DataLoader(tloader.ArraySource(**arrays), 5,
                             transform=tr).element_spec()
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].device is None
        assert np.dtype(got[k].dtype) == np.dtype(want[k].dtype)
    assert tloader.DataLoader(tloader.ArraySource(**arrays),
                              50).element_spec() is None


def test_loader_device_moves_batches_and_fetch_errors_raise():
    arrays = _arrays()
    ld = tloader.DataLoader(tloader.ArraySource(**arrays), 5, device="cpu")
    batch = next(iter(ld))
    assert isinstance(batch["image"], torch.Tensor)
    assert batch["label"].dtype == torch.int32
    host = tloader.DataLoader(tloader.ArraySource(**arrays), 5)
    # host_batches(), the prefetcher's source on a card, is the same
    # batches before the move; the loader itself keeps moving them
    assert all(isinstance(v, np.ndarray)
               for b in ld.host_batches() for v in b.values())
    _assert_same_batches(ld.host_batches(), host)
    assert isinstance(next(iter(ld))["image"], torch.Tensor)
    _assert_same_batches(tloader.prefetch_to_device(host, 2, device="cpu"),
                         host)

    def broken(i):
        raise OSError(f"cannot read sample {i}")
    for workers in (0, 2):
        bad = tloader.DataLoader(tloader.MapSource(10, broken), 5,
                                 num_workers=workers)
        with pytest.raises(OSError, match="cannot read sample"):
            next(iter(bad))


# ----------------------------------------------- transforms and samplers
def _image(seed=0, hw=(20, 14)):
    return np.random.default_rng(seed).uniform(
        0, 255, hw + (3,)).astype(np.float32)


TRANSFORMS = [
    ("normalize", lambda m, img, rng: m.normalize(img)),
    ("resize_bilinear", lambda m, img, rng: m.resize_bilinear(img, (9, 11))),
    ("resize_with_pad", lambda m, img, rng: m.resize_with_pad(
        img, (16, 16), boxes=np.asarray([[1.0, 2.0, 10.0, 12.0]]))),
    ("random_flip_lr", lambda m, img, rng: [m.random_flip_lr(
        img, rng, boxes=np.asarray([[1.0, 2.0, 10.0, 12.0]]), p=0.7)
        for _ in range(4)]),
    ("random_resized_crop", lambda m, img, rng: [
        m.random_resized_crop(img, rng, (8, 8)) for _ in range(4)]),
    ("color_jitter", lambda m, img, rng: m.color_jitter(img, rng)),
    ("eval_image_transform", lambda m, img, rng: m.eval_image_transform(
        (8, 8))(img)),
    ("classification_eval_transform",
     lambda m, img, rng: m.classification_eval_transform((8, 8))(
         {"image": np.stack([img, img[::-1]])})["image"]),
]


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for x in out for y in _flat(x)]
    return [np.asarray(out)]


@pytest.mark.parametrize("name,fn", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_transforms_equal_jax(name, fn):
    img = _image()
    got = _flat(fn(ttransforms, img, np.random.default_rng(3)))
    want = _flat(fn(jtransforms, img, np.random.default_rng(3)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("preset", ["imagenet", "light", "none"])
def test_train_presets_equal_jax(preset, monkeypatch):
    """The per-thread generators start from the same counter in both."""
    monkeypatch.setattr(jtransforms, "_THREAD_SEED", itertools.count())
    monkeypatch.setattr(ttransforms, "_THREAD_SEED", itertools.count())
    img = _image(1, (24, 24))
    t = ttransforms.get_train_transform(preset, (12, 12), seed=4)
    j = jtransforms.get_train_transform(preset, (12, 12), seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(t(img), j(img))
    with pytest.raises(ValueError):
        ttransforms.get_train_transform("heavy")


def test_samplers_equal_jax():
    labels = np.random.default_rng(2).integers(0, 7, 60)
    ar = np.random.default_rng(3).uniform(0.5, 2.0, 60)
    for epoch in (0, 1):
        np.testing.assert_array_equal(
            tsamplers.pk_batches(labels, 4, 3, seed=1, epoch=epoch),
            jsamplers.pk_batches(labels, 4, 3, seed=1, epoch=epoch))
        np.testing.assert_array_equal(
            tsamplers.grouped_batches(ar, 8, n_groups=3, seed=2, epoch=epoch),
            jsamplers.grouped_batches(ar, 8, n_groups=3, seed=2, epoch=epoch))
    np.testing.assert_array_equal(tsamplers.aspect_ratio_groups(ar, 4),
                                  jsamplers.aspect_ratio_groups(ar, 4))
    np.testing.assert_array_equal(
        list(itertools.islice(tsamplers.infinite_indices(9, seed=5), 30)),
        list(itertools.islice(jsamplers.infinite_indices(9, seed=5), 30)))


# ---------------------------------------------------------- mixup/cutmix
def test_one_hot_smooth_matches_jax():
    labels = np.asarray([0, 3, 9, 2])
    np.testing.assert_allclose(
        tmixup.one_hot_smooth(torch.from_numpy(labels), 10, 0.1).numpy(),
        np.asarray(jmixup.one_hot_smooth(jnp.asarray(labels), 10, 0.1)),
        atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("switch_prob", [0.0, 1.0])
def test_mixup_cutmix_properties(seed, switch_prob):
    """switch_prob 0 is mixup, 1 cutmix."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(6, 12, 10, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 6).astype(np.int32))
    batch = {"image": x, "label": y, "extra": torch.arange(6)}

    def run(s):
        return tmixup.mixup_cutmix(batch, torch.Generator().manual_seed(s),
                                   5, smoothing=0.1, switch_prob=switch_prob)
    out, again = run(seed), run(seed)
    assert torch.equal(out["image"], again["image"])
    assert torch.equal(out["label"], again["label"])
    assert out["image"].dtype == x.dtype and torch.equal(out["extra"],
                                                         batch["extra"])
    soft = out["label"]
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, atol=1e-6)
    t1 = tmixup.one_hot_smooth(y, 5, 0.1)
    t2 = tmixup.one_hot_smooth(y.flip(0), 5, 0.1)
    # the weight of the first label: soft = lam*t1 + (1-lam)*t2
    diff = (t1 - t2)[0]
    k = int(torch.argmax(diff.abs()))
    lam = float((soft[0, k] - t2[0, k]) / diff[k]) if diff[k] != 0 else None
    flipped = x.flip(0)
    if switch_prob == 0.0:
        assert lam is not None and 0.0 <= lam <= 1.0
        np.testing.assert_allclose(out["image"].numpy(),
                                   (lam * x + (1 - lam) * flipped).numpy(),
                                   atol=1e-5)
    else:
        pasted = (out["image"] == flipped) & (out["image"] != x)
        from_x = out["image"] == x
        assert bool((pasted | from_x).all())
        share = pasted[0, ..., 0].float().mean().item()
        box = pasted.all(-1).any(0)         # the one rectangle
        area = box.float().mean().item()
        assert share == pytest.approx(area, abs=1e-7)
        if lam is not None:
            assert lam == pytest.approx(1.0 - area, abs=1e-6)
    other = tmixup.mixup_cutmix(batch, torch.Generator().manual_seed(seed + 9),
                                5, switch_prob=switch_prob)
    assert not torch.equal(other["image"], out["image"])


# ------------------------------------------------------- deferred metrics
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("lag", [0, 2])
def test_deferred_metrics_match_jax(window, lag):
    rng = np.random.default_rng(4)
    losses = rng.normal(size=11).astype(np.float32)
    j = jasync.DeferredMetrics(lag=lag, window=window)
    t = tasync.DeferredMetrics(lag=lag, window=window)
    got, want = [], []
    for i, loss in enumerate(losses):
        bad = np.int32(i == 6)
        j.push({"loss": jnp.asarray(loss), "bad_step": jnp.asarray(bad)},
               it=i)
        t.push({"loss": torch.tensor(loss), "bad_step": torch.tensor(bad)},
               it=i)
        if i % 2 == 0:
            want += j.poll()
            got += t.poll()
            assert t.pending == j.pending
    want += j.drain()
    got += t.drain()
    assert got == want and len(got) > 0
    assert (t.fetch_count, t.fetched_entries) == (j.fetch_count,
                                                  j.fetched_entries)
    assert t.poll() == [] and t.drain() == []
    assert t.fetch_count == j.fetch_count


def test_one_poll_is_one_transfer(monkeypatch):
    """A poll stacks the ready scalars and copies them with one .cpu()."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(self.shape)
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    d = tasync.DeferredMetrics(lag=1)
    for i in range(5):
        d.push({"loss": torch.tensor(float(i)), "acc": torch.tensor(0.5)})
    out = d.poll()
    assert len(out) == 4 and calls == [torch.Size([8])]
    assert [h["loss"] for _, h in out] == [0.0, 1.0, 2.0, 3.0]


# ------------------------------------------------------------- prefetcher
def _prefetcher(n=20, batch=4, **kw):
    arrays = _arrays(n=n, seed=2)
    loader = tloader.DataLoader(tloader.ArraySource(**arrays), batch, seed=1,
                                device="cpu")
    return DevicePrefetcher(loader, **kw), loader


def _live_feed_threads():
    return [t for t in threading.enumerate()
            if t.name == "device-prefetch" and t.is_alive()]


def test_prefetcher_keeps_the_epoch_protocol():
    pf, loader = _prefetcher(depth=3)
    ref = tloader.DataLoader(loader.source, 4, seed=1, device="cpu")
    assert len(pf) == 5 and pf.element_spec() == loader.element_spec()
    for epoch in (0, 1):
        pf.set_epoch(epoch)
        ref.set_epoch(epoch)
        if epoch == 1:
            pf.start()                    # started early, consumed by iter
        _assert_same_batches(pf, ref)
    pf.start()
    pf.set_epoch(2)                       # a stale pipeline is discarded
    ref.set_epoch(2)
    _assert_same_batches(pf, ref)
    pf.reseed(3)
    ref.reseed(3)
    _assert_same_batches(pf, ref)
    stats = pf.stats()
    assert stats["batches_fed"] == 20 and stats["prefetch_depth"] == 3.0
    assert 0.0 <= stats["prefetch_occupancy"] <= 3.0
    pf.reset_stats()
    assert pf.stats()["batches_fed"] == 0 and pf.last_data_wait is None
    assert not _live_feed_threads()


def test_prefetcher_relays_a_worker_error_with_its_traceback():
    def fetch(i):
        if i == 9:
            raise KeyError(f"missing sample {i}")
        return {"x": np.float32([i])}
    loader = tloader.DataLoader(tloader.MapSource(16, fetch), 4,
                                shuffle=False)
    pf = DevicePrefetcher(loader, depth=1)
    seen = []
    with pytest.raises(KeyError, match="missing sample 9") as info:
        for b in pf:
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 4]
    assert "fetch" in [f.name for f in traceback.extract_tb(info.tb)]
    assert not _live_feed_threads()


def test_prefetcher_leaves_no_thread_after_an_early_break():
    pf, _ = _prefetcher(n=40, depth=1)
    for i, _ in enumerate(pf):
        if i == 1:
            break
    assert not _live_feed_threads()
    pf.start()
    pf.reseed(1)                          # discards the started pipeline
    assert not _live_feed_threads()


# ------------------------------------------------------ config, logging
def test_dotted_overrides_and_cfg_files_match_jax(tmp_path):
    import dataclasses
    from typing import Optional, Tuple

    @dataclasses.dataclass(frozen=True)
    class Inner:
        lr: float = 0.1
        steps: int = 3
        name: str = "a"
        path: Optional[str] = None
        flag: bool = False
        sizes: Tuple[int, ...] = (1,)

    @dataclasses.dataclass(frozen=True)
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        seed: int = 0

    opts = ["inner.lr=1e-4", "inner.steps", "7", "inner.name=vit_b",
            "inner.path=null", "inner.flag=yes", "inner.sizes=[2, 3]",
            "seed=-3"]
    raw = ["1", "1.5", ".5", "1e-4", "1.0e-4", "true", "Off", "~", "'7'",
           "[a, 0.5]", "x.y", "/tmp/a", "-.inf", "1_000", "[[1, 2], [3]]",
           "['a,b', c]", "0x1f", "0o17", "{a: 1}", "[unclosed"]
    for r in raw:
        assert tconfig._parse_dotted([f"k={r}"]) == jconfig._parse_dotted(
            [f"k={r}"]), r
    assert tconfig.load_config(Outer(), opts=opts) == jconfig.load_config(
        Outer(), opts=opts)
    base = tmp_path / "base.yaml"
    base.write_text("inner:\n  lr: 0.5\n  steps: 9\n")
    top = tmp_path / "top.yaml"
    top.write_text("_base_: base.yaml\nseed: 4\ninner:\n  steps: 2\n")
    assert tconfig.load_config(Outer(), str(top), ["inner.name=c"]) == \
        jconfig.load_config(Outer(), str(top), ["inner.name=c"])
    with pytest.raises(KeyError, match="valid keys"):
        tconfig.load_config(Outer(), opts=["inner.nope=1"])


def test_logger_backends_write_as_jax(tmp_path):
    rows = [(1, {"train/loss": 2.5, "train/acc": 0.25}),
            (2, {"train/loss": 2.0}),
            (3, {"eval/top1": 0.5, "train/loss": 1.5})]
    outs = {}
    for name, mod in (("jax", jlogging), ("port", tlogging)):
        hub = mod.LoggerHub(str(tmp_path / name), ("csv", "jsonl"))
        for step, metrics in rows:
            hub.scalars(metrics, step)
        hub.summary({"top1": 0.5})
        hub.close()
        outs[name] = (
            (tmp_path / name / "results.csv").read_text(),
            [{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in (tmp_path / name / "metrics.jsonl").read_text()
             .splitlines()])
    assert outs["port"] == outs["jax"]
    with pytest.raises(KeyError, match="not found"):
        tlogging.LoggerHub(str(tmp_path / "x"), ("wandb",))
    assert tlogging.TensorBoardWriter(None)._writer is None
    m_j, m_t = jlogging.MetricLogger(), tlogging.MetricLogger()
    for v in (1.0, 2.0, 4.0):
        m_j.update(loss=v)
        m_t.update(loss=v)
    assert str(m_t) == str(m_j) and m_t.loss.avg == pytest.approx(7 / 3)


# ------------------------------------------------------------ quarantine
class _Flaky:
    """A map source whose listed indices raise ``exc`` on every fetch."""

    def __init__(self, n=64, bad=(), exc=ValueError):
        arrays = _arrays(n)
        self.images, self.labels = arrays["image"], arrays["label"]
        self.bad, self.exc = set(bad), exc

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            if int(idx) in self.bad:
                raise self.exc(f"decode failed for sample {int(idx)}")
            return {"image": self.images[idx], "label": self.labels[idx]}
        samples = [self[int(i)] for i in idx]
        return {k: np.stack([x[k] for x in samples]) for k in samples[0]}


def _rows(path):
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        r.pop("time")
    return rows


@pytest.mark.parametrize("workers", [0, 2])
def test_quarantine_fills_batches_and_logs_as_jax(tmp_path, workers):
    out = {}
    for name, ld_mod, q_mod in (("jax", jloader, jquarantine),
                                ("port", tloader, tquarantine)):
        path = str(tmp_path / f"{name}.jsonl")
        log = q_mod.QuarantineLog(path)
        loader = ld_mod.DataLoader(_Flaky(bad=(3, 17, 40)), 8, seed=1,
                                   num_workers=workers, quarantine=log)
        out[name] = (list(loader), log.quarantined, _rows(path))
    _assert_same_batches(out["port"][0], out["jax"][0])
    assert all(b["image"].shape[0] == 8 for b in out["port"][0])
    assert out["port"][1:] == out["jax"][1:]
    assert sorted(r["index"] for r in out["port"][2]) == [3, 17, 40]


def test_quarantine_escalates_and_reraises_what_is_not_a_sample(tmp_path):
    log = tquarantine.QuarantineLog(str(tmp_path / "q.jsonl"),
                                    max_poisoned_frac=0.05, min_samples=16)
    loader = tloader.DataLoader(_Flaky(bad=set(range(0, 64, 4))), 8,
                                shuffle=False, quarantine=log)
    with pytest.raises(tquarantine.PoisonedData, match="poisoned"):
        list(loader)
    for workers in (0, 2):
        loader = tloader.DataLoader(
            _Flaky(n=32, bad=(9,), exc=MemoryError), 8, shuffle=False,
            num_workers=workers,
            quarantine=tquarantine.QuarantineLog(os.devnull))
        with pytest.raises(MemoryError) as info:
            list(loader)
        frames = [f.name for f in
                  traceback.extract_tb(info.value.__traceback__)]
        assert "_fetch_one" in frames
    for exc in (ValueError("x"), OSError("y")):
        assert tquarantine.quarantinable(exc) == jquarantine.quarantinable(exc)
    for exc in (MemoryError(), KeyboardInterrupt(),
                tquarantine.PoisonedData("z")):
        assert not tquarantine.quarantinable(exc)


def test_bad_sample_fault_goes_through_the_quarantine(tmp_path, monkeypatch):
    rows = {}
    for name, ld_mod, q_mod, f_mod in (
            ("jax", jloader, jquarantine, jfaults),
            ("port", tloader, tquarantine, tfaults)):
        monkeypatch.setenv(f_mod.ENV_VAR, "bad_sample@step:5")
        f_mod.reset()
        try:
            path = str(tmp_path / f"{name}.jsonl")
            log = q_mod.QuarantineLog(path)
            batches = list(ld_mod.DataLoader(_Flaky(n=32), 8, shuffle=False,
                                             quarantine=log))
        finally:
            monkeypatch.delenv(f_mod.ENV_VAR)
            f_mod.reset()
        assert len(batches) == 4 and log.quarantined == 1
        rows[name] = _rows(path)
    assert rows["port"] == rows["jax"]
    assert "InjectedBadSample" in rows["port"][0]["error"]


# ----------------------------------------------------------- folder data
@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """3 class folders of seeded uint8 .npy images of 20 x 24 x 3."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for c, n in (("ant", 7), ("bee", 9), ("cat", 8)):
        os.makedirs(root / c)
        for i in range(n):
            np.save(root / c / f"{i:02d}.npy",
                    rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
    (root / "cat" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("seed", [0, 3])
def test_read_split_data_equals_jax(image_folder, seed, tmp_path):
    got = tdatasets.read_split_data(image_folder, 0.25, seed)
    want = jdatasets.read_split_data(image_folder, 0.25, seed)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object),
                                      np.asarray(want[k], dtype=object))
    tdatasets.write_class_indices(got["class_to_idx"], str(tmp_path / "t"))
    jdatasets.write_class_indices(want["class_to_idx"], str(tmp_path / "j"))
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()


def test_folder_loaders_equal_jax(image_folder, tmp_path):
    cfg = dict(global_batch=4, image_size=16, val_rate=0.25, num_workers=2,
               seed=1, augment="none")
    t_train, t_val, t_idx = tbuild.build_classification_loaders(
        image_folder, tbuild.LoaderConfig(**cfg),
        class_indices_path=str(tmp_path / "classes.json"))
    j_train, j_val, j_idx = jbuild.build_classification_loaders(
        image_folder, jbuild.LoaderConfig(**cfg))
    assert t_idx == j_idx and (len(t_train), len(t_val)) == (4, 1)
    for epoch in (0, 1):
        t_train.set_epoch(epoch)
        j_train.set_epoch(epoch)
        _assert_same_batches(t_train, j_train)
    _assert_same_batches(t_val, j_val)
    assert tbuild.measure_throughput(t_train, n_batches=3, warmup=1) > 0
    pf = tbuild.device_iterator(t_train, tbuild.LoaderConfig(prefetch=3))
    assert isinstance(pf, DevicePrefetcher) and pf.depth == 3


def test_native_jpeg_decode_is_jaxs_bit_for_bit(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ or libjpeg is absent: the native decode does not "
                    "build here")
    rng = np.random.default_rng(0)
    blobs = []
    for i, shape in enumerate(((32, 48, 3), (17, 9, 3))):
        path = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            path, quality=90)
        blobs.append(path.read_bytes())
        got = tnative.decode_jpeg(blobs[-1])
        np.testing.assert_array_equal(got, jnative.decode_jpeg(blobs[-1]))
        np.testing.assert_array_equal(tdatasets.load_image(str(path)),
                                      jdatasets.load_image(str(path)))
    np.testing.assert_array_equal(
        tnative.decode_resize_batch(blobs + [b"junk"], 12, 10),
        jnative.decode_resize_batch(blobs + [b"junk"], 12, 10))
    assert tnative.decode_jpeg(b"not a jpeg") is None


def test_zip_source_and_memmap_cache_equal_jax(tmp_path):
    import io
    import zipfile
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    path = str(tmp_path / "images.zip")
    with zipfile.ZipFile(path, "w") as z:
        for i in range(3):
            img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
            buf = io.BytesIO()
            np.save(buf, img)
            z.writestr(f"train/{i}.npy", buf.getvalue())
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            z.writestr(f"train/{i}.png", buf.getvalue())
        z.writestr("train/readme.txt", "skip me")
    got, want = tzip.ZipImageSource(path), jzip.ZipImageSource(path)
    assert got.names == want.names and len(got) == 6
    for i in range(len(got)):
        np.testing.assert_array_equal(got.read_image(i), want.read_image(i))
    cache = tzip.MemmapCache(str(tmp_path / "cache.bin"), (6, 6, 5, 3))
    first = cache.get(2, got.read_image)
    np.testing.assert_array_equal(first, got.read_image(2))
    assert cache.fill_fraction == pytest.approx(1 / 6)
    again = tzip.MemmapCache(str(tmp_path / "cache.bin"), (6, 6, 5, 3))
    np.testing.assert_array_equal(again.get(2, lambda i: None), first)
