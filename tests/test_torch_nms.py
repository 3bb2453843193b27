"""Port NMS and box ops (deeplearning_tpu_torch/ops/{nms,boxes}.py) vs the
JAX package's, on the CPU.

The keep-set contract is exact: equal ``valid`` and equal ``idx`` on the
valid slots (the JAX tests' ``assert_same_keeps``). The port's greedy and
blocked sweeps are held against JAX ``nms_reference`` over 1 024
randomized overlap-heavy cases (4 regimes x 256, n = 200, block 64, 2% NaN
scores in the first), each regime in one batched call. A few cases go
against JAX's Pallas kernel in interpret mode, as its own tests run it.
Box ops agree within 1e-6 (float32; the exp in ``decode_boxes`` is XLA's
approximation on one side and torch's on the other).

The CUDA kernels (K3) are held against these plain versions on the card
by tests/test_torch_kernels_card.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_tpu.ops import boxes as jboxes
from deeplearning_tpu.ops import nms as jnms
from deeplearning_tpu.ops.pallas import nms as jpallas_nms
from deeplearning_tpu_torch.ops import boxes as tboxes
from deeplearning_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401

# (iou_thresh, score_thresh, max_out): tests/test_blocked_nms.py's regimes
CONFIGS = [
    (0.5, float("-inf"), 64),
    (0.3, 0.25, 32),
    (0.7, 0.5, 16),
    (0.45, 0.05, 100),
]


def make_cases(rng, cases, n, span=64.0, wh_max=24.0, nan_frac=0.0):
    """Overlap-heavy random boxes (cases, n, 4) and scores (cases, n), the
    JAX tests' recipe, as numpy."""
    ctr = rng.uniform(0, span, (cases, n, 2))
    wh = rng.uniform(2.0, wh_max, (cases, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2],
                           axis=-1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (cases, n)).astype(np.float32)
    if nan_frac:
        scores[rng.uniform(size=scores.shape) < nan_frac] = np.nan
    return boxes, scores


def assert_same_keeps(ref, got, context=""):
    i1, v1 = (np.asarray(a) for a in ref)
    i2, v2 = (np.asarray(a) for a in got)
    assert np.array_equal(v1, v2), f"valid mask mismatch {context}"
    assert np.all((i1 == i2) | ~v1), f"keep indices mismatch {context}"


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ------------------------------------------------------------- box ops
def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    b1, _ = make_cases(rng, 1, 40)
    b2, _ = make_cases(rng, 1, 30)
    b1, b2 = b1[0], b2[0]
    t1, t2 = _t(b1, b2)
    j1, j2 = jnp.asarray(b1), jnp.asarray(b2)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tboxes.box_area(t1).numpy(),
                                  np.asarray(jboxes.box_area(j1)))
    # the IoU NMS thresholds: same float32 operations, equal results
    np.testing.assert_array_equal(tboxes.box_iou(t1, t2).numpy(),
                                  np.asarray(jboxes.box_iou(j1, j2)))
    np.testing.assert_allclose(tboxes.generalized_box_iou(t1, t2).numpy(),
                               np.asarray(jboxes.generalized_box_iou(j1, j2)),
                               **tol)
    p1, p2 = t1[:30], t2
    for kind in ("iou", "giou", "diou", "ciou"):
        np.testing.assert_allclose(
            tboxes.elementwise_box_iou(p1, p2, kind).numpy(),
            np.asarray(jboxes.elementwise_box_iou(j1[:30], j2, kind)), **tol)
    deltas = rng.normal(size=(30, 4)).astype(np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    np.testing.assert_allclose(
        tboxes.encode_boxes(p1, p2, w).numpy(),
        np.asarray(jboxes.encode_boxes(j1[:30], j2, w)), **tol)
    np.testing.assert_allclose(
        tboxes.decode_boxes(torch.from_numpy(deltas), p2, w).numpy(),
        np.asarray(jboxes.decode_boxes(jnp.asarray(deltas), j2, w)),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        tboxes.clip_boxes(t1, (50, 40)).numpy(),
        np.asarray(jboxes.clip_boxes(j1, (50, 40))))
    np.testing.assert_array_equal(
        tboxes.remove_small_boxes_mask(t1, 8.0).numpy(),
        np.asarray(jboxes.remove_small_boxes_mask(j1, 8.0)))
    with pytest.raises(ValueError):
        tboxes.elementwise_box_iou(p1, p2, "nope")


# ---------------------------------------------- keep sets vs JAX greedy
@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_keep_sets_match_jax_reference_1024_cases(config):
    """256 cases a regime, 4 regimes: 1 024 randomized cases, each regime
    one batched call of the port's greedy and blocked sweeps."""
    th, st, mo = CONFIGS[config]
    rng = np.random.default_rng(config)
    boxes, scores = make_cases(rng, 256, 200,
                               nan_frac=0.02 if config == 0 else 0.0)
    ref = jax.jit(jax.vmap(functools.partial(
        jnms.nms_reference, iou_threshold=th, max_out=mo,
        score_threshold=st)))(jnp.asarray(boxes), jnp.asarray(scores))
    tb, ts = _t(boxes, scores)
    greedy = tnms.nms_reference(tb, ts, th, mo, st)
    blocked = tnms.nms_blocked(tb, ts, th, mo, st, block_size=64)
    assert_same_keeps(ref, greedy, f"greedy, config {config}")
    assert_same_keeps(ref, blocked, f"blocked, config {config}")
    assert greedy[0].shape == (256, mo) and greedy[1].dtype == torch.bool
    # padded slots hold index 0, as in JAX
    assert not greedy[0][~greedy[1]].any() and \
        not blocked[0][~blocked[1]].any()


def test_class_aware_batched_nms_matches_jax():
    rng = np.random.default_rng(1)
    boxes, scores = make_cases(rng, 128, 150)
    classes = rng.integers(0, 5, (128, 150)).astype(np.int32)
    ref = jax.jit(jax.vmap(functools.partial(
        jnms.batched_nms, iou_threshold=0.5, max_out=40,
        score_threshold=0.1, impl="greedy")))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    tb, ts, tc = _t(boxes, scores, classes)
    for impl, block in (("greedy", 256), ("blocked", 32), ("pallas", 64)):
        got = tnms.batched_nms(tb, ts, tc, 0.5, 40, score_threshold=0.1,
                               impl=impl, block_size=block)
        assert_same_keeps(ref, got, f"class-aware {impl}")
    # one image, unbatched, and a NaN box that must not poison the offsets
    boxes1 = boxes[0].copy()
    boxes1[3] = np.nan
    ref1 = jnms.batched_nms(jnp.asarray(boxes1), jnp.asarray(scores[0]),
                            jnp.asarray(classes[0]), 0.5, 40, 0.1,
                            impl="greedy")
    got1 = tnms.batched_nms(*_t(boxes1, scores[0], classes[0]), 0.5, 40,
                            score_threshold=0.1, impl="blocked",
                            block_size=32)
    assert got1[0].shape == (40,)
    assert_same_keeps(ref1, got1, "one image with a NaN box")


def test_matches_jax_pallas_kernel_interpreted():
    """A few cases against the TPU kernel itself (interpret mode is slow):
    N not a multiple of the block, tied scores, NaN scores."""
    rng = np.random.default_rng(2)
    boxes, scores = make_cases(rng, 3, 150)
    scores[1, ::3] = scores[1, 0]                       # ties
    scores[2, rng.uniform(size=150) < 0.1] = np.nan     # NaNs
    tb, ts = _t(boxes, scores)
    for i in range(3):
        ref = jpallas_nms.nms_pallas(jnp.asarray(boxes[i]),
                                     jnp.asarray(scores[i]), 0.5, 30,
                                     block_size=64)
        assert_same_keeps(ref, tnms.nms(tb[i], ts[i], 0.5, 30,
                                        impl="pallas", block_size=64),
                          f"pallas case {i}")
        # K3's CPU path (the plain sweep) at its 64-wide padding
        sb, a0, order, _ = tnms.sort_pad_candidates(tb[i:i + 1],
                                                    ts[i:i + 1], -np.inf,
                                                    tnms.WORD)
        alive = tnms.nms_sweep(sb, a0, 0.5, 30)
        assert_same_keeps(ref, tuple(a[0] for a in tnms._emit_from_alive(
            alive, order, 30)), f"nms_sweep case {i}")


# ------------------------------------------------------------ edge cases
def test_edge_cases_match_the_reference():
    # identical boxes: exactly the top-scoring one survives
    boxes = torch.tensor([[10., 10., 20., 20.]]).repeat(64, 1)
    scores = torch.linspace(0.1, 0.9, 64)
    for impl in ("greedy", "blocked", "pallas"):
        idx, valid = tnms.nms(boxes, scores, 0.5, 10, impl=impl,
                              block_size=16)
        assert int(valid.sum()) == 1 and int(idx[0]) == 63
    rng = np.random.default_rng(3)
    # nothing passes the score threshold
    b, s = _t(*make_cases(rng, 2, 80))
    for fn in (tnms.nms_reference, tnms.nms_blocked):
        idx, valid = fn(b, s, 0.5, 20, score_threshold=2.0)
        assert not valid.any() and not idx.any()
    # N = 1, N below the block, N not a multiple of it, max_out > N
    for n, mo in ((1, 5), (7, 32), (70, 16), (100, 128)):
        bx, sc = make_cases(rng, 4, n, span=80.0)
        ref = jax.jit(jax.vmap(functools.partial(
            jnms.nms_reference, iou_threshold=0.5, max_out=mo)))(
            jnp.asarray(bx), jnp.asarray(sc))
        tb, ts = _t(bx, sc)
        for impl in ("greedy", "blocked", "pallas"):
            assert_same_keeps(ref, tnms.nms(tb, ts, 0.5, mo, impl=impl,
                                            block_size=64),
                              f"n={n} max_out={mo} {impl}")


def test_impl_dispatch_on_cpu(monkeypatch):
    """On CPU tensors: "auto" is greedy below 256 candidates and blocked
    above, "pallas" the plain blocked sweep; nothing builds a kernel."""
    from deeplearning_tpu_torch.ops.kernels import build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    cpu = torch.device("cpu")
    assert tnms._resolve_impl("auto", 255, cpu) == "greedy"
    assert tnms._resolve_impl("auto", 256, cpu) == "blocked"
    assert tnms._resolve_impl("pallas", 10, cpu) == "blocked"
    assert tnms._resolve_impl("reference", 10_000, cpu) == "greedy"
    assert tnms._resolve_impl("blocked", 10, cpu) == "blocked"
    # the card takes the kernel for "auto"/"pallas" at every N, the plain
    # versions when the caller names them
    cuda = torch.device("cuda")
    assert tnms._resolve_impl("auto", 1, cuda) == "kernel"
    assert tnms._resolve_impl("pallas", 1, cuda) == "kernel"
    assert tnms._resolve_impl("greedy", 1, cuda) == "greedy"
    assert tnms._resolve_impl("blocked", 1, cuda) == "blocked"
    with pytest.raises(ValueError):
        tnms._resolve_impl("torchvision", 10, cpu)
    with pytest.raises(ValueError):
        tnms.set_default_nms_impl("nope")
    prev = tnms.set_default_nms_impl("greedy")
    try:
        assert tnms.get_default_nms_impl() == "greedy"
        assert tnms._resolve_impl(None, 10_000, cpu) == "greedy"
    finally:
        tnms.set_default_nms_impl(prev)
    before = tnms.launch_counts()
    rng = np.random.default_rng(4)
    tb, ts = _t(*make_cases(rng, 2, 300))
    ref = tnms.nms_reference(tb, ts, 0.5, 50)
    for impl in ("auto", "pallas", None):
        assert_same_keeps(ref, tnms.nms(tb, ts, 0.5, 50, impl=impl), impl)
    assert tnms.launch_counts() == before == {k: 0 for k in
                                              tnms.KERNEL_NAMES}
    with pytest.raises(ValueError):
        tnms.nms(tb[0], ts, 0.5, 5)                      # mismatched ranks
    with pytest.raises(ValueError):
        tnms.nms_sweep(tb, torch.ones(2, 300, dtype=torch.bool), 0.5, 5)


def test_gather_nms_outputs_fill_matches_jax():
    rng = np.random.default_rng(5)
    boxes, scores = make_cases(rng, 3, 60)
    classes = rng.integers(0, 7, (3, 60)).astype(np.int32)
    jidx, jvalid = jax.jit(jax.vmap(functools.partial(
        jnms.nms_reference, iou_threshold=0.3, max_out=50,
        score_threshold=0.6)))(jnp.asarray(boxes), jnp.asarray(scores))
    want = jax.jit(jax.vmap(lambda i, v, b, s, c: jnms.gather_nms_outputs(
        i, v, b, s, c, fill=(0, 0, -1))))(jidx, jvalid, jnp.asarray(boxes),
                                          jnp.asarray(scores),
                                          jnp.asarray(classes))
    tb, ts, tc = _t(boxes, scores, classes)
    idx, valid = tnms.nms_reference(tb, ts, 0.3, 50, 0.6)
    got = tnms.gather_nms_outputs(idx, valid, tb, ts, tc, fill=(0, 0, -1))
    assert not bool(valid.all())          # some slots are padding
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[2][~valid] == -1).all())
    # one image, scalar fill
    one = tnms.gather_nms_outputs(idx[0], valid[0], tb[0], fill=7.0)[0]
    np.testing.assert_array_equal(one.numpy(), np.where(
        valid[0, :, None].numpy(), boxes[0][idx[0].numpy()], 7.0))
    with pytest.raises(ValueError):
        tnms.gather_nms_outputs(idx, valid, tb, ts, fill=(0,))


def test_bound_counts():
    """The card run's bound helpers count from the data."""
    alive0 = torch.tensor([[True] * 5 + [False] * 59])
    alive = torch.tensor([[True, False, True, True] + [False] * 60])
    assert tnms.live_counts(alive0) == [5]
    # 3 keeps hit max_out=3 at position 3: positions 0-3 were seen,
    # against 0, 1, 1 and 2 earlier keeps
    assert tnms.greedy_ious(alive, alive0, 3) == 0 + 1 + 1 + 2
    # max_out not reached: every live candidate (position 4 too) was seen
    assert tnms.greedy_ious(alive, alive0, 10) == 0 + 1 + 1 + 2 + 3
    # positions 0-3 looked at (flag each, box each: all four live), the
    # live count, and the 64-byte output row
    assert tnms.sweep_bytes(alive, alive0, 3) == 4 + 4 * 16 + 4 + 64
    # max_out not reached: all 64 flags, the 5 live boxes
    assert tnms.sweep_bytes(alive, alive0, 10) == 64 + 5 * 16 + 4 + 64
