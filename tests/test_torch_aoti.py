"""The serving artifact of the port: ``export_savedmodel`` (an
AOTInductor package), the C++ runner ``native/aoti_runner.cc`` and the
C++ registration of the kernel ops ``native/dltpu_ops.cpp``, both built
by ``native/build.py`` — the counterparts of JAX's SavedModel export and
``native/savedmodel_runner.cc``. No JAX here.

On the CPU:
- the C++ schemas of ``dltpu::flash_fwd``, ``window_attn`` and
  ``nms_sweep`` are the Python ones, and each op's C++ CPU impl gives the
  Python op's result on seeded inputs (attention within 2e-5, with the
  strides of ``bnhd`` true and false; NMS keep sets equal). The library
  runs in a child process that imports torch only (``torch_ops_child.py``):
  it defines the same names as the Python ops;
- a depth-2, width-64, 4-head ViT on ``flash_hb`` is packaged by
  ``export_savedmodel`` and run by the runner on the JAX runner's ramp:
  its shape, first 16 values and whole output (the file the runner writes)
  equal the eager port's within 1e-5, and its ``launches:`` line counts 2
  ``flash_fwd`` runs;
- without the op library the runner exits non-zero, naming
  ``dltpu::flash_fwd``;
- a detector's predict traced first (a fake-mode walk, as ``torch.export``
  traces it) still returns real tensors when called eagerly after.

On the card (marked ``cuda``; skipped here): the C++ CUDA impls launch
the same kernels as the Python ops at the zoo's served shapes and give
their results bit for bit, and a depth-2 Swin-T package (K2) and YOLOX-S's
fixed-shape predict package (K3) run in the runner against eager.

    python -m pytest tests/test_torch_aoti.py -m cuda -q     # on a card
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deeplearning_tpu_torch import hub
from deeplearning_tpu_torch import models  # noqa: F401  (registry)
from deeplearning_tpu_torch.export import serialize
from deeplearning_tpu_torch.native import build
from deeplearning_tpu_torch.ops import nms as nms_ops
from deeplearning_tpu_torch.ops import flash_attention  # noqa: F401
from deeplearning_tpu_torch.ops import window_attention  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "torch_ops_child.py")
VIT = "vit_base_patch16_224"
TINY_VIT = dict(depth=2, embed_dim=64, num_heads=4, img_size=32)
RAMP_DIMS = (2, 32, 32, 3)
ATTN_TOL = 2e-5


def ramp(dims):
    """The runners' input: 0.001f * (i % 1000) in float32, row-major."""
    n = int(np.prod(dims))
    vals = np.float32(0.001) * (np.arange(n) % 1000).astype(np.float32)
    return torch.from_numpy(vals.reshape(dims))


def run_runner(runner, package, ops, dims, out=None):
    """The runner on ``package``; ``out``: where it writes its whole
    first output (float32, row-major)."""
    cmd = [str(runner), str(package), str(ops) if ops else "-",
           ",".join(map(str, dims))] + (["0", str(out)] if out else [])
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def parse_runner(stdout):
    """{"shape", "values", "launches"} from the runner's lines."""
    out = {}
    for line in stdout.splitlines():
        key, _, rest = line.partition(":")
        if key == "output_shape":
            out["shape"] = tuple(int(v) for v in rest.split())
        elif key == "values":
            out["values"] = np.array([float(v) for v in rest.split()])
        elif key == "launches":
            out["launches"] = {k: int(v) for k, v in
                               (kv.split("=") for kv in rest.split())}
        elif key == "forward_ms":
            out["forward_ms"] = float(rest)
    return out


def run_child(lib, tmp_path, device, calls):
    inp, out = tmp_path / "calls_in.pt", tmp_path / "calls_out.pt"
    torch.save({"device": device, "calls": calls}, inp)
    proc = subprocess.run([sys.executable, CHILD, str(lib), str(inp),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ,
                                                OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return torch.load(out, weights_only=False)


def python_results(calls, device):
    """The Python ops' results of ``calls`` on ``device``, as the child
    returns them: [(CPU tensor, strides), ...] a call."""
    results = []
    for name, args in calls:
        args = [a.to(device) if isinstance(a, torch.Tensor) else a
                for a in args]
        res = getattr(torch.ops.dltpu, name)(*args)
        res = res if isinstance(res, tuple) else (res,)
        results.append([(t.cpu(), tuple(t.stride())) for t in res])
    return results


def _qkv(rng, shape, dtype=torch.float32, bnhd=False):
    """Three (B, H, N, D) tensors from numpy; ``bnhd``: views of
    contiguous (B, N, H, D) ones, the models' layout."""
    b, h, n, d = shape
    out = []
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(b, n, h, d) if bnhd
                                        else shape).astype(np.float32))
        x = x.to(dtype)
        out.append(x.transpose(1, 2) if bnhd else x)
    return out


def _window_args(rng, bw, n, heads, d, nw, dtype=torch.float32):
    qkv = torch.from_numpy(rng.normal(size=(bw, n, 3, heads, d)).astype(
        np.float32)).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(heads, n, n)).astype(
        np.float32))
    mask = None
    if nw:
        mask = torch.from_numpy(np.where(rng.random((nw, n, n)) < 0.3,
                                         -100.0, 0.0).astype(np.float32))
    return qkv, bias, mask


def _sweep_args(rng, b, n):
    xy = rng.uniform(0, 600, size=(b, n, 2))
    wh = rng.uniform(4, 120, size=(b, n, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    scores = torch.from_numpy(rng.random((b, n)).astype(np.float32))
    sboxes, alive0, _, _ = nms_ops.sort_pad_candidates(
        boxes, scores, float("-inf"), nms_ops.WORD)
    return sboxes, alive0


def cpu_calls():
    rng = np.random.default_rng(0)
    calls = []
    for shape, dtype, causal, bnhd in (
            ((2, 4, 17, 16), torch.float32, False, False),
            ((2, 4, 17, 16), torch.float32, True, True),
            ((1, 2, 65, 80), torch.float32, False, True),
            ((2, 4, 9, 32), torch.bfloat16, False, True)):
        q, k, v = _qkv(rng, shape, dtype, bnhd)
        calls.append(("flash_fwd", [q, k, v, shape[-1] ** -0.5, causal, 4,
                                    bnhd]))
    for bw, n, heads, d, nw in ((8, 49, 3, 32, 4), (4, 49, 2, 24, 0)):
        qkv, bias, mask = _window_args(rng, bw, n, heads, d, nw)
        calls.append(("window_attn", [qkv, bias, mask, 8]))
    for th, max_out in ((0.5, 20), (0.3, 500)):
        sboxes, alive0 = _sweep_args(rng, 3, 200)
        calls.append(("nms_sweep", [sboxes, alive0, th, max_out]))
    return calls


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The op library and the runner (one g++ each, in the background)
    and the tiny ViT's package, with its eager output on the ramp."""
    d = tmp_path_factory.mktemp("aoti")
    with ThreadPoolExecutor(1) as pool:
        builds = pool.submit(build.build_serving)
        model, _ = hub.load(VIT, num_classes=10, seed=0, device="cpu",
                            dtype=torch.float32, **TINY_VIT,
                            **hub.model_kwargs(VIT, "flash_hb"))
        x = ramp(RAMP_DIMS)
        package = d / "vit.pt2"
        assert serialize.export_savedmodel(model, [x], package) is True
        with torch.no_grad():
            want = model(x)
        built = builds.result()
    return {"ops": built["dltpu_ops"][0], "runner": built["aoti_runner"][0],
            "package": package, "want": want, "dir": d}


@pytest.fixture(scope="module")
def cpu_child(artifacts):
    calls = cpu_calls()
    return calls, run_child(artifacts["ops"], artifacts["dir"], "cpu", calls)


def test_cpp_schemas_are_the_python_ones(cpu_child):
    _, got = cpu_child
    for name, schema in got["schemas"].items():
        assert schema == str(getattr(torch.ops.dltpu, name).default._schema)


def test_cpp_cpu_impls_equal_the_python_ops(cpu_child):
    calls, got = cpu_child
    want = python_results(calls, "cpu")
    assert len(got["results"]) == len(calls)
    for (name, args), g, w in zip(calls, got["results"], want):
        assert not isinstance(g, str), f"{name}: {g}"
        for (gt, gs), (wt, ws) in zip(g, w):
            assert gs == ws and gt.dtype == wt.dtype, name
            if name == "nms_sweep":
                assert torch.equal(gt, wt)
            else:
                torch.testing.assert_close(gt.float(), wt.float(),
                                           atol=ATTN_TOL, rtol=ATTN_TOL)
    count = {n: sum(c[0] == n for c in calls) for n in got["plain_runs"]}
    assert got["plain_runs"] == count
    assert got["launches"] == dict.fromkeys(count, 0)


def test_cpp_ops_check_their_arguments(artifacts, tmp_path):
    q = torch.zeros(1, 2, 3, 4)
    calls = [("flash_fwd", [q, q[:, :1], q, 0.5, False, 1, False]),
             ("window_attn", [torch.zeros(2, 4, 3, 1, 8),
                              torch.zeros(1, 4, 4), torch.zeros(3, 4, 4), 1]),
             ("nms_sweep", [torch.zeros(1, 60, 4),
                            torch.ones(1, 60, dtype=torch.bool), 0.5, 4])]
    got = run_child(artifacts["ops"], tmp_path, "cpu", calls)
    msgs = got["results"]
    assert "must share one (B, H, N, D) shape" in msgs[0]
    assert "nW dividing BW=2" in msgs[1]
    assert "multiple of 64, got 60" in msgs[2]


def test_runner_runs_the_vit_package(artifacts):
    out = artifacts["dir"] / "vit_out.f32"
    proc = run_runner(artifacts["runner"], artifacts["package"],
                      artifacts["ops"], RAMP_DIMS, out)
    assert proc.returncode == 0, proc.stderr
    got = parse_runner(proc.stdout)
    want = artifacts["want"]
    assert got["shape"] == tuple(want.shape)
    np.testing.assert_allclose(got["values"],
                               want.flatten()[:16].numpy(), atol=1e-5,
                               rtol=0)
    whole = np.fromfile(out, np.float32).reshape(got["shape"])
    np.testing.assert_allclose(whole, want.numpy(), atol=1e-5, rtol=0)
    assert got["launches"] == {"flash_fwd": TINY_VIT["depth"],
                               "window_attn": 0, "nms_sweep": 0}


def test_runner_without_the_op_library_names_the_op(artifacts):
    proc = run_runner(artifacts["runner"], artifacts["package"], None,
                      RAMP_DIMS)
    assert proc.returncode != 0
    assert "dltpu::flash_fwd" in proc.stderr
    assert "output_shape" not in proc.stdout


def test_a_traced_predict_leaves_its_eager_grids_real():
    """A detector's predict caches its grid tables a size; a fake-mode walk
    (an audit) or ``torch.export`` of it first must not cache fake ones,
    or every later eager call returns fake tensors."""
    from deeplearning_tpu_torch.analysis import audit
    from deeplearning_tpu_torch.models.detection.predict import (
        build_predict_fn)
    model, _ = hub.load("yolox_nano", num_classes=3, seed=0, device="cpu",
                        dtype=torch.float32)
    predict = build_predict_fn(model, "yolox_nano", 3, score_thresh=0.0,
                               max_det=10)
    mode = audit.fake_mode()
    with torch.no_grad():
        audit.trace(predict, audit.fake_tensor(mode, (1, 64, 64, 3)))
    x = ramp((1, 64, 64, 3))
    got = predict(x)
    want = build_predict_fn(model, "yolox_nano", 3, score_thresh=0.0,
                            max_det=10)(x)
    assert all(type(v) is torch.Tensor and torch.equal(v, want[k])
               for k, v in got.items())


# ------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernels have no CPU mode")
    from deeplearning_tpu_torch.ops.kernels import build as kernels
    kernels.build_all()
    built = build.build_serving()
    return {"ops": built["dltpu_ops"][0], "runner": built["aoti_runner"][0],
            "dir": tmp_path_factory.mktemp("aoti_card")}


def _hold_bit_equal(calls, got):
    want = python_results(calls, "cuda")
    for (name, args), g, w in zip(calls, got["results"], want):
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        assert not isinstance(g, str), f"{name} {shapes}: {g}"
        for (gt, gs), (wt, ws) in zip(g, w):
            assert gs == ws, f"{name} {shapes}: strides {gs} != {ws}"
            assert torch.equal(gt, wt), f"{name} {shapes}"
    assert got["launches"][calls[0][0]] >= len(calls)


@pytest.mark.cuda
def test_cpp_flash_fwd_on_the_card_is_the_python_ops(card):
    """ViT-B/16's (8, 12, 197, 64), MAE's (64, 16, 196, 32), ViT-H/14's
    D = 80 (padded to 128) and D = 320 (the wide kernel), at 1, 2 and 4
    heads a CTA, in both dtypes and layouts."""
    rng = np.random.default_rng(1)
    calls = []
    for shape, hpc in (((8, 12, 197, 64), 4), ((8, 12, 197, 64), 1),
                       ((64, 16, 196, 32), 4), ((2, 16, 257, 80), 4),
                       ((2, 4, 65, 320), 2)):
        for dtype in (torch.bfloat16, torch.float32):
            for bnhd in (True, False):
                q, k, v = _qkv(rng, shape, dtype, bnhd)
                calls.append(("flash_fwd", [q, k, v, shape[-1] ** -0.5,
                                            False, hpc, bnhd]))
    got = run_child(card["ops"], card["dir"], "cuda", calls)
    _hold_bit_equal(calls, got)


@pytest.mark.cuda
def test_cpp_window_attn_on_the_card_is_the_python_ops(card):
    """Swin-T's four stages at 224² (N = 49) and at 384² (N = 144), batch
    2, with their shift masks, in both dtypes."""
    rng = np.random.default_rng(2)
    calls = []
    for n in (49, 144):
        for windows, heads, nw in ((64, 3, 64), (16, 6, 16), (4, 12, 4),
                                   (1, 24, 0)):
            for dtype in (torch.bfloat16, torch.float32):
                qkv, bias, mask = _window_args(rng, 2 * windows, n, heads,
                                               32, nw, dtype)
                calls.append(("window_attn", [qkv, bias, mask, 8]))
    got = run_child(card["ops"], card["dir"], "cuda", calls)
    _hold_bit_equal(calls, got)


@pytest.mark.cuda
def test_cpp_nms_sweep_on_the_card_is_the_python_ops(card):
    """YOLOX-S's served batch: 32 images of 8 400 candidates."""
    rng = np.random.default_rng(3)
    calls = []
    for th, max_out in ((0.65, 100), (0.45, 300)):
        sboxes, alive0 = _sweep_args(rng, 32, 8400)
        calls.append(("nms_sweep", [sboxes, alive0, th, max_out]))
    got = run_child(card["ops"], card["dir"], "cuda", calls)
    _hold_bit_equal(calls, got)


def _package_and_run(card, name, module, x):
    """The runner's parsed lines, with its whole first output under
    "whole", and eager's first output."""
    package = card["dir"] / f"{name}.pt2"
    serialize.export_savedmodel(module, [x], package)
    with torch.no_grad():
        want = module(x)
    want = want[0] if isinstance(want, tuple) else want
    out = card["dir"] / f"{name}_out.f32"
    proc = run_runner(card["runner"], package, card["ops"],
                      tuple(x.shape), out)
    assert proc.returncode == 0, proc.stderr
    got = parse_runner(proc.stdout)
    got["whole"] = np.fromfile(out, np.float32).reshape(got["shape"])
    return got, want.float().cpu()


@pytest.mark.cuda
def test_runner_runs_a_swin_package_on_k2(card):
    """Swin-T at depth 2 (one block in each of its first two stages),
    float32, batch 2 at 224²: the ramp's logits, all of them, against
    eager's."""
    name = "swin_tiny_patch4_window7_224"
    model, _ = hub.load(name, num_classes=1000, seed=0, device="cuda",
                        depths=(1, 1), num_heads=(3, 6), dtype=torch.float32,
                        **hub.model_kwargs(name, "flash_hb"))
    got, want = _package_and_run(card, "swin", model,
                                 ramp((2, 224, 224, 3)).cuda())
    assert got["shape"] == tuple(want.shape)
    np.testing.assert_allclose(got["values"], want.flatten()[:16].numpy(),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["whole"], want.numpy(), atol=1e-3,
                               rtol=0)
    assert got["launches"] == {"flash_fwd": 0, "window_attn": 2,
                               "nms_sweep": 0}


@pytest.mark.cuda
def test_runner_runs_a_yolox_predict_package_on_k3(card):
    """YOLOX-S's predict at 640², batch 2, float32, as one fixed-shape
    package: the scores of the ramp's first detections (sorted, so a tie's
    order does not matter) against eager's, one K3 launch."""
    from deeplearning_tpu_torch.models.detection.predict import (
        build_predict_fn)
    model, _ = hub.load("yolox_s", num_classes=80, seed=0, device="cuda",
                        dtype=torch.float32)
    predict = build_predict_fn(model, "yolox_s", 80, score_thresh=0.0,
                               max_det=100)

    class Predict(torch.nn.Module):
        def forward(self, x):
            det = predict(x)
            return det["scores"], det["boxes"], det["labels"]
    got, want = _package_and_run(card, "yolox", Predict(),
                                 ramp((2, 640, 640, 3)).cuda())
    assert got["shape"] == tuple(want.shape)
    np.testing.assert_allclose(got["values"], want.flatten()[:16].numpy(),
                               atol=1e-4, rtol=0)
    assert got["launches"] == {"flash_fwd": 0, "window_attn": 0,
                               "nms_sweep": 1}
