"""Structural audit over fake-mode traces: the counterpart of
``deeplearning_tpu/analysis/jaxpr.py``.

JAX audits a function by tracing it (``jax.make_jaxpr``): nothing is
compiled or run. Here a function is run once under a
``FakeTensorMode`` with a ``TorchDispatchMode`` that records every op the
dispatcher sees, forward and backward, the kernels' custom ops
(``dltpu::*``) included: fake tensors carry shapes, dtypes, strides and
devices and no data, so nothing is computed and no kernel launches. From
that walk come the same invariants: the peak intermediate (does a
postprocess stay O(N·B)?), the ops by name (``count_ops``, the
counterpart of ``count_primitive``), the transfers (is the train step
free of host syncs?) and the collectives with their operand bytes.

- Transfers are copies between devices (``aten._to_copy`` to another
  device, ``copy_`` across devices) and every ``_local_scalar_dense``
  (``.item()``, ``float()``, ``bool()`` of a tensor). Under fake tensors a
  scalar read has no value: the walk counts it and returns 0.
- Collectives are the process-group ops (``c10d::*``) and the functional
  collectives (``_c10d_functional::*``), named as
  ``parallel/collectives.py`` counts them (``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``broadcast``, ...).

A function's fake tensors come from its arguments (``fake_tensor``,
``fake_module`` build them under one ``fake_mode()``); real arguments are
taken in as constants. A function that caches what it builds (a
detector's predict function keeps its grid tables) keeps the walk's fake
ones: audit a fresh one. JAX's HLO half (``hlo_collectives``) has no
counterpart: the ZeRO-1 rows hold the lowering against the port's own
figures, ``parallel.collectives.launch_counts()`` of one real step over
the running process group.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

__all__ = [
    "fake_mode", "fake_tensor", "fake_module", "trace", "Event",
    "peak_intermediate", "assert_peak_intermediate_below", "count_ops",
    "count_transfers", "count_collectives", "collective_bytes", "Audit",
    "builtin_audits", "run_audits", "COLLECTIVE_NAMES",
]

# the collective ops, by the names parallel/collectives.py counts them
COLLECTIVE_NAMES: Dict[str, str] = {
    "c10d.allreduce_": "all_reduce",
    "c10d.allreduce_coalesced_": "all_reduce",
    "c10d.allgather_": "all_gather",
    "c10d._allgather_base_": "all_gather",
    "c10d.allgather_into_tensor_coalesced_": "all_gather",
    "c10d.allgather_coalesced_": "all_gather",
    "c10d.reduce_scatter_": "reduce_scatter",
    "c10d._reduce_scatter_base_": "reduce_scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "c10d.alltoall_": "all_to_all",
    "c10d.alltoall_base_": "all_to_all",
    "c10d.broadcast_": "broadcast",
    "c10d.reduce_": "reduce",
    "c10d.gather_": "gather",
    "c10d.scatter_": "scatter",
    "c10d.send": "send",
    "c10d.recv_": "recv",
    "c10d.recv_any_source_": "recv",
    "c10d.barrier": "barrier",
    "_c10d_functional.all_reduce": "all_reduce",
    "_c10d_functional.all_reduce_": "all_reduce",
    "_c10d_functional.all_reduce_coalesced": "all_reduce",
    "_c10d_functional.all_gather_into_tensor": "all_gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all_gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce_scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce_scatter",
    "_c10d_functional.all_to_all_single": "all_to_all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
}

_SCALAR_READ = torch.ops.aten._local_scalar_dense.default
_CROSS_COPIES = ("aten._copy_from", "aten._copy_from_and_resize")


class Event:
    """One op the walk saw: its name (``aten.mm``, ``dltpu.flash_fwd``),
    the element counts of its tensor outputs, whether it is a transfer,
    and its collective name and operand bytes (None, 0 otherwise)."""

    __slots__ = ("name", "out_elements", "transfer", "collective",
                 "nbytes")

    def __init__(self, name: str, out_elements: List[int], transfer: bool,
                 collective: Optional[str], nbytes: int):
        self.name = name
        self.out_elements = out_elements
        self.transfer = transfer
        self.collective = collective
        self.nbytes = nbytes

    def __repr__(self) -> str:
        return f"Event({self.name})"


def _is_transfer(func, name: str, args, kwargs) -> bool:
    if func is _SCALAR_READ or name in _CROSS_COPIES:
        return True
    if name == "aten._to_copy":
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev) != args[0].device
    if name == "aten.copy_":
        return args[0].device != getattr(args[1], "device", args[0].device)
    return False


class _Walk(TorchDispatchMode):
    """Records every op below it. Over fake tensors (``fake``) it answers
    a scalar read with 0; over real ones it lets the read run."""

    def __init__(self, fake: bool = True) -> None:
        super().__init__()
        self.fake = fake
        self.events: List[Event] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func._overloadpacket)
        collective = COLLECTIVE_NAMES.get(name)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor)) if collective else 0
        transfer = _is_transfer(func, name, args, kwargs)
        if func is _SCALAR_READ and self.fake:
            self.events.append(Event(name, [], True, None, 0))
            return 0
        out = func(*args, **kwargs)
        self.events.append(Event(
            name, [t.numel() for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor)],
            transfer, collective, nbytes))
        return out


def fake_mode() -> FakeTensorMode:
    """A fake mode for an audit; real tensors that meet its fakes are
    taken in as constants."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_tensor(mode: FakeTensorMode, shape, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """A fake (shape) tensor of ``mode`` on ``device`` (no memory)."""
    with mode:
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def fake_module(module: torch.nn.Module, mode: FakeTensorMode,
                device=None) -> torch.nn.Module:
    """Swap every parameter and buffer of ``module`` (in place) for a fake
    tensor of ``mode`` of the same shape, dtype and strides, on ``device``
    (default: where it lies), and return the module."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                with mode:
                    f = torch.empty_strided(p.shape, p.stride(),
                                            dtype=p.dtype,
                                            device=device or p.device)
                mod._parameters[name] = torch.nn.Parameter(
                    f, requires_grad=p.requires_grad)
        for name, b in list(mod._buffers.items()):
            if b is not None:
                with mode:
                    mod._buffers[name] = torch.empty_strided(
                        b.shape, b.stride(), dtype=b.dtype,
                        device=device or b.device)
    return module


def trace(fn: Callable, *args, **kwargs) -> List[Event]:
    """Run ``fn(*args, **kwargs)`` once under fake tensors and return every
    op it dispatched, in order. The fake mode is the arguments' (their
    first fake tensor's), else a fresh one."""
    mode = next((t.fake_mode for t in tree_leaves((args, kwargs))
                 if isinstance(t, FakeTensor)), None) or fake_mode()
    walk = _Walk()
    with mode:
        args, kwargs = tree_map(
            lambda t: mode.from_tensor(t)
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor)
            else t, (args, kwargs))
        with walk:
            fn(*args, **kwargs)
    return walk.events


def peak_intermediate(fn: Callable, *args, **kwargs) -> int:
    """Largest intermediate (in ELEMENTS, not bytes) any op of
    ``fn(*args)`` produces; 0 when there are no tensor outputs. Scalars
    count as 1 element."""
    return max((n for ev in trace(fn, *args, **kwargs)
                for n in ev.out_elements), default=0)


def assert_peak_intermediate_below(fn: Callable, args: Tuple,
                                   max_elements: int,
                                   msg: str = "") -> int:
    """Assert ``fn(*args)`` never materializes an intermediate above
    ``max_elements`` elements. Returns the measured peak."""
    peak = peak_intermediate(fn, *args)
    if peak > max_elements:
        raise AssertionError(
            f"peak intermediate {peak} elements exceeds budget "
            f"{max_elements}" + (f" ({msg})" if msg else ""))
    return peak


def count_ops(fn: Callable, name, *args, **kwargs) -> int:
    """Occurrences of op(s) ``name`` (a str or tuple of strs, such as
    ``"aten.mm"`` or ``"dltpu.flash_fwd"``) in ``fn(*args)``."""
    names = (name,) if isinstance(name, str) else tuple(name)
    return sum(1 for ev in trace(fn, *args, **kwargs) if ev.name in names)


def _op_counts(events: List[Event]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ev in events:
        out[ev.name] = out.get(ev.name, 0) + 1
    return out


def count_transfers(fn: Callable, *args, **kwargs) -> int:
    """Transfers inside ``fn(*args)``. The sync-free hot-loop contract
    says this is 0 for the train step: batches arrive placed
    (DevicePrefetcher) and metrics leave lazily, so nothing inside the
    step moves bytes or waits for the card itself."""
    return sum(ev.transfer for ev in trace(fn, *args, **kwargs))


def _collectives(events: List[Event], field: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ev in events:
        if ev.collective is not None:
            out[ev.collective] = out.get(ev.collective, 0) + (
                1 if field == "count" else ev.nbytes)
    return out


def count_collectives(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Counts of collectives in ``fn(*args)`` by name
    (``{"all_reduce": 2, "all_gather": 1}``); empty when there is none."""
    return _collectives(trace(fn, *args, **kwargs), "count")


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Operand bytes of the collectives in ``fn(*args)``, summed by name:
    what each puts on the wire before any topology-aware lowering."""
    return _collectives(trace(fn, *args, **kwargs), "bytes")


# --------------------------------------------------------------- audits
class Audit:
    """One registered structural check: walk ``fn(*args)`` once, measure
    the peak, the transfers, the collectives and the counts of ``ops``,
    and compare with the budgets. ``max_elements=None`` means unbounded
    (the reference rows show that the audit SEES a blow-up);
    ``want_ops`` maps op names to the count each must reach exactly."""

    def __init__(self, name: str, fn: Callable, args: Tuple, *,
                 max_elements: Optional[int] = None,
                 max_transfers: Optional[int] = 0,
                 min_elements: Optional[int] = None,
                 want_ops: Optional[Dict[str, int]] = None,
                 extra: Optional[Callable[[], Tuple[bool, Dict]]] = None,
                 note: str = ""):
        self.name = name
        self.fn = fn
        self.args = args
        self.max_elements = max_elements
        self.max_transfers = max_transfers
        self.min_elements = min_elements
        self.want_ops = want_ops or {}
        self.extra = extra
        self.note = note

    def run(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {"name": self.name, "note": self.note}
        try:
            events = trace(self.fn, *self.args)
            row["peak_elements"] = max(
                (n for ev in events for n in ev.out_elements), default=0)
            row["transfers"] = sum(ev.transfer for ev in events)
            row["collectives"] = _collectives(events, "count")
            counts = _op_counts(events)
            row["ops"] = {k: counts.get(k, 0) for k in self.want_ops}
            ok = row["ops"] == self.want_ops
            if self.max_elements is not None:
                row["budget_elements"] = self.max_elements
                ok &= row["peak_elements"] <= self.max_elements
            if self.min_elements is not None:
                ok &= row["peak_elements"] >= self.min_elements
            if self.max_transfers is not None:
                ok &= row["transfers"] <= self.max_transfers
            if self.extra is not None:
                extra_ok, extra_row = self.extra()
                row.update(extra_row)
                ok &= extra_ok
            row["ok"] = bool(ok)
        except Exception as e:  # noqa: BLE001 - a broken audit must report
            row["ok"] = False
            row["error"] = repr(e)
        return row


def _audit_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _train_state(name: str, mode: FakeTensorMode, dev: torch.device,
                 **kw):
    """A fake ``TrainState`` of registry model ``name`` (built on the CPU,
    then swapped for fakes on ``dev``) under AdamW."""
    from .. import models  # noqa: F401  (registers the factories)
    from ..core.registry import MODELS
    from ..train import TrainState
    from ..train.optim import build_optimizer
    from ..train.schedules import build_schedule
    model = fake_module(MODELS.build(name, **kw), mode, dev)
    with mode:
        tx = build_optimizer("adamw", build_schedule("constant",
                                                     base_lr=1e-3),
                             weight_decay=0.05,
                             params=dict(model.named_parameters()))
        return TrainState.create(model=model, tx=tx)


def _batch(mode: FakeTensorMode, dev: torch.device,
           shape) -> Dict[str, torch.Tensor]:
    return {"image": fake_tensor(mode, shape, device=dev),
            "label": fake_tensor(mode, shape[:1], torch.long, dev)}


def builtin_audits(device=None) -> List[Audit]:
    """The registered step and postprocess functions with their
    structural budgets, traced on ``device`` (default: the card when
    there is one). The counterparts of JAX's rows:

    - K3's NMS route stays O(N) around one ``dltpu.nms_sweep`` node (JAX's
      blocked-NMS row bounds its O(N·B) sweep; here the sweep is the
      kernel, so the row bounds the port's own sort, pad and emit);
    - the reference NMS row proves the audit sees an N×N buffer;
    - one-pass multiscale RoIAlign traces with no transfer;
    - the mnist train step traces with zero transfers;
    - interleaved two-tenant zoo dispatch leaves every engine's
      trace/compile counters where warmup put them (a real run);
    - ViT-B/16's train step on K1 (flash_hb) at depth 2: 2 forward, 2 dQ
      and 2 dK/dV kernel nodes and zero transfers;
    - (a process group of >= 2 ranks only) one real ZeRO-1 step issues
      reduce-scatters and all-gathers and no all-reduce of gradients
      (``collectives.launch_counts()``), with the replicated step as the
      control row that does all-reduce them.
    """
    from ..ops import nms as nms_ops
    from ..ops import roi_align as roi_ops

    dev = _audit_device(device)
    audits: List[Audit] = []
    n = 4096
    mode = fake_mode()
    boxes = fake_tensor(mode, (1, n, 4), device=dev)
    scores = fake_tensor(mode, (1, n), device=dev)
    audits.append(Audit(
        f"nms_k3_n{n}",
        partial(nms_ops._nms_kernel, iou_threshold=0.5, max_out=100,
                score_threshold=float("-inf")),
        (boxes, scores),
        max_elements=4 * (n + nms_ops.WORD),
        want_ops={"dltpu.nms_sweep": 1},
        note="K3 is one node; the sort, pad and emit around it are O(N) "
             "(JAX's row: the blocked sweep's O(N*B))"))
    audits.append(Audit(
        f"nms_reference_n{n}",
        partial(nms_ops.nms_reference, iou_threshold=0.5, max_out=100),
        (boxes, scores),
        min_elements=n * n,
        note="control: the audit must SEE the N^2 buffer"))

    pyr = {f"p{lv}": fake_tensor(mode, (64 >> (lv - 2), 64 >> (lv - 2), 8),
                                 device=dev)
           for lv in (2, 3, 4, 5)}
    rois = fake_tensor(mode, (16, 4), device=dev)
    audits.append(Audit(
        "roi_align_onepass", partial(roi_ops.multiscale_roi_align),
        (pyr, rois), note="one-pass multiscale gather"))

    def train_step_audit(name: str, model: str, image_shape, want_ops,
                         note: str, **kw) -> Audit:
        from ..train import make_train_step
        from ..train.classification import make_loss_fn
        m = fake_mode()
        state = _train_state(model, m, dev, **kw)
        batch = _batch(m, dev, image_shape)
        step = make_train_step(make_loss_fn(), device=dev)
        return Audit(name, step, (state, batch, 0), max_transfers=0,
                     want_ops=want_ops, note=note)

    audits.append(train_step_audit(
        "train_step_mnist", "mnist_fcn", (8, 16, 16, 1), {},
        "hot-loop step: zero transfers", num_classes=4, in_chans=1,
        img_size=16, dtype=torch.float32))
    audits.append(train_step_audit(
        "train_step_vit_b16_flash_hb_depth2", "vit_base_patch16_224",
        (2, 224, 224, 3),
        {"dltpu.flash_fwd": 2, "dltpu.flash_bwd_dq": 2,
         "dltpu.flash_bwd_dkv": 2},
        "K1 one node a launch: fwd, dQ, dK/dV once a block; zero transfers",
        depth=2, attn_fn=_flash_hb()))

    def zoo_multimodel_audit() -> Audit:
        import numpy as np

        from ..serve import MicroBatcher, ModelZoo

        def extra():
            zoo = ModelZoo()
            # mnist_cnn at 28² (JAX's row: mnist_fcn at 16², whose flax
            # module infers its input width; the port's is fixed at 28²)
            for alias in ("a", "b"):
                zoo.register(alias, "mnist_cnn", num_classes=4,
                             image_size=28, batch_buckets=(1, 2),
                             device=str(dev))
                zoo.load(alias, wait=True)
            warm = {a: (zoo.engine(a).trace_count,
                        zoo.engine(a).compile_count) for a in ("a", "b")}
            img = np.zeros((28, 28, 3), np.float32)
            with MicroBatcher(zoo=zoo, max_wait_ms=1.0) as mb:
                handles = [mb.submit(img, model=("a", "b")[i % 2])
                           for i in range(8)]
                for h in handles:
                    h.result(timeout=120.0)
            ok, row = True, {}
            for a in ("a", "b"):
                eng = zoo.engine(a)
                row[f"{a}_trace_count"] = eng.trace_count
                row[f"{a}_compile_count"] = eng.compile_count
                ok &= (eng.trace_count, eng.compile_count) == warm[a]
            return ok, row

        # the walked fn is a placeholder; the audit's substance is the
        # extra() pass driving interleaved dispatch through two warm
        # engines and checking that their counters never move
        return Audit("zoo_multimodel", lambda x: x + 1,
                     (fake_tensor(mode, (1,)),), extra=extra,
                     note="interleaved 2-tenant dispatch: zero "
                          "retraces after warmup")

    audits.append(zoo_multimodel_audit())

    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() >= 2:
        audits.extend(_zero1_audits(dev))
    return audits


def _flash_hb():
    from ..ops.attention import get_attn_fn
    return get_attn_fn("flash_hb")


def _zero1_audits(dev: torch.device) -> List[Audit]:
    """One real step each of ZeRO-1 and the replicated update of
    mnist_fcn over the running process group, read through
    ``collectives.launch_counts()`` (JAX reads the compiled HLO)."""
    import torch.distributed as dist

    from .. import models  # noqa: F401  (registers the factories)
    from ..core.registry import MODELS
    from ..parallel import collectives
    from ..parallel.mesh import MeshConfig, build_mesh
    from ..train import TrainState, make_train_step
    from ..train.classification import make_loss_fn
    from ..train.optim import build_optimizer
    from ..train.schedules import build_schedule
    from ..train.steps import shard_state

    n_dev = dist.get_world_size()
    mesh = build_mesh(MeshConfig(data=-1), device=dev)
    out: List[Audit] = []
    for mode in ("zero1", "replicated"):
        def extra(mode=mode):
            torch.manual_seed(0)
            model = MODELS.build("mnist_fcn", num_classes=4, in_chans=1,
                                 img_size=16, dtype=torch.float32).to(dev)
            tx = build_optimizer("adamw", build_schedule(
                "constant", base_lr=1e-3),
                params=dict(model.named_parameters()))
            state = shard_state(TrainState.create(model=model, tx=tx),
                                mesh, zero1=(mode == "zero1"))
            step = make_train_step(make_loss_fn(), mesh=mesh,
                                   weight_update=mode)
            batch = {"image": torch.zeros((8, 16, 16, 1), device=dev),
                     "label": torch.zeros((8,), dtype=torch.long,
                                          device=dev)}
            # the biggest parameter is the threshold for "param-sized":
            # an all-reduce at or above it means the gradient all-reduce
            # survived; smaller ones are the metrics' and the tail's
            param_bytes = max(p.numel() * p.element_size()
                              for p in model.parameters())
            before = collectives.launch_counts()
            walk = _Walk(fake=False)   # the real ops' operand bytes
            with walk:
                step(state, batch, 0)
            after = collectives.launch_counts()
            calls = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            ar_max = max((ev.nbytes for ev in walk.events
                          if ev.collective == "all_reduce"), default=0)
            if mode == "zero1":
                ok = (calls.get("reduce_scatter", 0) >= 1
                      and calls.get("all_gather", 0) >= 1
                      and ar_max < param_bytes)
            else:
                ok = ar_max >= param_bytes
            return ok, {"collective_calls": calls,
                        "collective_bytes": _collectives(walk.events,
                                                         "bytes")}

        out.append(Audit(
            f"train_step_{mode}_dp{n_dev}", lambda x: x + 1,
            (torch.zeros(1),), max_transfers=0, extra=extra,
            note=("gradients reduce-scattered, parameters all-gathered"
                  if mode == "zero1" else
                  "control: the gradients all-reduced")))
    return out


def run_audits(audits: Optional[List[Audit]] = None, device=None
               ) -> List[Dict[str, Any]]:
    if audits is None:
        audits = builtin_audits(device)
    return [a.run() for a in audits]
