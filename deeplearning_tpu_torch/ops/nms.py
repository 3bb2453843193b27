"""Padded top-k NMS: the port of ``deeplearning_tpu/ops/nms.py`` and of
its Pallas kernel ``deeplearning_tpu/ops/pallas/nms.py`` (K3).

One contract for every path: boxes (B, N, 4) and scores (B, N) go in,
(idx (B, max_out), valid (B, max_out) bool) come out, the keeps in
descending-score order (stable: ties keep the lower index), padded slots
with idx 0 and valid False. A single image's (N, 4) / (N,) is taken too
and gives (max_out,) results. The JAX functions are per image and ``vmap``
over the batch; here the batch is a dimension, so 256 test cases go in one
call and the serving engine makes one call a batch.

Paths (each gives the same keep set as ``nms_reference``, the greedy
oracle):

- ``nms_reference``: greedy, ``max_out`` rounds of argmax + suppress over
  the full (B, N, N) IoU matrix.
- ``nms_blocked``: the blocked sweep, plain PyTorch. Sort once, walk
  B-wide blocks in score order; a block's own keep set is the fixed point
  of its strictly upper-triangular IoU > threshold relation, and one
  (block, N) IoU tile then kills every later candidate a kept box
  overlaps. Stops once ``max_out`` keeps are in.
- the K3 kernel, ``csrc/nms_sweep.cu``: the same sort and padding around
  one launch a batch, bound as the ``torch.library`` op
  ``dltpu::nms_sweep`` with a fake implementation (one node in an export
  or a fake-mode trace). ``nms_greedy_sweep`` (one CTA an image) walks the
  candidates in score order, 64 at a time: each is tested against the
  boxes kept so far, the block's own keeps are resolved in greedy order
  from its 64 x 64 IoU > threshold bits, and the walk stops at ``max_out``
  keeps. Candidates sort into a prefix of live ones (NaN and -inf scores
  last), so it also stops at the last live candidate.

Dispatch (``nms(impl=...)``), by where the tensors lie: on the card,
"auto" and "pallas" launch K3 at every N (the JAX 1 024 threshold was the
TPU's cost policy; the keep set is the same by contract); on the CPU,
"auto" takes greedy below 256 candidates and the blocked sweep above, and
"pallas" the plain blocked sweep. "greedy"/"reference" and "blocked" run
the plain versions wherever the tensors lie, because the caller named
them. A launch that fails raises: nothing falls back to a plain version.

IoU arithmetic is ``ops/boxes.box_iou``'s in float32, compared with
``> iou_threshold`` rounded to float32; the kernel rounds every operation
the same way (no contracted multiply-adds, IEEE division, NaN-propagating
min/max), so the kernel's and the plain versions' keep sets are equal, not
close.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .boxes import box_iou
from .kernels import define_op

__all__ = ["DEFAULT_BLOCK_SIZE", "KERNEL_NAMES", "WORD", "set_default_nms_impl",
           "get_default_nms_impl", "nms_reference", "sort_pad_candidates",
           "nms_blocked", "nms_sweep", "nms_sweep_plain", "nms", "batched_nms",
           "class_offset_boxes", "gather_nms_outputs", "launch_counts", "reset_launch_counts",
           "live_counts", "greedy_ious", "sweep_bytes", "OPS_PER_IOU"]

# Tile width of the plain blocked sweep (the JAX default)
DEFAULT_BLOCK_SIZE = 256
# K3 pads candidates to whole 64-candidate blocks (one 64-bit word each)
WORD = 64
KERNEL_NAMES = ("nms_greedy_sweep",)
# kept boxes the kernel holds in shared memory; past them, a global list
# (csrc/nms_sweep.cu kMaxKeptSmem)
KEPT_SMEM = 10240
# float32 operations of one IoU (max, max, min, min, sub, sub, clamp,
# clamp, mul, add, sub, max, div) and its threshold compare
OPS_PER_IOU = 14

_AUTO_BLOCKED_MIN = 256
_VALID_IMPLS = ("auto", "greedy", "reference", "blocked", "pallas")
_default_impl = "auto"

# bumped right after a successful launch, nowhere else
_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
_CAPABILITY: Dict[int, Tuple[int, int]] = {}


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def set_default_nms_impl(impl: str) -> str:
    """Set the default for ``nms(impl=None)``; returns the previous one."""
    global _default_impl
    if impl not in _VALID_IMPLS:
        raise ValueError(f"nms impl must be one of {_VALID_IMPLS}, "
                         f"got {impl!r}")
    prev = _default_impl
    _default_impl = impl
    return prev


def get_default_nms_impl() -> str:
    return _default_impl


def _resolve_impl(impl: Optional[str], n: int, device: torch.device) -> str:
    """"greedy", "blocked" or "kernel"."""
    impl = _default_impl if impl is None else impl
    if impl not in _VALID_IMPLS:
        raise ValueError(f"nms impl must be one of {_VALID_IMPLS}, "
                         f"got {impl!r}")
    if impl == "reference":
        return "greedy"
    if impl in ("greedy", "blocked"):
        return impl
    if device.type == "cuda":
        return "kernel"
    if device.type != "cpu":
        raise ValueError(f"no NMS for device {device}")
    if impl == "auto" and n < _AUTO_BLOCKED_MIN:
        return "greedy"
    return "blocked"


def _batched(boxes: torch.Tensor, scores: torch.Tensor):
    """(B, N, 4), (B, N) views and whether the caller gave one image."""
    if boxes.dim() == 2:
        if scores.dim() != 1:
            raise ValueError("boxes (N, 4) go with scores (N,)")
        return boxes[None], scores[None], True
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"boxes must be (B, N, 4) with scores (B, N), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    return boxes, scores, False


def _unbatched(out: Tuple[torch.Tensor, torch.Tensor], single: bool):
    return (out[0][0], out[1][0]) if single else out


# -------------------------------------------------------- plain versions
def nms_reference(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float, max_out: int,
                  score_threshold: float = float("-inf")
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS, the oracle. Builds the full (B, N, N) IoU matrix: the
    wrong choice beyond a few thousand candidates."""
    boxes, scores, single = _batched(boxes, scores)
    b, n = scores.shape
    iou = box_iou(boxes, boxes)
    alive = scores > score_threshold
    col = torch.arange(n, device=scores.device)
    rows = torch.arange(b, device=scores.device)
    idx = torch.zeros((b, max_out), dtype=torch.long, device=scores.device)
    valid = torch.zeros((b, max_out), dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    for t in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=1)                    # first of the maxima
        ok = masked[rows, best] > float("-inf")
        suppress = iou[rows, best] > iou_threshold
        new_alive = alive & ~suppress & (col[None] != best[:, None])
        alive = torch.where(ok[:, None], new_alive, alive)
        idx[:, t] = best
        valid[:, t] = ok
    return _unbatched((idx, valid), single)


def sort_pad_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                        score_threshold: float, block_size: int):
    """Stable sort by descending score, padded to whole blocks. Takes
    (B, N, 4), (B, N); returns (sboxes (B, Npad, 4), alive0 (B, Npad)
    bool, order (B, N) long, nb). Padded slots are never alive; NaN scores
    sort last and are never alive (NaN > t is False)."""
    b, n = scores.shape
    nb = max(1, -(-n // block_size))
    npad = nb * block_size
    order = torch.sort(-scores, dim=1, stable=True).indices
    sboxes = boxes.new_zeros((b, npad, 4))
    sboxes[:, :n] = boxes.gather(1, order[..., None].expand(b, n, 4))
    sscores = scores.new_full((b, npad), float("-inf"))
    sscores[:, :n] = scores.gather(1, order)
    alive0 = sscores > score_threshold
    return sboxes, alive0, order, nb


def _emit_from_alive(alive: torch.Tensor, order: torch.Tensor, max_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A keep mask over sorted positions (B, Npad) → (idx, valid) of
    ``max_out`` slots. Kept positions are ranked by prefix count and
    scattered into a ``max_out + 1`` buffer whose last slot takes every
    position ranked past ``max_out`` (the JAX scatter's ``mode="drop"``);
    it is sliced away."""
    b, npad = alive.shape
    n = order.shape[1]
    rank = torch.cumsum(alive.long(), dim=1) - 1
    slot = torch.where(alive & (rank < max_out), rank,
                       torch.full_like(rank, max_out))
    src = alive.new_zeros((b, max_out + 1), dtype=torch.long)
    src.scatter_(1, slot, torch.arange(npad, device=alive.device)
                 .expand(b, npad))
    src = src[:, :max_out]
    total = alive.long().sum(dim=1).clamp(max=max_out)
    valid = torch.arange(max_out, device=alive.device)[None] < total[:, None]
    order_pad = order.new_zeros((b, npad))
    order_pad[:, :n] = order
    idx = torch.where(valid, order_pad.gather(1, src),
                      torch.zeros_like(src))
    return idx, valid


def _intra_block_keep(blk_boxes: torch.Tensor, blk_alive: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """Greedy keep set within each image's sorted block: the fixed point
    of A ← alive0 ∧ ¬(∃j<k: A[j] ∧ IoU(j, k) > th), reached in at most
    block + 1 sweeps (position k is settled after k + 1)."""
    block = blk_boxes.shape[1]
    pos = torch.arange(block, device=blk_boxes.device)
    sup_in = (box_iou(blk_boxes, blk_boxes) > iou_threshold) & \
        (pos[:, None] < pos[None, :])
    keep = blk_alive
    while True:
        new = blk_alive & ~(sup_in & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            return keep
        keep = new


def nms_sweep_plain(sboxes: torch.Tensor, alive0: torch.Tensor,
                    iou_threshold: float, max_out: int,
                    block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """The blocked sweep over sorted, padded candidates (B, Npad, 4) /
    (B, Npad) → the alive mask whose first ``max_out`` set positions are
    the greedy keeps (what K3 computes; ``Npad`` a multiple of
    ``block_size``). An image that has its ``max_out`` keeps stops
    changing, as the JAX loop stops."""
    b, npad = alive0.shape
    nb = npad // block_size
    col = torch.arange(npad, device=alive0.device)
    alive = alive0.clone()
    kept = torch.zeros(b, dtype=torch.long, device=alive0.device)
    for i in range(nb):
        going = kept < max_out
        if not bool(going.any()):
            break
        start = i * block_size
        blk = sboxes[:, start:start + block_size]
        keep = _intra_block_keep(blk, alive[:, start:start + block_size],
                                 iou_threshold)
        hit = ((box_iou(blk, sboxes) > iou_threshold)
               & keep[:, :, None]).any(dim=1)
        new = alive & ~(hit & (col >= start + block_size))
        new[:, start:start + block_size] = keep
        alive = torch.where(going[:, None], new, alive)
        kept = kept + torch.where(going, keep.long().sum(dim=1),
                                  torch.zeros_like(kept))
    return alive


def nms_blocked(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_out: int,
                score_threshold: float = float("-inf"),
                block_size: int = DEFAULT_BLOCK_SIZE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked NMS in plain PyTorch: same contract and keep set as
    ``nms_reference``, O(B·N·block) memory."""
    boxes, scores, single = _batched(boxes, scores)
    block_size = int(min(block_size, max(8, boxes.shape[1])))
    sboxes, alive0, order, _ = sort_pad_candidates(boxes, scores,
                                                   score_threshold,
                                                   block_size)
    alive = nms_sweep_plain(sboxes, alive0, iou_threshold, max_out,
                            block_size)
    return _unbatched(_emit_from_alive(alive, order, max_out), single)


# ------------------------------------------------------------ the kernel
def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .kernels import build
            lib = build.load("nms_sweep")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.nms_greedy_sweep.argtypes = [vp] * 5 + [i32] * 4 + [
                ctypes.c_float, vp]
            lib.nms_greedy_sweep.restype = i32
            lib.nms_error_string.argtypes = [i32]
            lib.nms_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check_card(device: torch.device) -> None:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cap = _CAPABILITY.get(index)
    if cap is None:
        cap = _CAPABILITY[index] = torch.cuda.get_device_capability(index)
    if cap < (9, 0):
        raise RuntimeError(
            f"the NMS kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} is sm_{cap[0]}{cap[1]}")


def _launched(rc: int, name: str, lib) -> None:
    """Raise when a launch returned an error, else count it."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed ({rc}): "
                           f"{lib.nms_error_string(rc).decode()}")
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def _sweep_kernel(sboxes: torch.Tensor, alive0: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    b, npad = alive0.shape
    _check_card(sboxes.device)
    if sboxes.dtype != torch.float32:
        raise ValueError(f"the NMS kernel takes float32 boxes, got "
                         f"{sboxes.dtype}")
    if npad % WORD:
        raise ValueError(f"the NMS kernel takes candidates padded to a "
                         f"multiple of {WORD}, got {npad}")
    out = torch.empty((b, npad), dtype=torch.bool, device=alive0.device)
    if b == 0 or max_out <= 0:
        return out.zero_()
    sboxes = sboxes.contiguous()
    if sboxes.data_ptr() % 16:          # the kernel reads float4s
        sboxes = sboxes.clone()
    alive0 = alive0.contiguous()
    # one past the last live candidate of each image: the walk stops there
    pos = torch.arange(1, npad + 1, dtype=torch.int32, device=alive0.device)
    n_live = torch.where(alive0, pos, torch.zeros_like(pos)).amax(dim=1)
    n_live = n_live.to(torch.int32).contiguous()
    # kept boxes past the shared-memory list, when max_out can reach them
    spill_cap = max(0, min(max_out, npad) - KEPT_SMEM)
    spill = torch.empty((b, spill_cap, 4), dtype=torch.float32,
                        device=alive0.device) if spill_cap else None
    th = float(torch.tensor(iou_threshold, dtype=torch.float32))
    with torch.cuda.device(alive0.device):
        stream = torch.cuda.current_stream(alive0.device).cuda_stream
        lib = _lib()
        _launched(lib.nms_greedy_sweep(
            sboxes.data_ptr(), alive0.data_ptr(), n_live.data_ptr(),
            None if spill is None else spill.data_ptr(), out.data_ptr(), b,
            npad, spill_cap, int(max_out), th, stream), KERNEL_NAMES[0], lib)
    return out


def nms_sweep(sboxes: torch.Tensor, alive0: torch.Tensor,
              iou_threshold: float, max_out: int) -> torch.Tensor:
    """K3's function: sorted candidates padded to a multiple of 64,
    (B, Npad, 4) float32, and their alive mask (B, Npad) → an alive mask
    whose first ``max_out`` set positions are the greedy keeps. A CUDA
    tensor launches the kernel or raises; a CPU tensor takes the plain
    sweep in 64-wide blocks. The kernel clears every position past the
    ``max_out``-th keep; the plain sweep may leave later ones set, which
    ``_emit_from_alive`` drops."""
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4 or \
            tuple(alive0.shape) != tuple(sboxes.shape[:2]):
        raise ValueError(f"sboxes must be (B, Npad, 4) with alive0 "
                         f"(B, Npad), got {tuple(sboxes.shape)} and "
                         f"{tuple(alive0.shape)}")
    if sboxes.device != alive0.device:
        raise ValueError("sboxes and alive0 must lie on one device")
    if alive0.dtype != torch.bool:
        raise ValueError(f"alive0 must be bool, got {alive0.dtype}")
    if sboxes.device.type == "cpu" and sboxes.shape[1] % WORD:
        raise ValueError(f"the NMS kernel takes candidates padded to a "
                         f"multiple of {WORD}, got {sboxes.shape[1]}")
    if sboxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS for device {sboxes.device}")
    return _NMS_SWEEP(sboxes, alive0, float(iou_threshold), int(max_out))


# K3 is one ``torch.library`` op, ``dltpu::nms_sweep``
# (``kernels.define_op``): the only binding, for eager runs,
# ``torch.export`` and fake-mode traces alike. The real implementation
# dispatches by where the tensors lie (the plain sweep in 64-wide blocks
# on the CPU; on the card the kernel, and the checks that need a card);
# the fake one gives the (B, Npad) bool mask and launches nothing.
def _nms_sweep_impl(sboxes, alive0, iou_threshold, max_out):
    if sboxes.device.type == "cpu":
        return nms_sweep_plain(sboxes, alive0, iou_threshold, max_out, WORD)
    return _sweep_kernel(sboxes, alive0, iou_threshold, max_out)


_NMS_SWEEP = define_op(
    "nms_sweep(Tensor sboxes, Tensor alive0, float iou_threshold, "
    "int max_out) -> Tensor",
    _nms_sweep_impl, lambda sboxes, alive0, *_: alive0.new_empty(
        alive0.shape))


def _nms_kernel(boxes, scores, iou_threshold, max_out, score_threshold):
    sboxes, alive0, order, _ = sort_pad_candidates(
        boxes.to(torch.float32), scores, score_threshold, WORD)
    alive = _NMS_SWEEP(sboxes, alive0, float(iou_threshold), int(max_out))
    return _emit_from_alive(alive, order, max_out)


# ---------------------------------------------------------- entry points
def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, score_threshold: float = float("-inf"),
        impl: Optional[str] = None, block_size: int = DEFAULT_BLOCK_SIZE
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS dispatcher: boxes (B, N, 4) or (N, 4), scores (B, N) or (N,) →
    (idx, valid) of ``max_out`` slots. ``impl``: None → the default
    (``set_default_nms_impl``); "auto"/"pallas" → K3 on the card (see the
    module docstring for the CPU); "greedy"/"reference", "blocked" → the
    plain versions."""
    boxes, scores, single = _batched(boxes, scores)
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must lie on one device")
    resolved = _resolve_impl(impl, boxes.shape[1], boxes.device)
    if resolved == "greedy":
        out = nms_reference(boxes, scores, iou_threshold, max_out,
                            score_threshold)
    elif resolved == "kernel":
        out = _nms_kernel(boxes, scores, iou_threshold, max_out,
                          score_threshold)
    else:
        out = nms_blocked(boxes, scores, iou_threshold, max_out,
                          score_threshold, block_size=block_size)
    return _unbatched(out, single)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float, max_out: int,
                score_threshold: float = float("-inf"),
                impl: Optional[str] = None,
                block_size: int = DEFAULT_BLOCK_SIZE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS: each class's boxes are offset by class × (the
    image's largest finite coordinate + 1), so classes never overlap. A
    non-finite box keeps its coordinates and cannot poison the offset."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, classes = boxes[None], scores[None], classes[None]
    out = nms(class_offset_boxes(boxes, classes), scores, iou_threshold,
              max_out, score_threshold, impl=impl, block_size=block_size)
    return _unbatched(out, single)


def class_offset_boxes(boxes: torch.Tensor,
                       classes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) boxes shifted by class × (the image's largest finite
    coordinate + 1): what ``batched_nms`` suppresses over."""
    finite = torch.isfinite(boxes).all(dim=-1)
    max_coord = torch.where(finite[..., None], boxes,
                            torch.zeros_like(boxes)).amax(dim=(1, 2)) + 1.0
    return boxes + classes.to(boxes.dtype)[..., None] * \
        max_coord[:, None, None]


def gather_nms_outputs(idx: torch.Tensor, valid: torch.Tensor,
                       *arrays: torch.Tensor,
                       fill: Union[float, Sequence[float]] = 0
                       ) -> Tuple[torch.Tensor, ...]:
    """Gather arrays (B, N, ...) or (N, ...) at the keep indices, writing
    ``fill`` into padded slots (a scalar, or one value per array; -1 for
    class arrays, so a padded slot never reads as class 0)."""
    if isinstance(fill, (tuple, list)):
        if len(fill) != len(arrays):
            raise ValueError(
                f"gather_nms_outputs: got {len(arrays)} arrays but "
                f"{len(fill)} fill values")
        fills = fill
    else:
        fills = (fill,) * len(arrays)
    out = []
    for a, f in zip(arrays, fills):
        if idx.dim() == 1:
            g = a[idx]
        else:
            index = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
            g = a.gather(1, index.expand(idx.shape + a.shape[2:]))
        mask = valid.reshape(valid.shape + (1,) * (g.dim() - valid.dim()))
        out.append(torch.where(mask, g, torch.full_like(g, f)))
    return tuple(out)


# ------------------------------------------------------------- the bound
def live_counts(alive0: torch.Tensor) -> list:
    """One past each image's last live candidate (where the kernel's walk
    stops), from a (B, Npad) live mask."""
    pos = torch.arange(1, alive0.shape[1] + 1, device=alive0.device)
    return torch.where(alive0, pos, torch.zeros_like(pos)).amax(dim=1) \
        .tolist()


def _seen(alive: torch.Tensor, alive0: torch.Tensor,
          max_out: int) -> torch.Tensor:
    """(B, Npad) bool: the positions a greedy sweep looks at, every
    position up to the ``max_out``-th keep (all of them in an image that
    ran out of candidates first)."""
    keeps = alive.long()
    pos = torch.arange(alive.shape[1], device=alive.device)[None]
    last = torch.where(alive, pos, torch.full_like(pos, -1)).amax(dim=1)
    stop = torch.where(keeps.sum(dim=1) >= max_out, last,
                       torch.full_like(last, alive.shape[1]))
    return pos <= stop[:, None]


def greedy_ious(alive: torch.Tensor, alive0: torch.Tensor,
                max_out: int) -> int:
    """IoUs a greedy sweep needs over this run's data: every live candidate
    up to the ``max_out``-th keep tested against each box kept before it.
    ``alive`` (B, Npad) is a kernel's output (only keeps set), ``alive0``
    the live mask."""
    keeps = alive.long()
    kept_before = torch.cumsum(keeps, dim=1) - keeps
    seen = alive0 & _seen(alive, alive0, max_out)
    return int((kept_before * seen.long()).sum())


def sweep_bytes(alive: torch.Tensor, alive0: torch.Tensor,
                max_out: int) -> int:
    """The sweep's bytes over this run's data, each moved once: the live
    flag (one byte) of every position it looks at and the float32 box of
    every live one, each image's live count, and the (B, Npad) output (one
    byte a candidate) written."""
    seen = _seen(alive, alive0, max_out)
    b, npad = alive.shape
    return int(seen.sum()) + 16 * int((seen & alive0).sum()) + 4 * b \
        + b * npad
