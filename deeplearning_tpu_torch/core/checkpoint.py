"""Step-numbered checkpoints with checksums, best tracking and
auto-resume — the port of ``deeplearning_tpu/core/checkpoint.py`` over
``torch.save``.

Layout of a manager's directory (the JAX one's, with a torch file where
Orbax writes its tree):

    <dir>/<step>/state.pt        one committed step (``state_dict()``)
    <dir>/best/                  a copy of the best step
    <dir>/checksums.json         {step: {relpath: {crc32, size}}}
    <dir>/topology.json          {step: the run's topology fingerprint}
    <dir>/corrupt-<step>/        a step that failed its check, moved aside

A step is written into ``<step>.tmp`` and renamed, so a step directory is
either whole or absent; ``max_to_keep`` keeps the newest steps.
``restore_verified`` checks the newest step against its CRC32 sidecar,
and on a mismatch or a failed load moves it aside and walks back to the
newest intact one; ``auto_resume`` is that walk on a fresh state.
``save_pytree`` / ``load_pytree`` write one tree without a manager.
``restore_variables`` reads either (or a manager's step directory) for
inference, and ``surgical_load`` copies a state dict into another
model's, resizing position tables for a new image size or window.

``save`` and ``restore`` take any object with ``state_dict()`` /
``load_state_dict()`` (``train.TrainState``, an ``nn.Module``) or a plain
dict of tensors. A failed write is retried ``save_retries`` times, after
a capped-exponential delay with jitter (the JAX manager's defaults), and
each attempt is a ``ckpt_retry`` flight record. ``save(...,
topology=)`` records the run's fingerprint (``elastic.topology.
current_topology``: mesh, ranks, the state's layout, the weight-update
mode) in ``topology.json``, which ``topology(step)`` reads back.

Over a process group of more than one rank a step holds global tensors:
every rank calls ``save`` (a sharded ``TrainState.state_dict()``
all-gathers its slices along every split axis, ``model`` included, so a
tensor-parallel qkv is JAX's whole leaf), rank 0 alone writes, and the others wait at a
barrier until it has committed (an async write is waited for by the
next restore instead). ``restore_verified`` runs its walk on rank 0 and
broadcasts the step it chose; every rank then loads that step's global
tensors and cuts them to its own layout.

``async_save=True`` takes the write off the loop: ``save`` queues a
device-side copy of every tensor on the caller's stream (so the next
in-place optimizer step, queued after it, cannot change what is saved)
and records an event; a writer thread then copies the snapshot into
pinned host buffers on a side stream that waits on that event, polls the
copy's own event (it never synchronises, so it runs under a strict
section's sync guard), writes ``<step>.tmp``, renames it and records the
checksums. A second ``save`` waits for the first to commit;
``wait_until_finished`` / ``flush`` / ``close`` join the writer, re-raise
its error and make the pending ``best`` copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..obs import flight
from ..obs import threads as obs_threads
from .logging import create_logger

__all__ = ["checksum_dir", "CheckpointManager", "save_pytree",
           "load_pytree", "restore_variables", "surgical_load",
           "resize_vit_pos_embed", "resize_relative_position_bias",
           "default_resize_fn"]

_STATE_FILE = "state.pt"
_TREE_FILE = "tree.pt"
_POLL_S = 1e-3
# the retry delay before attempt a+1 (``elastic.supervisor.backoff_schedule``):
# min(0.25 * 2**(a-1), 4) s, times 1 + 0.25 * U[0, 1) so that failing
# writers never retry in lockstep
_RETRY_BASE_S, _RETRY_FACTOR = 0.25, 2.0
_RETRY_MAX_S, _RETRY_JITTER = 4.0, 0.25


def _file_crc(path: str) -> Tuple[int, int]:
    """Streaming (crc32, size) of one file, 1 MB chunks at a time."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def checksum_dir(root: str) -> Dict[str, Dict[str, int]]:
    """{relpath: {crc32, size}} over every file under ``root``."""
    out: Dict[str, Dict[str, int]] = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            try:
                crc, size = _file_crc(path)
            except OSError:
                continue
            out[os.path.relpath(path, root)] = {"crc32": crc, "size": size}
    return out


def _tree_of(obj: Any) -> Any:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _load_into(obj: Any, tree: Any) -> Any:
    if hasattr(obj, "load_state_dict"):
        obj.load_state_dict(tree)
        return obj
    return tree


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, in a fixed walk order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _replace_leaves(tree: Any, new: Iterator[torch.Tensor]) -> Any:
    """``tree`` with its tensors, in ``_leaves`` order, drawn from the
    iterator ``new``."""
    if isinstance(tree, torch.Tensor):
        return next(new)
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_leaves(v, new) for v in tree)
    return tree


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    from ..parallel.collectives import sync_barrier
    sync_barrier("checkpoint")


def _map_location(obj: Any) -> Optional[torch.device]:
    """The device a restore lands on: that of ``obj``'s first tensor (a
    sharded state's mesh device: its ``state_dict()`` is collective)."""
    sharding = getattr(obj, "sharding", None)
    if sharding is not None:
        return sharding.mesh.device
    tree = _tree_of(obj)
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return None


class CheckpointManager:
    """Step-numbered checkpoints + checksums + best copy + auto-resume,
    written on the caller's thread or (``async_save``) off it."""

    _CHECKSUM_KEEP = 32

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False, save_retries: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self._async = bool(async_save)
        self._save_retries = int(save_retries)
        self._pending_best: Optional[int] = None
        # the async writer: its thread, the step it writes, its error
        self._writer: Optional[threading.Thread] = None
        self._writing: Optional[int] = None
        self._writer_error: Optional[BaseException] = None
        # pinned host buffers of the last async write, reused by the next
        self._staging: List[Optional[torch.Tensor]] = []
        self._stream: Optional[torch.cuda.Stream] = None
        self._logger = create_logger()

    # ------------------------------------------------------------ steps
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(
                          os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        """The newest step, counting one an async write is landing."""
        steps = self.all_steps()
        if self._writing is not None:
            steps.append(self._writing)
        return max(steps) if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, metrics: Optional[Dict] = None,
             is_best: bool = False,
             topology: Optional[Dict[str, Any]] = None) -> None:
        """Commit ``state`` as ``step`` (its ``metrics`` in
        ``metrics.json``), record its checksums and ``topology``, keep the
        newest ``max_to_keep`` steps, and copy it to ``best/`` when
        ``is_best``. Asynchronous: returns once the snapshot is queued on
        the card; a previous write is waited for first. A step already
        committed is not written again (Orbax's rule in the JAX
        manager)."""
        rank, world = _rank_world()
        # the previous write commits (and its best copy lands) BEFORE
        # this save can garbage-collect it
        self.wait_until_finished()
        if world > 1:
            # the gather is collective: every rank takes part whatever
            # rank 0 decides, then only rank 0 writes
            tree = _tree_of(state)
            if rank != 0:
                if not self._async:
                    _barrier()
                return
        if is_best:
            self._pending_best = int(step)
        if topology is not None:
            self._write_topology(step, topology)
        if int(step) in self.all_steps():
            self._finish_pending_best()
            if world > 1 and not self._async:
                _barrier()
            return
        if world == 1:
            tree = _tree_of(state)
        if not self._async:
            self._save_with_retry(step, tree, metrics)
            self._commit(step)
            self._finish_pending_best()
            if world > 1:
                _barrier()
            return
        snapshot, event = self._device_snapshot(tree)
        self._writing = int(step)
        self._writer = obs_threads.spawn(
            self._write_async, args=(int(step), snapshot, event, metrics),
            name="checkpoint-writer", daemon=True)

    def _device_snapshot(self, tree: Any) -> Tuple[Any, Any]:
        """Clone every tensor where it lies, queued on the current stream
        (so an in-place step queued later cannot reach the copy), and
        record an event after the clones (None without card tensors)."""
        leaves = _leaves(tree)
        with torch.no_grad():
            clones = [t.detach().clone() for t in leaves]
        snapshot = _replace_leaves(tree, iter(clones))
        cuda = [t for t in clones if t.is_cuda]
        if not cuda:
            return snapshot, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[0].device))
        return snapshot, event

    def _to_host(self, snapshot: Any, event: Any) -> Any:
        """The writer's side: copy the snapshot's card tensors into
        pinned host buffers on a side stream that waits on ``event``, and
        poll the copies' event (no synchronising call)."""
        if event is None:
            return snapshot
        leaves = _leaves(snapshot)
        dev = next(t.device for t in leaves if t.is_cuda)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        host: List[torch.Tensor] = []
        staging: List[Optional[torch.Tensor]] = []
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            for i, t in enumerate(leaves):
                buf = self._staging[i] if i < len(self._staging) else None
                if not t.is_cuda:
                    host.append(t)
                    staging.append(buf)
                    continue
                if buf is None or buf.shape != t.shape or \
                        buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
                staging.append(buf)
            done = torch.cuda.Event()
            done.record(self._stream)
        while not done.query():
            time.sleep(_POLL_S)
        self._staging = staging
        return _replace_leaves(snapshot, iter(host))

    def _write_async(self, step: int, snapshot: Any, event: Any,
                     metrics: Optional[Dict]) -> None:
        try:
            self._save_with_retry(step, self._to_host(snapshot, event),
                                  metrics)
            self._commit(step)
        except BaseException as exc:  # noqa: BLE001 - re-raised on join
            self._writer_error = exc

    def wait_until_finished(self) -> None:
        """Join the async writer (re-raising its error) and make the
        pending best copy."""
        writer = self._writer
        if writer is not None:
            writer.join()
            self._writer = None
            self._writing = None
            err, self._writer_error = self._writer_error, None
            if err is not None:
                raise err
        self._finish_pending_best()

    def flush(self) -> None:
        """Barrier: block until every in-flight write has committed. The
        preemption guard calls it from the SIGTERM handler — after it
        returns, the newest checkpoint on disk is complete."""
        self.wait_until_finished()

    def close(self) -> None:
        self.wait_until_finished()

    def _finish_pending_best(self) -> None:
        if self._pending_best is None:
            return
        step, self._pending_best = self._pending_best, None
        src, best = self._step_dir(step), os.path.join(self.directory,
                                                       "best")
        if os.path.isdir(src):
            if os.path.isdir(best):
                shutil.rmtree(best)
            shutil.copytree(src, best)

    def _write_step(self, step: int, tree: Any,
                    metrics: Optional[Dict]) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def _save_with_retry(self, step: int, tree: Any,
                         metrics: Optional[Dict]) -> None:
        """Write with capped-exponential-backoff retries; each attempt
        starts from a clean ``<step>.tmp``."""
        for attempt in range(1, self._save_retries + 2):
            try:
                self._write_step(step, tree, metrics)
                return
            except Exception as exc:  # noqa: BLE001 - retried or raised
                flight.record("ckpt_retry", step=int(step),
                              attempt=attempt, error=repr(exc))
                if attempt > self._save_retries:
                    raise
                from ..elastic.supervisor import backoff_schedule
                delay = backoff_schedule(
                    attempt, base_s=_RETRY_BASE_S, factor=_RETRY_FACTOR,
                    max_s=_RETRY_MAX_S, jitter=_RETRY_JITTER)
                self._logger.warning(
                    f"checkpoint save step {step} failed "
                    f"(attempt {attempt}/{self._save_retries + 1}): "
                    f"{exc!r}; retrying in {delay:.2f}s")
                time.sleep(delay)

    def _commit(self, step: int) -> None:
        """After the rename: the checksums, then the oldest steps go."""
        self._write_checksums(step)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    # -------------------------------------------------- topology sidecar
    # one JSON file for the directory ({step: fingerprint}), as JAX's
    _TOPOLOGY_KEEP = 32

    def _topology_path(self) -> str:
        return os.path.join(self.directory, "topology.json")

    def _write_topology(self, step: int, topology: Dict[str, Any]) -> None:
        try:
            docs = self._read_topology_file()
            docs[str(step)] = topology
            for key in sorted(docs, key=int)[:-self._TOPOLOGY_KEEP]:
                del docs[key]
            tmp = self._topology_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(docs, f, indent=1)
            os.replace(tmp, self._topology_path())
        except (OSError, ValueError) as e:
            self._logger.warning(f"topology sidecar write failed: {e}")

    def _read_topology_file(self) -> Dict[str, Any]:
        try:
            with open(self._topology_path()) as f:
                docs = json.load(f)
            return docs if isinstance(docs, dict) else {}
        except (OSError, ValueError):
            return {}

    def topology(self, step: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
        """The fingerprint recorded at ``step`` (default: the newest
        step); None for a step saved without one."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return self._read_topology_file().get(str(step))

    # -------------------------------------------------- checksum sidecar
    def _checksum_path(self) -> str:
        return os.path.join(self.directory, "checksums.json")

    def _read_checksum_file(self) -> Dict[str, Any]:
        try:
            with open(self._checksum_path()) as f:
                docs = json.load(f)
            return docs if isinstance(docs, dict) else {}
        except (OSError, ValueError):
            return {}

    def _write_checksums(self, step: int) -> None:
        try:
            docs = self._read_checksum_file()
            docs[str(step)] = checksum_dir(self._step_dir(step))
            for key in sorted(docs, key=int)[:-self._CHECKSUM_KEEP]:
                del docs[key]
            tmp = self._checksum_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(docs, f)
            os.replace(tmp, self._checksum_path())
        except (OSError, ValueError) as e:
            self._logger.warning(f"checksum sidecar write failed: {e}")

    def verify_step(self, step: int) -> bool:
        """True when every file recorded at save time still exists with
        matching size and crc32. A step with no sidecar entry is trusted:
        verification only rejects known-bad data."""
        recorded = self._read_checksum_file().get(str(step))
        if recorded is None:
            return True
        root = self._step_dir(step)
        for rel, meta in recorded.items():
            try:
                crc, size = _file_crc(os.path.join(root, rel))
            except OSError:
                return False
            if size != meta.get("size") or crc != meta.get("crc32"):
                return False
        return True

    def _quarantine_step(self, step: int, reason: str) -> None:
        """Move a corrupt step aside (``corrupt-<step>``, which the step
        scan ignores) for forensics, instead of deleting it."""
        flight.record("ckpt_corrupt", step=int(step), reason=reason)
        self._logger.warning(
            f"checkpoint step {step} failed integrity check ({reason}); "
            f"moving aside and falling back")
        dst = os.path.join(self.directory, f"corrupt-{step}")
        try:
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.replace(self._step_dir(step), dst)
        except OSError as e:
            self._logger.warning(f"could not quarantine step {step}: {e}")

    # ----------------------------------------------------------- restore
    def _load(self, step: int, state: Any) -> Any:
        tree = torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                          map_location=_map_location(state),
                          weights_only=True)
        return _load_into(state, tree)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default: the newest) into ``state``, unchecked;
        None when there is no step."""
        self.wait_until_finished()
        _barrier()
        step = self.latest_step() if step is None else step
        return None if step is None else self._load(step, state)

    def restore_verified(self, state: Any,
                         step: Optional[int] = None) -> Tuple[Any, int]:
        """Verify the newest step (<= ``step`` if given) against its
        checksums and load it; on a mismatch or a failed load, move it
        aside and walk back to the next-newest. Returns ``(None, 0)`` when
        nothing restorable remains."""
        self.wait_until_finished()
        rank, world = _rank_world()
        if world == 1:
            return self._restore_walk(state, step)
        from ..parallel.collectives import broadcast_from_host0
        restored, got = (self._restore_walk(state, step) if rank == 0
                         else (None, 0))
        got = broadcast_from_host0(got if restored is not None else None)
        if got is None:
            return None, 0
        return (restored if rank == 0 else self._load(got, state)), got

    def _restore_walk(self, state: Any,
                      step: Optional[int]) -> Tuple[Any, int]:
        first: Optional[int] = None
        ceiling = step
        while True:
            steps = [s for s in self.all_steps()
                     if ceiling is None or s <= ceiling]
            if not steps:
                return None, 0
            candidate = steps[-1]
            if first is None:
                first = candidate
            if not self.verify_step(candidate):
                self._quarantine_step(candidate, "checksum mismatch")
                ceiling = candidate - 1
                continue
            try:
                restored = self._load(candidate, state)
            except Exception as exc:  # noqa: BLE001 - corrupt beyond crc
                self._quarantine_step(candidate, f"restore failed: {exc!r}")
                ceiling = candidate - 1
                continue
            if candidate != first:
                flight.record("ckpt_fallback", from_step=int(first),
                              to_step=int(candidate))
                self._logger.warning(
                    f"restored fallback step {candidate} "
                    f"(newest step {first} was corrupt)")
            return restored, candidate

    def auto_resume(self, state: Any) -> Tuple[Any, int]:
        """Restore the newest intact checkpoint into ``state``; returns
        ``(state, 0)`` when there is none."""
        restored, step = self.restore_verified(state)
        if restored is None:
            return state, 0
        self._logger.info(f"auto-resume from step {step} in {self.directory}")
        flight.record("resume", step=int(step))
        return restored, step


def save_pytree(path: str, tree: Any) -> None:
    """One-shot save of a tree (or of an object's ``state_dict()``) into
    the directory ``path``, replacing what was there."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_tree_of(tree), os.path.join(path, _TREE_FILE))


def _read_tree(path: str, map_location: Any) -> Any:
    path = os.path.abspath(path)
    name = _TREE_FILE if os.path.exists(os.path.join(path, _TREE_FILE)) \
        else _STATE_FILE
    return torch.load(os.path.join(path, name), map_location=map_location,
                      weights_only=True)


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """A tree written by ``save_pytree``, or a manager's step directory;
    loaded into ``target`` (and returned) when it has
    ``load_state_dict``."""
    tree = _read_tree(path, None if target is None
                      else _map_location(target))
    return tree if target is None else _load_into(target, tree)


def restore_variables(path: str, init_variables: Dict[str, torch.Tensor],
                      prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The one reading of an inference checkpoint, as in JAX: a
    TrainState-style tree (``TrainState.state_dict()``: ``params``,
    ``ema_params``, ``buffers``) or a bare state dict at ``path`` (a
    ``save_pytree`` directory or a manager's step directory), merged over
    ``init_variables`` (the model's ``state_dict()``). ``ema_params`` win
    when present and ``prefer_ema``; the BatchNorm statistics (the
    ``buffers``) come from the checkpoint when it has them (evaluating
    with init-time statistics is silently wrong). Loaded on the CPU;
    ``load_state_dict`` moves it to the model's device."""
    restored = _read_tree(path, "cpu")
    variables = dict(init_variables)
    if isinstance(restored, dict) and (
            "params" in restored or "ema_params" in restored):
        params = restored.get("ema_params") if prefer_ema else None
        if params is None:
            params = restored.get("params")
        variables.update(params)
        stats = restored.get("buffers")
        if stats:
            # a TrainState's buffers include those the model computes
            # itself and keeps out of its state dict (Swin's indices)
            variables.update({k: v for k, v in stats.items()
                              if k in variables})
    else:
        variables.update(restored)
    return variables


def surgical_load(
    params: Dict[str, Any],
    pretrained: Dict[str, Any],
    rename: Optional[Dict[str, str]] = None,
    drop: Optional[List[str]] = None,
    resize_fn: Optional[Callable[[str, np.ndarray, tuple],
                                 Optional[np.ndarray]]] = None,
) -> Dict[str, torch.Tensor]:
    """Partial / renamed pretrained loading over state dicts (dotted
    names): every ``pretrained`` tensor whose (renamed) name is in
    ``params`` with the same shape is copied; ``drop`` holds regexes of
    names to skip (a classifier head when the class count differs).
    ``resize_fn(name, value, new_shape)`` may adapt a mismatched tensor (a
    position table at another image size or window); when it returns
    None the tensor keeps ``params``' value, as buffers the model computes
    itself do. Returns a new state dict with ``params``' dtypes."""
    flat_params = dict(params)
    rename = rename or {}
    drop_res = [re.compile(d) for d in (drop or [])]
    logger = create_logger()
    loaded, skipped = 0, []
    for path, value in pretrained.items():
        tgt_path = rename.get(path, path)
        if any(r.search(tgt_path) for r in drop_res):
            skipped.append(tgt_path)
            continue
        if tgt_path not in flat_params:
            skipped.append(tgt_path)
            continue
        want = flat_params[tgt_path]
        value = _as_numpy(value)
        if value.shape != tuple(want.shape):
            if resize_fn is not None:
                value = resize_fn(tgt_path, value, tuple(want.shape))
            if value is None or value.shape != tuple(want.shape):
                skipped.append(tgt_path)
                continue
        flat_params[tgt_path] = torch.from_numpy(np.ascontiguousarray(
            value)).to(want.dtype)
        loaded += 1
    if skipped:
        logger.info(f"surgical_load: loaded {loaded}, skipped {len(skipped)}: "
                    f"{skipped[:8]}{'...' if len(skipped) > 8 else ''}")
    return flat_params


def _as_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


# the resize functions and _bilinear_resize are JAX's numpy, line for line,
# so a table resized here is bit-equal to JAX's
def resize_vit_pos_embed(path: str, value: np.ndarray,
                         new_shape: tuple) -> Optional[np.ndarray]:
    """``resize_fn`` for ViT ``pos_embed`` (1, 1+N, C): 2-D bilinear
    resize of the patch-grid part, cls token kept."""
    if "pos_embed" not in path or value.ndim != 3 or len(new_shape) != 3:
        return None
    n_old, n_new = value.shape[1] - 1, new_shape[1] - 1
    g_old, g_new = int(round(n_old ** 0.5)), int(round(n_new ** 0.5))
    if g_old * g_old != n_old or g_new * g_new != n_new:
        return None
    cls, grid = value[:, :1], value[:, 1:]
    grid = grid.reshape(g_old, g_old, -1)
    grid = _bilinear_resize(grid, g_new, g_new)
    return np.concatenate(
        [cls, grid.reshape(1, g_new * g_new, -1)], axis=1)


def resize_relative_position_bias(path: str, value: np.ndarray,
                                  new_shape: tuple) -> Optional[np.ndarray]:
    """``resize_fn`` for Swin ``relative_position_bias_table``
    ((2w-1)^2, H): bilinear resize over the (2w-1, 2w-1) offset grid when
    the window size changes."""
    if "relative_position_bias" not in path or value.ndim != 2 \
            or len(new_shape) != 2 or value.shape[1] != new_shape[1]:
        return None
    s_old = int(round(value.shape[0] ** 0.5))
    s_new = int(round(new_shape[0] ** 0.5))
    if s_old * s_old != value.shape[0] or s_new * s_new != new_shape[0]:
        return None
    grid = value.reshape(s_old, s_old, -1)
    grid = _bilinear_resize(grid, s_new, s_new)
    return grid.reshape(s_new * s_new, -1)


def default_resize_fn(path: str, value: np.ndarray,
                      new_shape: tuple) -> Optional[np.ndarray]:
    """Chain of the built-in interpolators; pass to ``surgical_load`` as
    ``resize_fn=default_resize_fn`` for ViT / Swin size transfers."""
    for fn in (resize_vit_pos_embed, resize_relative_position_bias):
        out = fn(path, value, new_shape)
        if out is not None:
            return out
    return None


def _bilinear_resize(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) -> (h, w, C) bilinear, align_corners=True semantics."""
    h_old, w_old = grid.shape[:2]
    if (h_old, w_old) == (h, w):
        return grid
    ys = np.linspace(0, h_old - 1, h)
    xs = np.linspace(0, w_old - 1, w)
    y0 = np.clip(np.floor(ys).astype(int), 0, h_old - 1)
    y1 = np.clip(y0 + 1, 0, h_old - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w_old - 1)
    x1 = np.clip(x0 + 1, 0, w_old - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - wx) + grid[y0][:, x1] * wx
    bot = grid[y1][:, x0] * (1 - wx) + grid[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy
