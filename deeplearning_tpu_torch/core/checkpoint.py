"""Step-numbered checkpoints with checksums, best tracking and
auto-resume — the port of ``deeplearning_tpu/core/checkpoint.py`` over
``torch.save``.

Layout of a manager's directory (the JAX one's, with a torch file where
Orbax writes its tree):

    <dir>/<step>/state.pt        one committed step (``state_dict()``)
    <dir>/best/                  a copy of the best step
    <dir>/checksums.json         {step: {relpath: {crc32, size}}}
    <dir>/corrupt-<step>/        a step that failed its check, moved aside

A step is written into ``<step>.tmp`` and renamed, so a step directory is
either whole or absent; ``max_to_keep`` keeps the newest steps.
``restore_verified`` checks the newest step against its CRC32 sidecar,
and on a mismatch or a failed load moves it aside and walks back to the
newest intact one; ``auto_resume`` is that walk on a fresh state.
``save_pytree`` / ``load_pytree`` write one tree without a manager.

``save`` and ``restore`` take any object with ``state_dict()`` /
``load_state_dict()`` (``train.TrainState``, an ``nn.Module``) or a plain
dict of tensors. Asynchronous writes and the topology sidecar come with
ROADMAP Queue 1 items 5c and 7, ``restore_variables`` with item 6.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..obs import flight
from .logging import create_logger

__all__ = ["checksum_dir", "CheckpointManager", "save_pytree",
           "load_pytree"]

_STATE_FILE = "state.pt"
_TREE_FILE = "tree.pt"


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


def _map_location(obj: Any) -> Optional[torch.device]:
    """The device a restore lands on: that of ``obj``'s first tensor."""
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
    """Step-numbered checkpoints + checksums + best copy + auto-resume."""

    _CHECKSUM_KEEP = 32

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self._logger = create_logger()

    # ------------------------------------------------------------ steps
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(
                          os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, metrics: Optional[Dict] = None,
             is_best: bool = False) -> None:
        """Commit ``state`` as ``step`` (its ``metrics`` in
        ``metrics.json``), record its checksums, keep the newest
        ``max_to_keep`` steps, and copy it to ``best/`` when ``is_best``."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_tree_of(state), os.path.join(tmp, _STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._write_checksums(step)
        if is_best:
            best = os.path.join(self.directory, "best")
            if os.path.isdir(best):
                shutil.rmtree(best)
            shutil.copytree(final, best)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

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
        step = self.latest_step() if step is None else step
        return None if step is None else self._load(step, state)

    def restore_verified(self, state: Any,
                         step: Optional[int] = None) -> Tuple[Any, int]:
        """Verify the newest step (<= ``step`` if given) against its
        checksums and load it; on a mismatch or a failed load, move it
        aside and walk back to the next-newest. Returns ``(None, 0)`` when
        nothing restorable remains."""
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


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """A tree written by ``save_pytree``, or a manager's step directory;
    loaded into ``target`` (and returned) when it has
    ``load_state_dict``."""
    path = os.path.abspath(path)
    name = _TREE_FILE if os.path.exists(os.path.join(path, _TREE_FILE)) \
        else _STATE_FILE
    tree = torch.load(os.path.join(path, name),
                      map_location=None if target is None
                      else _map_location(target), weights_only=True)
    return tree if target is None else _load_into(target, tree)
