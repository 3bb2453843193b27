"""Build + load the port's native C++ helpers with g++ and ctypes — the
counterpart of ``deeplearning_tpu/native/build.py``.

Each helper is a plain C-ABI shared object compiled on first use (never
at import) from ``deeplearning_tpu_torch/native/<name>.cpp`` into
``<checkout>/build/native/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source is never
served by a stale library. The compiler writes a private temporary name
that is then renamed into place: a concurrent process never opens a
half-written library. ``load`` returns None when the build fails (no
g++, no libjpeg headers), and callers fall back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["NATIVE_DIR", "BUILD_DIR", "library_path", "load"]

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# per-library link flags (system libraries must be present; load()
# returns None when they are not)
_LINK = {"imagedec": ("-ljpeg", "-lpthread")}

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _command(name: str, src: Path, out: str) -> List[str]:
    return ["g++", *_CXX_FLAGS, str(src), "-o", out, *_LINK.get(name, ())]


def library_path(name: str) -> Path:
    """Where ``lib<name>`` lands: its name hashes the source and flags."""
    src = NATIVE_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_command(name, src, "")).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> Optional[Path]:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stale in glob.glob(str(BUILD_DIR / f".lib{name}-*.tmp.so")):
        try:                      # leftovers from a killed compile
            os.unlink(stale)
        except OSError:
            pass
    tmp = str(BUILD_DIR / f".lib{name}-{os.getpid()}.tmp.so")
    try:
        subprocess.run(_command(name, NATIVE_DIR / f"{name}.cpp", tmp),
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def load(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and open ``lib<name>``; None if unavailable."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        path = _build(name)
        try:
            lib = ctypes.CDLL(str(path)) if path else None
        except OSError:   # e.g. a runtime dependency went missing
            lib = None
        _LIBS[name] = lib
        return lib
