"""Kernel builder: nvcc over ``deeplearning_tpu_torch/csrc/*.cu`` into
shared libraries with a plain C interface, loaded through ``ctypes``.

The counterpart of ``deeplearning_tpu/native/build.py``'s role for the
Hopper kernels. Nothing is compiled when this module is imported: the
first wrapper that launches a kernel calls :func:`load`, which builds
every source that has no up-to-date library yet (one ``nvcc`` per
source, all started together) and opens the one it was asked for.

Libraries land in ``<checkout>/build/kernels/`` (listed in
``.gitignore``) under a name that carries a hash of the source, of every
shared header (``csrc/*.cuh``) and of the flags, so an edited source or
header is never served by a stale library. The
``ptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside each library as ``<name>.ptxas.txt``.

Each C entry point takes every pointer and the stream as ``c_void_p``
and returns ``cudaGetLastError()`` after its launch; the wrapper raises
when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path",
           "nvcc_command", "library_path", "sources", "headers", "build_all",
           "load", "ptxas_report"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path(src: Path) -> Path:
    """The library of ``src``: its name hashes the source, every header in
    ``CSRC_DIR`` (any source may include any of them) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel.
    Returns {source stem: build seconds} (0.0 for a library that was
    already built). Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    seconds: Dict[str, float] = {}
    nvcc = None
    for src in sources():
        out = library_path(src)
        if out.exists():
            seconds[src.stem] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(src, tmp, nvcc),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((src, out, tmp, proc, time.perf_counter()))
    failures = []
    for src, out, tmp, proc, t0 in pending:
        log, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            continue
        out.with_name(out.stem + ".ptxas.txt").write_text(log)
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    out-of-date source first)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC_DIR / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(f"no kernel source {src}")
            path = library_path(src)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def ptxas_report(name: str) -> Optional[str]:
    """``ptxas -v`` output of the current build of ``csrc/<name>.cu``, if
    it was built in this checkout."""
    path = library_path(CSRC_DIR / f"{name}.cu")
    report = path.with_name(path.stem + ".ptxas.txt")
    return report.read_text() if report.exists() else None
