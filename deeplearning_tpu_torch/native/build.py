"""Build + load the port's native C++ with g++ — the counterpart of
``deeplearning_tpu/native/build.py`` and ``tools/build_savedmodel_runner.py``.

Two kinds of build, each compiled on first use (never at import) from
``deeplearning_tpu_torch/native/`` into ``<checkout>/build/native/``
(listed in ``.gitignore``), under a name that carries a hash of the
source and the flags, so an edited source is never served by a stale
build. The compiler writes a private temporary name that is then renamed
into place: a concurrent process never opens a half-written file.

- The plain C-ABI helpers (``imagedec.cpp``, ``cocoeval.cpp``,
  ``my_add.cc``), bound with ctypes by :func:`load`. ``load`` returns
  None when the build fails (no g++, no libjpeg headers), as JAX's does,
  and callers fall back.
- The torch-linked builds of the serving artifact
  (:func:`build_serving`): the op library ``dltpu_ops.cpp`` and the
  AOTInductor runner ``aoti_runner.cc``, compiled against the
  installed torch's headers and libraries with its C++ ABI flag. Under a
  CUDA build of torch the op library gets its card half: the CUDA
  toolkit's headers, ``libtorch_cuda``, ``libc10_cuda``, ``libcudart``,
  and the paths of the kernel libraries ``ops/kernels/build.py`` builds
  from ``csrc/`` (opened with ``dlopen`` at the first launch). These
  builds raise with the compiler's output when they fail: a deployer's
  artifact never quietly lacks its kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from pathlib import Path
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

__all__ = ["NATIVE_DIR", "BUILD_DIR", "CXX", "library_path", "load",
           "cuda_home", "build_serving"]

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"
# the host compiler of every build here, and of the AOTInductor packages
# (``export/serialize.export_savedmodel``) the runner loads: g++ on PATH
CXX = "g++"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# per-library link flags (system libraries must be present; load()
# returns None when they are not)
_LINK = {"imagedec": ("-ljpeg", "-lpthread")}

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _command(name: str, src: Path, out: str) -> List[str]:
    return [CXX, *_CXX_FLAGS, str(src), "-o", out, *_LINK.get(name, ())]


def _source(name: str) -> Path:
    """``<name>.cpp``, or ``<name>.cc`` where that is the helper's file."""
    src = NATIVE_DIR / f"{name}.cpp"
    return src if src.exists() else NATIVE_DIR / f"{name}.cc"


def library_path(name: str) -> Path:
    """Where ``lib<name>`` lands: its name hashes the source and flags."""
    src = _source(name)
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
        subprocess.run(_command(name, _source(name), tmp),
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


# --------------------------------------------- the torch-linked builds
# (source, kind): a shared library or an executable
_TORCH_BUILDS = {"dltpu_ops": ("dltpu_ops.cpp", "shared"),
                 "aoti_runner": ("aoti_runner.cc", "exe")}
# the kernel libraries the op library's card half opens, by macro
_KERNEL_LIBS = {"DLTPU_FLASH_ATTN_FWD_LIB": "flash_attn_fwd",
                "DLTPU_WINDOW_ATTN_FWD_LIB": "window_attn_fwd",
                "DLTPU_NMS_SWEEP_LIB": "nms_sweep"}


def _torch_cuda() -> bool:
    import torch
    return torch.version.cuda is not None


def cuda_home() -> Path:
    """The CUDA toolkit: ``$CUDA_HOME``, ``$CUDA_PATH`` or
    ``/usr/local/cuda``. Raises when it has no ``cuda_runtime_api.h``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "include" / "cuda_runtime_api.h").exists():
            return Path(home)
    raise RuntimeError("this torch is a CUDA build, but no CUDA toolkit "
                       "headers were found (set CUDA_HOME): the op "
                       "library's card half cannot be built")


def _cudart(home: Path) -> List[str]:
    """Link flags for the CUDA runtime torch itself loads: the pip
    wheel's ``nvidia/cuda_runtime/lib`` where torch has one, else the
    toolkit's."""
    import torch
    site = Path(torch.__file__).resolve().parents[1]
    found = sorted(glob.glob(str(site / "nvidia" / "cuda_runtime" / "lib"
                                 / "libcudart.so.*")))
    if found:
        return [found[0], f"-Wl,-rpath,{Path(found[0]).parent}"]
    lib = home / "lib64"
    return [f"-L{lib}", "-lcudart", f"-Wl,-rpath,{lib}"]


def _torch_build_command(name: str, out: str) -> List[str]:
    """The g++ command of the torch-linked build ``name`` (``dltpu_ops``
    or ``aoti_runner``) into ``out``, with the card half whenever torch is
    a CUDA build."""
    import torch
    src, kind = _TORCH_BUILDS[name]
    root = Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cmd = [CXX, "-O1", "-std=c++17", "-fPIC",
           f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
           f"-I{root / 'include'}",
           f"-I{root / 'include' / 'torch' / 'csrc' / 'api' / 'include'}"]
    libs = [f"-L{root / 'lib'}", "-Wl,--no-as-needed", "-ltorch",
            "-ltorch_cpu", "-lc10"]
    if _torch_cuda():
        home = cuda_home()
        cmd.append(f"-I{home / 'include'}")
        libs += ["-ltorch_cuda", "-lc10_cuda"]
        if name == "dltpu_ops":
            from ..ops.kernels import build as kernels
            cmd.append("-DDLTPU_WITH_CUDA")
            for macro, stem in _KERNEL_LIBS.items():
                path = kernels.library_path(kernels.CSRC_DIR / f"{stem}.cu")
                cmd.append(f'-D{macro}="{path}"')
            libs += _cudart(home)
    libs += ["-Wl,--as-needed", "-ldl", f"-Wl,-rpath,{root / 'lib'}"]
    if kind == "shared":
        cmd.append("-shared")
    return [*cmd, str(NATIVE_DIR / src), "-o", out, *libs]


def _torch_build_path(name: str) -> Path:
    """Where the build ``name`` lands: its name hashes the source and the
    command (flags, torch's paths, the kernel libraries' hashed names)."""
    src, kind = _TORCH_BUILDS[name]
    cmd = _torch_build_command(name, "")
    digest = hashlib.sha256((NATIVE_DIR / src).read_bytes()
                            + " ".join(cmd).encode()).hexdigest()[:12]
    base = f"lib{name}-{digest}.so" if kind == "shared" \
        else f"{name}-{digest}"
    return BUILD_DIR / base


def _torch_build(name: str) -> Tuple[Path, float]:
    out = _torch_build_path(name)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}-{os.getpid()}-{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(_torch_build_command(name, str(tmp)),
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"g++ failed to build {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def build_serving() -> Dict[str, Tuple[Path, float]]:
    """The op library (``dltpu_ops``: ``dltpu::flash_fwd``,
    ``window_attn`` and ``nms_sweep`` registered from C++; load it only
    in a process that has not imported ``deeplearning_tpu_torch.ops``)
    and the runner executable (``aoti_runner``), one g++ each, at once:
    {name: (path, build seconds, 0.0 when it was built already)}. Raises
    with g++'s output when either fails."""
    with ThreadPoolExecutor(len(_TORCH_BUILDS)) as pool:
        futures = {n: pool.submit(_torch_build, n)
                   for n in _TORCH_BUILDS}
        return {n: f.result() for n, f in futures.items()}
