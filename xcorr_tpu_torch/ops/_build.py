r"""
:mod:`ops._build` -- Build and load the hand-written CUDA kernels
=================================================================

Compiles every ``xcorr_tpu_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with
:mod:`ctypes`. The library lands in ``build/xcorr_tpu_torch/`` beside the
package, under a name keyed by a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one is reused. Nothing is built
when a module is imported: the first launch builds.
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

__all__ = ["load", "build_seconds"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "xcorr_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
#: wall seconds the last build took in this process (0.0 when the
#: library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of xcorr_tpu_torch need the CUDA toolkit to build")
    return path


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libxcorr_kernels-{h.hexdigest()[:16]}.so"


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.xc_fused_corr.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.xc_fused_corr.restype = ci
    return lib


def load():
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                t0 = time.perf_counter()
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
                       *map(str, sorted(_CSRC.glob("*.cu")))]
                subprocess.run(cmd, check=True)
                os.replace(tmp, path)
                build_seconds = time.perf_counter() - t0
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib
