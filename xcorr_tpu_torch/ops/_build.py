r"""
:mod:`ops._build` -- Build and load the hand-written CUDA kernels
=================================================================

Compiles every ``xcorr_tpu_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and links them into one
shared library with a plain C interface, loaded with
:mod:`ctypes`. The library lands in ``build/xcorr_tpu_torch/`` of the
source checkout, or in the user's cache directory for an installed
package (:func:`build_dir`), under a name keyed by a hash of the flags and
of every source the build reads (the ``*.cu`` files and the ``*.cuh``
headers they include), so an edited kernel or header rebuilds and an
unchanged one is reused.
Nothing is built when a module is imported: the first launch builds.
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

__all__ = ["load", "build_seconds", "build_dir", "sources", "hashed_files"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"


def build_dir(pkg: Path = _PKG) -> Path:
    """Where the library is built: ``build/xcorr_tpu_torch/`` of the
    source checkout that holds ``pkg`` (beside its ``pyproject.toml``),
    else, for an installed package, ``xcorr_tpu_torch/`` under the
    user's cache directory (``$XDG_CACHE_HOME``, default ``~/.cache``)."""
    if (pkg.parent / "pyproject.toml").is_file():
        return pkg.parent / "build" / "xcorr_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "xcorr_tpu_torch"


_BUILD = build_dir()
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

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


def sources() -> list:
    """The translation units ``nvcc`` compiles."""
    return sorted(_CSRC.glob("*.cu"))


def hashed_files() -> list:
    """Every file the build reads: the sources and the headers."""
    return sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libxcorr_kernels-{h.hexdigest()[:16]}.so"


#: C entry points and their argument kinds in order: buffers (p), ints
#: (i), then the stream (p). Every function returns a CUDA error code.
_SIGNATURES = {
    "xc_fused_corr": "pppppiiiip",
    "xc_fused_corr_phases": "pppppiiiipp",
    "xc_stageb_fwd": "ppppiiiip",
    "xc_stageb_inv": "pppppiiiiip",
    "xc_fused_corr_acc": "ppppppppiiiiiip",
    "xc_fused_corr_full": "ppppppppppiiiiiiip",
    "xc_gather_product": "pppppiip",
    "xc_circular_argmax": "pppppiiiiiip",
    "xc_inverse_argmax": "pppppppiiiiiiiiip",
}


def _declare(lib):
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[k] for k in sig]
        fn.restype = ctypes.c_int
    return lib


def _compile(path: Path):
    """One ``nvcc -c`` per source, all started together, then one link
    into ``path``."""
    work = _BUILD / f"objs.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        objs = [work / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj),
                                   str(src)])
                 for src, obj in zip(sources(), objs)]
        failed = [p.args for p in procs if p.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed: {failed}")
        tmp = work / path.name
        subprocess.run([nvcc, *_FLAGS, "-shared", "-o", str(tmp),
                        *map(str, objs)], check=True)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load():
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                t0 = time.perf_counter()
                _compile(path)
                build_seconds = time.perf_counter() - t0
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib
