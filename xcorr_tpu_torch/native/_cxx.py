r"""
:mod:`native._cxx` -- Builds the port's host libraries with ``g++``
===================================================================

Each library is built on first use into the port's build directory
(``ops._build.build_dir()``, git-ignored), never into the package. Its
name carries a hash of every source it compiles and of the flags, so an
edited source rebuilds. A failed compile raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

__all__ = ["FLAGS", "build"]

_DIR = os.path.dirname(os.path.abspath(__file__))

#: the flags of ``xcorr_tpu/native/Makefile``, and no contraction of a
#: product and a sum into one rounding: the libraries repeat Python's and
#: numpy's float arithmetic operation by operation
FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-ffp-contract=off",
         "-shared")


def build(stem: str, sources, flags=None) -> str:
    """Path of ``<stem>-<hash>.so``, compiled from the last of
    ``sources`` (files of this directory; the last includes the others)
    with ``flags`` (default :data:`FLAGS`) when it is not built yet."""
    from ..ops._build import build_dir
    flags = FLAGS if flags is None else flags
    srcs = [os.path.join(_DIR, name) for name in sources]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    path = build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}"
        subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", tmp,
                        srcs[-1]], check=True)
        os.replace(tmp, path)
    return str(path)
