r"""
:mod:`stream._sosfilt` -- scipy's ``sosfilt`` loop in the native library
========================================================================

:func:`sosfilt_inplace` filters a float64 vector in place through
second-order sections from zero initial state, as scipy's own loop
(``scipy.signal._sosfilt._sosfilt``) does over the copy that
``scipy.signal.sosfilt`` makes, bit for bit. The native library
(``native/sosfilt.cpp``) runs the sections as a wavefront where the CPU
has AVX2 (:func:`lanes`): four sections to a register, section ``s``
working on sample ``t - 2s`` while section 0 works on sample ``t``, each
section through the same operations on the same operands in the same
order as scipy's loop, so the sections' recurrences overlap and nothing
rounds differently. Without AVX2, and for cascades of more than 12
sections, it runs scipy's own schedule.

The library is built with ``g++`` on first use (:mod:`..native._cxx`); a
failed build or load raises, and nothing falls back to scipy. Its calls
release the interpreter lock, so the fetch threads (``core/process.py``)
filter in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["sosfilt_inplace", "lanes"]

_SOURCES = ("sosfilt.cpp",)
_lib = None
_lock = threading.Lock()

_dbl = ctypes.POINTER(ctypes.c_double)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from ..native import _cxx
            lib = ctypes.CDLL(_cxx.build("libxcsosfilt", _SOURCES))
            lib.xcs_sosfilt.argtypes = [_dbl, ctypes.c_int64, _dbl,
                                        ctypes.c_int64]
            lib.xcs_sosfilt.restype = None
            lib.xcs_lanes.argtypes = []
            lib.xcs_lanes.restype = ctypes.c_int
            _lib = lib
    return _lib


def lanes():
    """Whether :func:`sosfilt_inplace` runs four sections to a register
    on this CPU (AVX2), for cascades of up to 12 sections."""
    return bool(_load().xcs_lanes())


def sosfilt_inplace(sos, x):
    """Filter the writable, C-contiguous 1-D float64 ``x`` in place
    through ``sos``, float64 of shape ``(n_sections, 6)`` with
    ``sos[:, 3] == 1``, from zero initial state; returns ``x``. The bits
    of ``scipy.signal.sosfilt(sos, x)``."""
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    if not (x.dtype == np.float64 and x.ndim == 1 and x.flags.c_contiguous
            and x.flags.writeable):
        raise ValueError("x must be a writable C-contiguous 1-D float64 "
                         "array")
    if not (sos.ndim == 2 and sos.shape[1] == 6
            and bool(np.all(sos[:, 3] == 1))):
        raise ValueError("sos must be of shape (n_sections, 6) with "
                         "sos[:, 3] == 1")
    _load().xcs_sosfilt(sos.ctypes.data_as(_dbl), sos.shape[0],
                        x.ctypes.data_as(_dbl), x.size)
    return x
