r"""
:mod:`stream._lanczos` -- Lanczos interpolation of the host chain
=================================================================

:func:`lanczos_interp` computes what the carried
:func:`.trace._lanczos_interp` computes, bit for bit, without its 2a
passes of ``np.sinc`` over the whole output. A tap's weight depends only
on ``t = pos - (i0 + k)``, and where ``pos - i0`` is exact (``pos >= 0``
or ``pos <= -1``) that ``t`` equals ``(pos - i0) - k`` bit for bit. So
numpy evaluates the carried expression once per distinct phase
``pos - i0`` (a day at 40 -> 50 Hz has 85 of them), and once per sample
for the few samples with ``-1 < pos < 0``, where ``pos - i0`` may round.
The native library (``native/lanczos.cpp``) keys the phases and then
sums each sample's taps, its row of weights gathered, in the carried
order. A table holds at most :data:`BLOCK` rows of 2a weights: where
the phases are more, the output is made in blocks of :data:`BLOCK`
samples, so a geometry whose every sample has a phase of its own holds
at most ``BLOCK x 2a`` weights at once.

The library is built with ``g++`` on first use (:mod:`..native._cxx`);
a failed build or load raises, and nothing falls back to numpy. Its
calls release the interpreter lock, so threads that fetch windows
(``core/process.py``) interpolate in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["lanczos_interp"]

#: the most rows of 2a weights a table holds (at a = 20, 21 MB), and the
#: output samples per block when the phases are more
BLOCK = 1 << 16
_SOURCES = ("lanczos.cpp",)
_lib = None
_lock = threading.Lock()

_dbl = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.POINTER(ctypes.c_int64)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from ..native import _cxx
            lib = ctypes.CDLL(_cxx.build("libxclanczos", _SOURCES))
            lib.xcl_phases.argtypes = [_dbl, _i64, ctypes.c_int64,
                                       ctypes.c_int64, _dbl, _i64, _i64,
                                       _i64]
            lib.xcl_phases.restype = ctypes.c_int64
            lib.xcl_lanczos.argtypes = [_dbl, ctypes.c_int64, _i64, _i64,
                                        _dbl, ctypes.c_int32,
                                        ctypes.c_int64, _dbl]
            lib.xcl_lanczos.restype = None
            _lib = lib
    return _lib


def _weights(t, a):
    """The carried weight expression, elementwise on ``t``."""
    return np.sinc(t) * np.sinc(t / a) * (np.abs(t) < a)


def lanczos_interp(x, pos, a):
    """Lanczos windowed-sinc interpolation of the 1-D ``x`` at the
    fractional sample positions ``pos`` with ``a`` lobes: float64, equal
    to :func:`.trace._lanczos_interp` bit for bit, NaN for NaN."""
    a = int(a)
    x = np.ascontiguousarray(x, dtype=np.float64)
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n, npts = x.size, pos.size
    out = np.zeros(npts, dtype=np.float64)
    if npts == 0:
        return out
    if n == 0:
        # the carried gather of x[-1]
        raise IndexError("index -1 is out of bounds for axis 0 with size 0")
    lib = _load()
    i0 = np.floor(pos).astype(np.int64)
    ks = np.arange(-a + 1, a + 1)
    row = np.empty(npts, dtype=np.int64)
    keys = np.empty(BLOCK, dtype=np.float64)
    near = np.empty(BLOCK, dtype=np.int64)
    nnear = ctypes.c_int64()

    def phases(s, e):
        return lib.xcl_phases(
            pos[s:].ctypes.data_as(_dbl), i0[s:].ctypes.data_as(_i64),
            e - s, BLOCK, keys.ctypes.data_as(_dbl),
            row[s:].ctypes.data_as(_i64), near.ctypes.data_as(_i64),
            ctypes.byref(nnear))

    u = phases(0, npts)
    spans = [(0, npts)] if u >= 0 else \
        [(s, min(s + BLOCK, npts)) for s in range(0, npts, BLOCK)]
    for s, e in spans:
        if u < 0 or s > 0:
            u = phases(s, e)
        j = s + near[:nnear.value]
        t = np.concatenate([keys[:u, None] - ks,
                            pos[j, None] - (i0[j, None] + ks)])
        w = np.ascontiguousarray(_weights(t, a))
        lib.xcl_lanczos(x.ctypes.data_as(_dbl), n,
                        i0[s:].ctypes.data_as(_i64),
                        row[s:].ctypes.data_as(_i64),
                        w.ctypes.data_as(_dbl), a, e - s,
                        out[s:].ctypes.data_as(_dbl))
    return out
