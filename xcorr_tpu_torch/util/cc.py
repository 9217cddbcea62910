# Carried from xcorr_tpu/util/cc.py (see test_torch_host_copies).
r"""
:mod:`util.cc` -- Host-side correlation helpers
===============================================

Numpy implementations of the correlation lag/weight math and a reference
``cc`` kernel (spec: ``xcorr/util/cc.py``). The production compute path is
the batched JAX kernel in :mod:`xcorr_tpu.ops.cc`; this module provides the
coordinate/weight vectors shared by both and a slow eager fallback used in
tests and small host-side picks.

Note on ``weight``: the reference's vector construction
(``xcorr/util/cc.py:136-138``) truncates the last two lags (an ``arange``
off-by-two) and uses the removed ``np.int`` alias; here the weights cover
the full 2·npts-1 lag vector, agreeing with the reference's values on the
overlapping range.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cc", "lag", "weight", "extract_shift", "extract_shift_and_max",
           "compute_shift", "compute_shift_and_max"]


def cc(x: np.ndarray, y: np.ndarray, normalize: bool = True,
       pad: bool = True, unbiased: bool = True, dtype=None):
    """Frequency-domain cross-correlation of two equal-length vectors.

    Matches the reference estimator (``xcorr/util/cc.py:22-79``): zero-pad
    both N-vectors right-aligned into 2N-1 buffers, multiply spectra with the
    conjugate, normalize by the vector-norm product, fftshift, optionally
    apply unbiased weights.
    """
    n = len(x)
    dtype = dtype or x.dtype
    if n != len(y):
        raise ValueError("Vectors `x` and `y` should have the same length!")
    if pad:
        nn = 2 * n - 1
        xx = np.zeros(nn, dtype=dtype)
        xx[nn - n:] = x
        yy = np.zeros(nn, dtype=dtype)
        yy[nn - n:] = y
    else:
        nn = n
        xx, yy = np.asarray(x, dtype=dtype), np.asarray(y, dtype=dtype)
    fg = np.fft.fft(xx) * np.conjugate(np.fft.fft(yy))
    if normalize:
        fg = fg / (np.linalg.norm(xx) * np.linalg.norm(yy))
    Rxy = np.fft.fftshift(np.real(np.fft.ifft(fg))).astype(dtype)
    return Rxy * weight(nn, False).astype(dtype) if unbiased else Rxy


def lag(n: int, delta: float, pad: bool = True):
    """Cross-correlation lag vector in seconds: fftshifted sample lags
    (``xcorr/util/cc.py:82-108``).

    Computed directly as ``(-(nn-1)/2 .. (nn-1)/2) * delta`` (identical
    to the reference's fftshift(fftfreq(...)) for the always-odd padded
    length) with ONE allocation and in-place arithmetic: the fftfreq
    route touches ~6 fresh 69 MB buffers at day scale, which costs tens
    of seconds on first-touch-faulting (microVM) hosts."""
    nn = n * 2 - 1 if pad else n
    # arange - nn//2 matches fftshift(fftfreq) for odd AND even nn
    out = np.arange(nn, dtype=np.float64)
    out -= nn // 2
    out *= delta
    return out


def weight(n: int, pad: bool = True, clip: float = None):
    """Unbiased-estimate weight vector ``npts/(npts-|k|)`` over the full
    fftshifted lag range ``k = -(npts-1)..(npts-1)``."""
    nn = n * 2 - 1 if pad else n
    npts = (nn + 1) // 2
    k = np.arange(nn, dtype=np.float64) - (npts - 1)
    w = npts / (npts - np.abs(k))
    if clip is not None:
        w[w > clip] = clip
    return w


def extract_shift(Rxy: np.ndarray, delta: float = None):
    """Sample (or time) shift at the correlation maximum
    (``xcorr/util/cc.py:144-171``)."""
    zero_index = int(len(Rxy) / 2)
    shift = int(np.argmax(Rxy)) - zero_index
    return shift * (delta or 1)


def extract_shift_and_max(Rxy: np.ndarray, delta: float = None):
    """Shift at, and value of, the correlation maximum."""
    zero_index = int(len(Rxy) / 2)
    index_max = int(np.argmax(Rxy))
    shift = index_max - zero_index
    return shift * (delta or 1), Rxy[index_max]


def compute_shift(x: np.ndarray, y: np.ndarray, delta: float = None, **kw):
    """Correlate then extract the shift at the maximum."""
    return extract_shift_and_max(cc(x, y, **kw), delta)[0]


def compute_shift_and_max(x: np.ndarray, y: np.ndarray, delta: float = None,
                          **kw):
    """Correlate then extract shift and maximum."""
    return extract_shift_and_max(cc(x, y, **kw), delta)
