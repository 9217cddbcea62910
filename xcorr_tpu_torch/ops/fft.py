r"""
:mod:`ops.fft` -- FFT sizing
============================

FFT length selection for cuFFT. The reference correlates at the odd length
2·npts-1 (8,639,999 = 29 × 297,931 for the canonical day window); cuFFT is
fast on lengths whose only prime factors are 2, 3, 5 and 7, so every
spectral kernel pads to the next such length and keeps the lag bookkeeping
exact.

Counterpart of ``xcorr_tpu/ops/fft.py``, without the TPU-only restriction
of the odd part to {1, 3, 5, 9, 15}; its spectral helpers :func:`rfft`,
:func:`irfft` (``torch.fft`` on the tensor's device) and
:func:`rfft_freqs` (numpy, on the host).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["next_fast_len", "CUFFT_RADICES", "rfft_freqs", "rfft", "irfft"]

#: prime factors cuFFT decomposes with its fastest kernels
CUFFT_RADICES = (2, 3, 5, 7)


@lru_cache(maxsize=None)
def next_fast_len(n: int, radices: tuple = CUFFT_RADICES) -> int:
    """Smallest length ``>= n`` whose prime factors all lie in ``radices``.

    The canonical padded day correlation (2·4,320,000-1 = 8,639,999) maps
    to 8,640,000 = 2^9·3^3·5^4. ``radices=(2,)`` gives the next power of
    two.
    """
    if n <= 1:
        return 1
    limit = 1
    while limit < n:
        limit *= 2
    vals = {1}
    for r in radices:
        new = set(vals)
        for v in vals:
            x = v
            while x * r <= limit:
                x *= r
                new.add(x)
        vals = new
    return min(v for v in vals if v >= n)



def rfft_freqs(nfft: int, delta: float):
    """Real-FFT frequency vector (numpy, host side)."""
    return np.fft.rfftfreq(nfft, d=delta)


def rfft(x, nfft: int):
    """Batched real FFT along the last axis, zero-padded to ``nfft``."""
    return torch.fft.rfft(x, n=nfft, dim=-1)


def irfft(X, nfft: int):
    """Batched inverse real FFT along the last axis."""
    return torch.fft.irfft(X, n=nfft, dim=-1)
