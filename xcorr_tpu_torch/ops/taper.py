r"""
:mod:`ops.taper` -- Window tapers
=================================

One/both-sided tapers by fraction or seconds (spec:
``xcorr/signal/taper.py`` and ``xcorr/signal/window.py``; port of
``xcorr_tpu/ops/taper.py``). The window is a small host-side float64
numpy vector; the multiply runs on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sp_signal
import torch

__all__ = ["taper_vector", "apply_taper"]


def taper_vector(n: int, wtype: str = "hann", max_percentage: float = None,
                 max_length: float = None, sampling_rate: float = 1.0,
                 side: str = "both", dtype=np.float32):
    """Build the length-n taper vector on the host (numpy).

    ``max_percentage`` is the tapered fraction per side; ``max_length``
    caps the taper length in seconds (obspy/reference convention).
    """
    if max_percentage is None and max_length is None:
        max_percentage = 0.05
    wlen = n // 2
    if max_percentage is not None:
        wlen = min(wlen, int(n * float(max_percentage)))
    if max_length is not None:
        wlen = min(wlen, int(float(max_length) * sampling_rate))
    taper = np.ones(n, dtype=dtype)
    if wlen < 1:
        return taper
    if wtype == "cosine":
        ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(wlen) / wlen))
    else:
        # the periodic window of 2*wlen equals the symmetric window of
        # 2*wlen+1 truncated, so this one ramp matches both obspy's
        # Trace.taper and the reference's signal-layer window
        ramp = sp_signal.get_window(wtype, 2 * wlen, fftbins=True)[:wlen]
    if side in ("both", "left"):
        taper[:wlen] = ramp
    if side in ("both", "right"):
        taper[n - wlen:] = ramp[::-1]
    return taper


def apply_taper(x, taper):
    """Elementwise taper along the last axis."""
    return x * torch.as_tensor(taper, dtype=x.dtype, device=x.device)
