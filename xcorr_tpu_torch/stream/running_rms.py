# Carried from xcorr_tpu/stream/running_rms.py (see test_torch_host_copies).
r"""
:mod:`stream.running_rms` -- Running-window RMS
===============================================

Windowed RMS of a Trace/Stream producing derived traces at the window rate,
with SEED band codes remapped by window length
(reference: ``xcorr/stream/running_rms.py:19-115``).
"""

from __future__ import annotations

import numpy as np

from .trace import Stream, Trace

__all__ = ["running_rms", "running_rms_stream", "running_rms_trace"]


def _band_code(window: float):
    """Derived SEED band code by window length (reference mapping
    ``xcorr/stream/running_rms.py:95-101``): U >= 1h, V >= 1min, L
    otherwise."""
    if window >= 3600.0:
        return "U"
    if window >= 60.0:
        return "V"
    return "L"


def running_rms(waveforms, window: float = 60.0, **kw):
    """Running-window RMS of a Trace or Stream."""
    if isinstance(waveforms, Trace):
        return running_rms_trace(waveforms, window)
    return running_rms_stream(waveforms, window)


def running_rms_stream(stream: Stream, window: float = 60.0):
    """Per-trace running RMS."""
    return Stream([running_rms_trace(tr, window) for tr in stream])


def running_rms_trace(trace: Trace, window: float = 60.0):
    """RMS over non-overlapping windows of ``window`` seconds."""
    npts_win = int(round(window * trace.stats.sampling_rate))
    if npts_win < 1:
        raise ValueError("window shorter than one sample")
    nwin = trace.stats.npts // npts_win
    if nwin < 1:
        raise ValueError("trace shorter than one window")
    x = trace.data[: nwin * npts_win].astype(np.float64)
    rms = np.sqrt(np.mean(x.reshape(nwin, npts_win) ** 2, axis=-1))
    stats = trace.stats.copy()
    stats.sampling_rate = 1.0 / window
    stats.npts = nwin
    stats.channel = _band_code(window) + trace.stats.channel[1:]
    return Trace(rms, stats)
