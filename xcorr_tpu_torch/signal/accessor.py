r"""
:mod:`signal.accessor` -- ``.signal`` DataArray accessor
========================================================

Expose every signal op as ``da.signal.<op>()`` (spec:
``xcorr/signal/accessor.py:52-327``; port of
``xcorr_tpu/signal/accessor.py``), with the reference's accessor API so
cookbook code ports unchanged. The device ops take ``device=`` like their
functions.
"""

from __future__ import annotations

from functools import wraps

from ..ndlabel import DataArray
from .absolute import absolute as _absolute
from .beamform import plane_wave_estimate as _plane_wave_estimate
from .correlate import correlate1d as _correlate1d, correlate2d as \
    _correlate2d
from .cwt import cwt as _cwt, scaleogram as _scaleogram
from .detrend import demean as _demean, detrend as _detrend
from .fft import fft as _fft, ifft as _ifft, irfft as _irfft, rfft as _rfft
from .filter import filter as _filter
from .hilbert import envelope as _envelope, hilbert as _hilbert
from .lombscargle import lombscargle as _lombscargle
from .normalize import norm1d as _norm1d, norm2d as _norm2d
from .peak_local_max import peak_local_max as _peak_local_max
from .rms import rms as _rms
from .snr import snr as _snr
from .spectrogram import spectrogram as _spectrogram, spectrogram_mtc as \
    _spectrogram_mtc
from .taper import taper as _taper
from .timeshift import timeshift as _timeshift
from .tri import tri_mirror as _tri_mirror
from .trigger import coincidence_trigger as _coincidence_trigger
from .unbias import unbias as _unbias, unbias_weights as _unbias_weights
from .window import window as _window


class SignalAccessor:
    """``da.signal.*``: labelled signal ops bound to a DataArray."""

    def __init__(self, da):
        self._da = da

    def _bind(fn):  # noqa: N805
        @wraps(fn)
        def method(self, *args, **kwargs):
            return fn(self._da, *args, **kwargs)
        return method

    absolute = _bind(_absolute)
    abs = _bind(_absolute)
    correlate1d = _bind(_correlate1d)
    correlate2d = _bind(_correlate2d)
    cwt = _bind(_cwt)
    scaleogram = _bind(_scaleogram)
    coincidence_trigger = _bind(_coincidence_trigger)
    demean = _bind(_demean)
    detrend = _bind(_detrend)
    envelope = _bind(_envelope)
    fft = _bind(_fft)
    ifft = _bind(_ifft)
    rfft = _bind(_rfft)
    irfft = _bind(_irfft)
    filter = _bind(_filter)
    hilbert = _bind(_hilbert)
    lombscargle = _bind(_lombscargle)
    norm1d = _bind(_norm1d)
    norm2d = _bind(_norm2d)
    peak_local_max = _bind(_peak_local_max)
    plane_wave_estimate = _bind(_plane_wave_estimate)
    rms = _bind(_rms)
    snr = _bind(_snr)
    spectrogram = _bind(_spectrogram)
    spectrogram_mtc = _bind(_spectrogram_mtc)
    taper = _bind(_taper)
    timeshift = _bind(_timeshift)
    tri_mirror = _bind(_tri_mirror)
    unbias = _bind(_unbias)
    unbias_weights = _bind(_unbias_weights)
    window = _bind(_window)

    del _bind


# register on DataArray (property, like xarray's accessor registration)
def _signal(self):
    return SignalAccessor(self)


DataArray.signal = property(_signal)
