r"""
:mod:`signal.accessor` -- ``.signal`` DataArray accessor
========================================================

Expose the ported signal ops as ``da.signal.<op>()`` (spec:
``xcorr/signal/accessor.py:52-327``; port of
``xcorr_tpu/signal/accessor.py``), with the reference's accessor API so
cookbook code ports unchanged. The device ops take ``device=`` like their
functions.

Bound here: the ops ported so far. The JAX package's accessor also binds
``correlate1d``/``correlate2d``, ``cwt``/``scaleogram``, ``fft``/``ifft``/
``rfft``/``irfft``, ``lombscargle``, ``norm1d``/``norm2d``,
``peak_local_max``, ``plane_wave_estimate`` and ``tri_mirror``; they join
with their modules (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from functools import wraps

from ..ndlabel import DataArray
from .absolute import absolute as _absolute
from .detrend import demean as _demean, detrend as _detrend
from .filter import filter as _filter
from .hilbert import envelope as _envelope, hilbert as _hilbert
from .rms import rms as _rms
from .snr import snr as _snr
from .spectrogram import spectrogram as _spectrogram, spectrogram_mtc as \
    _spectrogram_mtc
from .taper import taper as _taper
from .timeshift import timeshift as _timeshift
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
    coincidence_trigger = _bind(_coincidence_trigger)
    demean = _bind(_demean)
    detrend = _bind(_detrend)
    envelope = _bind(_envelope)
    filter = _bind(_filter)
    hilbert = _bind(_hilbert)
    rms = _bind(_rms)
    snr = _bind(_snr)
    spectrogram = _bind(_spectrogram)
    spectrogram_mtc = _bind(_spectrogram_mtc)
    taper = _bind(_taper)
    timeshift = _bind(_timeshift)
    unbias = _bind(_unbias)
    unbias_weights = _bind(_unbias_weights)
    window = _bind(_window)

    del _bind


# register on DataArray (property, like xarray's accessor registration)
def _signal(self):
    return SignalAccessor(self)


DataArray.signal = property(_signal)
