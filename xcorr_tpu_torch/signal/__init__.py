r"""
:mod:`xcorr_tpu_torch.signal` -- Labelled signal operations
===========================================================

The signal operations of :mod:`xcorr_tpu.signal`: the postprocess chain
(``unbias``, ``detrend``/``demean``, ``taper``/``window``, ``timeshift``,
``filter``), the SNR -> coincidence-trigger -> PSD analysis
(``hilbert``/``envelope``, ``absolute``, ``rms``, ``snr``, the triggers,
``spectrogram``) and the rest of the analysis tier (``fft``/``ifft``/
``rfft``/``irfft``, ``correlate1d``/``correlate2d``,
``plane_wave_estimate``, ``cwt``/``scaleogram``, ``peak_local_max``,
``lombscargle``, ``norm1d``/``norm2d``, ``tri_mask``/``tri_mirror``). The
ops that compute on tensors take ``device`` (``'cuda'`` by default,
raising without a card); the host-only ones are carried copies. Also
registers the ``.signal`` accessor on
:class:`xcorr_tpu_torch.ndlabel.DataArray`.
"""

from .absolute import absolute, abs  # noqa: A004
from .beamform import plane_wave_estimate
from .correlate import correlate1d, correlate2d
from .cwt import cwt, scaleogram
from .detrend import detrend, demean
from .fft import fft, ifft, rfft, irfft
from .filter import filter  # noqa: A004
from .hilbert import hilbert, envelope
from .lombscargle import lombscargle
from .normalize import norm1d, norm2d
from .peak_local_max import peak_local_max
from .rms import rms
from .snr import snr
from .spectrogram import spectrogram, spectrogram_mtc
from .taper import taper
from .timeshift import timeshift
from .tri import tri_mask, tri_mirror
from .trigger import coincidence_trigger, trigger_periods, trigger_values
from .unbias import unbias, unbias_weights
from .window import window

from . import accessor  # noqa: F401  (registers .signal)

__all__ = ["absolute", "abs", "plane_wave_estimate", "correlate1d",
           "correlate2d", "cwt", "scaleogram", "detrend", "demean", "fft",
           "ifft", "rfft", "irfft", "filter", "hilbert", "envelope",
           "lombscargle", "norm1d", "norm2d", "peak_local_max", "rms",
           "snr", "spectrogram", "spectrogram_mtc", "taper", "timeshift",
           "tri_mask", "tri_mirror", "coincidence_trigger",
           "trigger_periods", "trigger_values", "unbias", "unbias_weights",
           "window"]
