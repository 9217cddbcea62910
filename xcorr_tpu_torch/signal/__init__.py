r"""
:mod:`xcorr_tpu_torch.signal` -- Labelled signal operations
===========================================================

The signal operations of :mod:`xcorr_tpu.signal` that the port has so
far: the postprocess chain (``unbias``, ``detrend``/``demean``,
``taper``/``window``, ``timeshift``, ``filter``) and the SNR ->
coincidence-trigger -> PSD analysis (``hilbert``/``envelope``,
``absolute``, ``rms``, ``snr``, the triggers, ``spectrogram``). The ops
that compute on tensors take ``device`` (``'cuda'`` by default, raising
without a card); the host-only ones are carried copies. Also registers
the ``.signal`` accessor on :class:`xcorr_tpu_torch.ndlabel.DataArray`.
"""

from .absolute import absolute, abs  # noqa: A004
from .detrend import detrend, demean
from .filter import filter  # noqa: A004
from .hilbert import hilbert, envelope
from .rms import rms
from .snr import snr
from .spectrogram import spectrogram, spectrogram_mtc
from .taper import taper
from .timeshift import timeshift
from .trigger import coincidence_trigger, trigger_periods, trigger_values
from .unbias import unbias, unbias_weights
from .window import window

from . import accessor  # noqa: F401  (registers .signal)

__all__ = ["absolute", "abs", "detrend", "demean", "filter", "hilbert",
           "envelope", "rms", "snr", "spectrogram", "spectrogram_mtc",
           "taper", "timeshift", "coincidence_trigger", "trigger_periods",
           "trigger_values", "unbias", "unbias_weights", "window"]
