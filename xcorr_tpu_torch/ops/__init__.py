r"""
:mod:`xcorr_tpu_torch.ops` -- Device compute
============================================

Plain PyTorch on tensors, plus the hand-written CUDA kernels of the
four-step correlation (:mod:`.fused_fft`) and of the timelapse's cells
(:mod:`.cells`). Counterpart of
:mod:`xcorr_tpu.ops`: the correlation path (:mod:`.fft`, :mod:`.fft4`,
:mod:`.cc`), the preprocess ops of the device engine
(:mod:`.detrend`, :mod:`.taper`, :mod:`.filter`) and the analysis ops
(:mod:`.timeshift`, :mod:`.spectrogram`).
"""

from . import (consts, fft, fused_fft, fft4, cc, cells, detrend, taper,
               filter, timeshift, spectrogram)

__all__ = ["consts", "fft", "fused_fft", "fft4", "cc", "cells", "detrend",
           "taper", "filter", "timeshift", "spectrogram"]
