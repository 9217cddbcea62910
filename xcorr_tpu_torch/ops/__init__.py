r"""
:mod:`xcorr_tpu_torch.ops` -- Device compute
============================================

Plain PyTorch on tensors, plus the hand-written CUDA kernels of the
four-step correlation (:mod:`.fused_fft`). Counterpart of
:mod:`xcorr_tpu.ops`: the correlation path (:mod:`.fft`, :mod:`.fft4`,
:mod:`.cc`) and the preprocess ops of the device engine
(:mod:`.detrend`, :mod:`.taper`, :mod:`.filter`).
"""

from . import consts, fft, fused_fft, fft4, cc, detrend, taper, filter

__all__ = ["consts", "fft", "fused_fft", "fft4", "cc", "detrend", "taper",
           "filter"]
