r"""
:mod:`xcorr_tpu_torch.ops` -- Device compute
============================================

Plain PyTorch on tensors, plus the hand-written CUDA kernel of the
four-step correlation (:mod:`.fused_fft`). Counterpart of
:mod:`xcorr_tpu.ops` for the correlation path.
"""

from . import fft, fused_fft, fft4, cc

__all__ = ["fft", "fused_fft", "fft4", "cc"]
