r"""
:mod:`ops.spectrogram` -- Batched STFT power spectrograms
=========================================================

Framed rfft with arbitrary hop (spec: ``xcorr/signal/spectrogram.py:124-158``
= scipy.signal.spectrogram with per-sample hop and zero padding; port of
``xcorr_tpu/ops/spectrogram.py``).

The JAX package gathers every frame at once, ``(..., nframes, win_len)``:
with hop 1 that is ``win_len`` times the input, about 0.8 GB per
1.62 M-sample row at a 125-sample window, before the FFT multiplies it
again. Here the frames are taken in blocks along the signal axis
(``Tensor.unfold`` views, windowed and transformed a block at a time), so
the working memory is bounded by :data:`BLOCK_ELEMENTS`; each frame's
transform is independent, so the result is the same.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sp_signal
import torch

__all__ = ["stft_psd", "BLOCK_ELEMENTS"]

#: most elements of one block's zero-padded frame stack (all rows)
BLOCK_ELEMENTS = 1 << 25


def stft_psd(x, win_len: int, hop: int = 1, nfft: int = None,
             window: str = "hann", sampling_rate: float = 1.0,
             scaling: str = "density"):
    """Power spectrogram along the last axis.

    Returns ``(freqs, psd)`` with psd shaped ``(..., nfreq, nframes)``
    (frequency leading, matching the reference layout ``(freq, time)``).
    ``nframes = (n - win_len)//hop + 1``.
    """
    n = x.shape[-1]
    nfft = nfft or win_len
    win = sp_signal.get_window(window, win_len).astype(np.float64)
    nframes = max(0, (n - win_len) // hop + 1)
    w = torch.as_tensor(win, dtype=x.dtype, device=x.device)
    if scaling == "density":
        scale = 1.0 / (sampling_rate * float((win ** 2).sum()))
    else:  # 'spectrum'
        scale = 1.0 / float(win.sum() ** 2)
    # one-sided correction (all bins except DC and Nyquist doubled)
    nf = nfft // 2 + 1
    corr = np.full(nf, 2.0)
    corr[0] = 1.0
    if nfft % 2 == 0:
        corr[-1] = 1.0
    corr = torch.as_tensor(corr, dtype=x.dtype, device=x.device)

    psd = torch.empty(x.shape[:-1] + (nframes, nf), dtype=x.dtype,
                      device=x.device)
    rows = max(1, int(np.prod(x.shape[:-1])))
    block = max(1, BLOCK_ELEMENTS // (rows * nfft))
    for f0 in range(0, nframes, block):
        f1 = min(nframes, f0 + block)
        seg = x[..., f0 * hop:(f1 - 1) * hop + win_len]
        spec = torch.fft.rfft(seg.unfold(-1, win_len, hop) * w, n=nfft,
                              dim=-1)
        psd[..., f0:f1, :] = (spec.real ** 2 + spec.imag ** 2) * scale * corr
    freqs = np.fft.rfftfreq(nfft, d=1.0 / sampling_rate)
    return freqs, psd.transpose(-1, -2)
