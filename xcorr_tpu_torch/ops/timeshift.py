r"""
:mod:`ops.timeshift` -- Sub-sample spectral time shift
======================================================

Shift signals by (possibly per-row) sub-sample delays via
``rfft -> X·exp(-2πi·delay·f) -> irfft``
(spec: ``xcorr/signal/timeshift.py:90-96``; port of
``xcorr_tpu/ops/timeshift.py``).

The phase ramp ``2π f delay`` is built in the data's dtype, as the JAX
package builds it: in float32 its rounding exceeds the FFT's for delays
of seconds, and the port keeps that arithmetic so the two packages'
float32 outputs can be held to each other.
"""

from __future__ import annotations

import math

import torch

from .fft import next_fast_len

__all__ = ["timeshift"]


def timeshift(x, delay, delta: float, nfft: int = None):
    """Shift ``x`` along the last axis by ``delay`` seconds.

    ``delay`` broadcasts against the batch dims (e.g. per-(pair, time)
    offsets). Positive delay moves the signal to later times. ``nfft``
    defaults to the next cuFFT-friendly length (``ops.fft``), not the JAX
    package's TPU-safe one; the labelled wrapper always passes the row
    length.
    """
    n = x.shape[-1]
    nfft = nfft or next_fast_len(n)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    # frequencies in float64, then the data's dtype (as the JAX package
    # forms them under x64)
    f = (torch.arange(nfft // 2 + 1, dtype=torch.float64, device=x.device)
         / (delta * nfft)).to(x.dtype)
    delay = torch.as_tensor(delay, dtype=x.dtype, device=x.device)[..., None]
    theta = (-2.0 * math.pi) * f * delay
    y = torch.fft.irfft(X * torch.complex(torch.cos(theta), torch.sin(theta)),
                        n=nfft, dim=-1)
    return y[..., :n].to(x.dtype)
