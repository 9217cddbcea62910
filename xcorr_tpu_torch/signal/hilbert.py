r"""
:mod:`signal.hilbert` -- Analytic signal and envelope
=====================================================

Frequency-domain analytic signal (spec: ``xcorr/signal/hilbert.py:29-120``
= scipy.signal.hilbert) and its magnitude envelope, on a torch device
(port of ``xcorr_tpu/signal/hilbert.py``).

Float32 input gives complex64 (and its envelope float32), as the JAX
package gives without x64; under x64 the JAX package multiplies by a
float64 mask and returns complex128.
"""

from __future__ import annotations

import numpy as np
import torch

from ..util.history import historicize
from ._helpers import core_dim_last, get_dim, wrap_like

__all__ = ["hilbert", "envelope"]


def _analytic(data):
    n = data.shape[-1]
    X = torch.fft.fft(data, dim=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[0] = 1
        h[1:(n + 1) // 2] = 2
    return torch.fft.ifft(
        X * torch.as_tensor(h, dtype=X.real.dtype, device=X.device), dim=-1)


def hilbert(x, dim: str = None, device="cuda", **kwargs):
    """Analytic signal of ``x`` along ``dim`` (complex output) on
    ``device`` (``'cuda'`` by default, which raises without a card)."""
    dim = get_dim(x, dim)
    data, dims = core_dim_last(x, dim, device)
    y = wrap_like(_analytic(data), x, dims)
    historicize(y, f="hilbert", a={"x": x.name, "dim": dim})
    return y


def envelope(x, dim: str = None, device="cuda", **kwargs):
    """Amplitude envelope: |hilbert(x)|."""
    from .absolute import absolute
    y = absolute(hilbert(x, dim=dim, device=device, **kwargs))
    historicize(y, f="envelope", a={"x": x.name, "dim": dim})
    return y
