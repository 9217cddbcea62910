r"""
:mod:`signal.cwt` -- Continuous wavelet transform / scaleogram
==============================================================

Complex Morlet CWT with log-spaced scales from the wavelet center
frequency (spec: ``xcorr/signal/cwt.py:28-261``, default wavelet
``cmor1.5-1.0``; port of ``xcorr_tpu/signal/cwt.py``): the FFT-domain
wavelet filter bank of the JAX package, one batched complex multiply and
inverse FFT per block of scales on a torch device. The complex Morlet
``psi(t) = (pi*B)^(-1/2) exp(2i*pi*C*t) exp(-t^2/B)`` and the
scale-to-frequency mapping ``f = C * fs / scale`` match pywt's cmorB-C
definition.

Float32 input is transformed in complex64, as the JAX package does
without x64, and the output is cast to ``dtype`` (complex128 by
default). The ``(..., nscales, n)`` output is built in blocks of scales of
at most :data:`BLOCK_ELEMENTS` complex elements on the device, each
copied to the host output as it is done: one full-width window at 100
scales is 2.6 GB in complex128.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..ndlabel import DataArray
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import core_dim_last, get_dim

__all__ = ["cwt", "scaleogram", "BLOCK_ELEMENTS"]

#: most complex elements of one block of scales on the device (all rows)
BLOCK_ELEMENTS = 1 << 25


def _parse_cmor(wavelet: str):
    m = re.match(r"cmor([\d.]+)-([\d.]+)", wavelet)
    if not m:
        raise ValueError(f"unsupported wavelet {wavelet!r}; expected "
                         "'cmorB-C'")
    return float(m.group(1)), float(m.group(2))


def cwt(x, wavelet: str = "cmor1.5-1.0", scales=None, freqs=None,
        nfreqs: int = 100, fmin: float = None, fmax: float = None,
        dim: str = None, dtype=None, device="cuda", **kwargs):
    """Complex CWT along ``dim`` on ``device`` (``'cuda'`` by default,
    which raises without a card); the output gains a labelled ``freq``
    dimension before ``dim``."""
    dim = get_dim(x, dim)
    coord = x.coords[dim]
    if "sampling_rate" in coord.attrs:
        fs = float(coord.attrs["sampling_rate"])
    else:
        vals = np.asarray(coord.values, dtype=np.float64)
        fs = 1.0 / float(np.abs(vals[1] - vals[0]))
    B, C = _parse_cmor(wavelet)

    n = x.sizes[dim]
    if freqs is None:
        if scales is not None:
            freqs = C * fs / np.asarray(scales, dtype=np.float64)
        else:
            fmax = fmax or fs / 2
            fmin = fmin or max(fs / n * 4, fmax / 1000)
            freqs = np.logspace(np.log10(fmin), np.log10(fmax), nfreqs)
    freqs = np.asarray(freqs, dtype=np.float64)
    scales_out = C * fs / freqs

    data, dims = core_dim_last(x, dim, device)
    X = torch.fft.fft(data, dim=-1)  # (..., n)
    w = np.fft.fftfreq(n, d=1.0 / fs)  # Hz

    # FT(psi)(f) = exp(-pi^2 B (f - C)^2); the scaled wavelet
    # psi(t/s)/sqrt(s) has sqrt(s) exp(-pi^2 B (s f/fs - C)^2), s in
    # samples
    odt = np.dtype(dtype or np.complex128)
    out = np.empty(tuple(X.shape[:-1]) + (freqs.size, n), dtype=odt)
    rows = max(1, int(np.prod(X.shape[:-1])))
    block = max(1, BLOCK_ELEMENTS // (rows * n))
    for k0 in range(0, freqs.size, block):
        s = scales_out[k0:k0 + block, None]
        H = np.exp(-np.pi ** 2 * B * (s * w[None, :] / fs - C) ** 2)
        H = H * np.sqrt(s / fs)  # (block, n)
        Hd = torch.as_tensor(H, dtype=X.real.dtype, device=X.device)
        out[..., k0:k0 + block, :] = to_numpy(
            torch.fft.ifft(X[..., None, :] * Hd, dim=-1))

    out_dims = tuple(d for d in dims if d != dim) + ("freq", dim)
    y = DataArray(out, dims=out_dims, name=x.name, attrs=dict(x.attrs))
    y._coords = {k: c for k, c in x.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords["freq"] = DataArray(freqs, dims=("freq",), name="freq", attrs={
        "long_name": "Frequency", "standard_name": "frequency",
        "units": "s-1", "wavelet": wavelet})
    historicize(y, f="cwt", a={"x": x.name, "wavelet": wavelet, "dim": dim})
    return y


def scaleogram(x, **kwargs):
    """|CWT|² power scaleogram (the reference's timelapse/psd input,
    ``xcorr/scripts/timelapse.py:208-209``); ``device`` as :func:`cwt`."""
    from .absolute import absolute
    y = absolute(cwt(x, **kwargs))
    y.data = y.data ** 2
    y.name = "psd"
    y.attrs["long_name"] = "Scaleogram Power"
    historicize(y, f="scaleogram", a={})
    return y
