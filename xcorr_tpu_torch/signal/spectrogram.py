r"""
:mod:`signal.spectrogram` -- Labelled PSD spectrogram
=====================================================

Per-sample-hop STFT power spectrogram zero-padded to the input length
(spec: ``xcorr/signal/spectrogram.py:124-158`` =
scipy.signal.spectrogram with ``noverlap = win_len - 1``), plus
``spectrogram_mtc`` with manual segment control (``:200-335``); the STFT
runs on a torch device (port of ``xcorr_tpu/signal/spectrogram.py``).
"""

from __future__ import annotations

import numpy as np

from .. import ops
from ..ndlabel import DataArray
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import core_dim_last, get_dim

__all__ = ["spectrogram", "spectrogram_mtc"]


def spectrogram(x, duration: float = None, padding_factor: int = 2,
                scaling: str = "density", dim: str = None, device="cuda",
                **kwargs):
    """PSD spectrogram along ``dim`` with per-sample hop, zero-padded back
    to the input length, on ``device`` (``'cuda'`` by default, which
    raises without a card).

    ``duration``: segment length in seconds; ``padding_factor``: FFT
    zero-padding multiple.
    """
    dim = get_dim(x, dim)
    coord = x.coords[dim]
    if "sampling_rate" not in coord.attrs:
        raise ValueError(f'Dimension "{dim}" has no attribute '
                         '"sampling_rate"!')
    fs = float(coord.attrs["sampling_rate"])
    duration = duration or 2.5
    win_len = int(round(duration * fs))
    nfft = int(win_len * max(1, int(padding_factor or 1)))

    data, dims = core_dim_last(x, dim, device)
    freqs, psd = ops.spectrogram.stft_psd(
        data, win_len=win_len, hop=1, nfft=nfft, window="hann",
        sampling_rate=fs, scaling=scaling)
    psd = to_numpy(psd)  # (..., freq, frames)

    # zero-pad frames back to the input length, centered like scipy's
    # segment midpoints (reference zero-pads to input length)
    n = data.shape[-1]
    nframes = psd.shape[-1]
    pad_left = (n - nframes) // 2
    pad_right = n - nframes - pad_left
    pad = [(0, 0)] * (psd.ndim - 1) + [(pad_left, pad_right)]
    psd = np.pad(psd, pad)

    out_dims = tuple(d for d in dims if d != dim) + ("freq", dim)
    y = DataArray(psd.astype(x.dtype), dims=out_dims, name="psd", attrs={
        "long_name": "Power Spectral Density",
        "standard_name": "power_spectral_density",
        "units": "Hz**-1" if scaling == "density" else "-",
        "scaling": scaling,
        "mode": "psd",
        "duration": duration,
        "padding_factor": padding_factor,
        "centered": np.int8(True),
        **{k: v for k, v in x.attrs.items() if k == "history"},
    })
    y._coords = {k: c for k, c in x.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords["freq"] = DataArray(freqs, dims=("freq",), name="freq", attrs={
        "long_name": "Frequency", "standard_name": "frequency",
        "units": "s-1"})
    historicize(y, f="spectrogram", a={
        "x": x.name, "duration": duration,
        "padding_factor": padding_factor, "dim": dim})
    return y


def spectrogram_mtc(x, duration: float = None, overlap: float = 0.9,
                    padding_factor: int = 2, dim: str = None, device="cuda",
                    **kwargs):
    """Spectrogram with manual segment control: explicit hop from
    ``overlap`` and a new segment-time coordinate; on ``device``."""
    dim = get_dim(x, dim)
    coord = x.coords[dim]
    fs = float(coord.attrs["sampling_rate"])
    duration = duration or 2.5
    win_len = int(round(duration * fs))
    hop = max(1, int(round(win_len * (1 - overlap))))
    nfft = int(win_len * max(1, int(padding_factor or 1)))

    data, dims = core_dim_last(x, dim, device)
    freqs, psd = ops.spectrogram.stft_psd(
        data, win_len=win_len, hop=hop, nfft=nfft, window="hann",
        sampling_rate=fs, scaling="density")
    psd = to_numpy(psd)

    seg_dim = f"{dim}_seg"
    cvals = np.asarray(coord.values)
    centers = cvals[win_len // 2 + hop * np.arange(psd.shape[-1])]
    out_dims = tuple(d for d in dims if d != dim) + ("freq", seg_dim)
    y = DataArray(psd.astype(x.dtype), dims=out_dims, name="psd", attrs={
        "long_name": "Power Spectral Density",
        "units": "Hz**-1", "scaling": "density", "mode": "psd",
        "duration": duration, "overlap": overlap,
        "padding_factor": padding_factor})
    y._coords = {k: c for k, c in x.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords["freq"] = DataArray(freqs, dims=("freq",), name="freq", attrs={
        "long_name": "Frequency", "units": "s-1"})
    y._coords[seg_dim] = DataArray(centers, dims=(seg_dim,), name=seg_dim,
                                   attrs=dict(coord.attrs))
    historicize(y, f="spectrogram_mtc", a={
        "x": x.name, "duration": duration, "overlap": overlap, "dim": dim})
    return y
