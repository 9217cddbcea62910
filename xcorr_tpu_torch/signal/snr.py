r"""
:mod:`signal.snr` -- Signal-to-noise ratio
==========================================

Masked peak-over-RMS SNR (spec: ``xcorr/signal/snr.py:27-168``; port of
``xcorr_tpu/signal/snr.py``): ``s`` = peak |cc| (optionally of the
envelope, computed on the torch ``device``) in the signal window, ``n`` =
RMS of the noise window (float64, on the host), ``snr = s/n`` with
energy/power/dB variants; ``extend=True`` returns a Dataset with ``s``,
``n`` and the peak-lag coordinate.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..ndlabel import Dataset
from ..util.history import historicize
from ..util.metadata import global_attrs
from ._helpers import get_dim
from .absolute import absolute
from .hilbert import hilbert
from .rms import rms

__all__ = ["snr"]


def snr(x, signal, noise, dim: str = None, power: bool = False,
        decibels: bool = False, extend: bool = False,
        envelope: bool = False, device="cuda", **kwargs):
    """SNR of ``x`` given boolean signal/noise masks over ``dim``.

    ``device`` (``'cuda'`` by default) is resolved up front and raises
    without a card, whether or not ``envelope`` sends work to it.
    """
    from ..core.process import resolve_device
    device = resolve_device(device)
    dim = get_dim(x, dim)
    argmax = f"{dim}_s_max"
    if envelope and np.isnan(x.data).any():
        raise ValueError("x contains NaN values")

    ds = Dataset()
    t = x.coords.get("time")
    period = ""
    if t is not None and t.size:
        tv = pd.DatetimeIndex(np.atleast_1d(np.asarray(t.values)))
        period = " - {} to {}".format(tv[0].strftime("%Y.%j"),
                                      tv[-1].strftime("%Y.%j"))
    ds.attrs = global_attrs({
        "title": (kwargs.pop("title", "")
                  + f"Signal-to-noise ratio{period}").strip(),
        **kwargs,
        "references": (
            "Bendat, J. Samuel, & Piersol, A. Gerald. (1971). "
            "Random data : analysis and measurement procedures. "
            "New York (N.Y.): Wiley-Interscience."),
    })

    n_da = rms(x.where(noise, drop=True), dim=dim)
    s_in = absolute(hilbert(x, dim=dim, device=device) if envelope else x)
    s_in = s_in.where(signal, drop=True)

    peak_idx = s_in.argmax(dim)
    lag_vals = s_in.coords[dim].values[peak_idx.data]
    lag_da = peak_idx.copy(deep=False, data=lag_vals)
    lag_da.name = argmax
    lag_da.attrs = dict(s_in.coords[dim].attrs)

    s_da = s_in.max(dim)
    s_da.name = "s"
    snr_da = s_da / n_da
    if decibels:
        snr_da.data = 20 * np.log10(snr_da.data)
        power = True
    elif power:
        snr_da.data = np.square(snr_da.data)

    snr_da.name = "snr"
    snr_da.attrs = {
        "long_name": "Signal-to-noise ratio",
        "standard_name": "signal_to_noise_ratio",
        "units": "dB" if decibels else "-",
        "from_variable": x.name,
        "power": np.int8(power),
        "decibels": np.int8(decibels),
        "envelope": np.int8(envelope),
    }
    historicize(snr_da, f="snr", a={
        "x": x.name, "dim": dim, "power": power, "decibels": decibels,
        "envelope": envelope, "extend": extend})

    if not extend:
        return snr_da

    s_da.attrs = {**x.attrs, "long_name": "Peak signal amplitude",
                  "units": x.attrs.get("units", "-")}
    n_da.name = "n"
    n_da.attrs = {**x.attrs, "long_name": "Root-mean-square noise",
                  "units": x.attrs.get("units", "-")}
    ds["snr"] = snr_da
    ds["s"] = s_da
    ds["n"] = n_da
    ds[argmax] = lag_da
    return ds
