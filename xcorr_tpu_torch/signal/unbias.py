# Carried from xcorr_tpu/signal/unbias.py (see test_torch_host_copies).
r"""
:mod:`signal.unbias` -- Bias correction
=======================================

Scale the biased CC estimate by ``npts/(npts-|lag|·fs)`` weights derived
from the lag coordinate attrs (spec: ``xcorr/signal/unbias.py:30-145``).

Divergence from the reference: weights cover the full 2·npts-1 lag range
(the reference's construction drops the last two lags,
``xcorr/util/cc.py:136-138``, making unclipped unbias fail there).
"""

from __future__ import annotations

import warnings

import numpy as np

from ..ndlabel import DataArray
from ..util.history import historicize
from ..util.time import update_lag_indices
from ._helpers import get_dim
from ._unbias import span_weights

__all__ = ["unbias", "unbias_weights"]


def unbias(x, w=None, dim: str = None, name: str = None):
    """Bias-correct the CC array in the lag dimension."""
    dim = get_dim(x, dim)
    if "unbiased" not in x.attrs:
        raise ValueError("x has no unbiased attribute flag!")
    if x.attrs["unbiased"] != 0:
        warnings.warn("No need to bias correct again.")
        return x

    wv = unbias_weights(x.coords[dim]) if w is None else w
    if dim not in wv.dims:
        raise ValueError(f'w has no dimension "{dim}"!')
    if len(wv.dims) != 1:
        raise ValueError("w should have a single dimension!")

    y = x * wv.astype(x.dtype)
    y.name = name or x.name
    y.attrs = dict(x.attrs)
    y.attrs["unbiased"] = np.int8(True)
    if "long_name" in y.attrs:
        y.attrs["long_name"] = "Unbiased " + y.attrs["long_name"]
    if "standard_name" in y.attrs:
        y.attrs["standard_name"] = "unbiased_" + y.attrs["standard_name"]
    historicize(y, f="unbias", a={"x": x.name, "w": None if w is None
                                  else "DataArray", "dim": dim})
    return y


def unbias_weights(lag, name: str = "w"):
    """Weight vector from the lag coordinate's clip-index attrs."""
    update_lag_indices(lag)
    for attr in ("sampling_rate", "delta", "npts", "index_min", "index_max"):
        if attr not in lag.attrs:
            raise ValueError(f'Lag has no attribute "{attr}"!')
    w = span_weights(lag.attrs["npts"], lag.attrs["index_min"],
                     lag.attrs["index_max"])
    out = DataArray(w, dims=(lag.name,), name=name, attrs={
        "long_name": "Unbiased CC estimate scale factor", "units": "-"})
    out._coords = {lag.name: lag}
    return out
