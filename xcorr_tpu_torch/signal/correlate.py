r"""
:mod:`signal.correlate` -- Labelled 1-D/2-D cross-correlation
=============================================================

Frequency-domain correlation of two equal-shape labelled arrays along one
dim (``correlate1d``, spec ``xcorr/signal/correlate.py:32-159``) or the
trailing two dims (``correlate2d``, spec ``:162-291``), producing new
``delta_{dim}`` coordinates of size 2N-1 (port of
``xcorr_tpu/signal/correlate.py``). Both run on a torch device:
``correlate1d`` through :func:`xcorr_tpu_torch.ops.cc.correlate`,
``correlate2d`` through ``torch.fft.rfft2``/``irfft2`` padded to the
port's cuFFT-fast lengths, with the lag slices taken from those lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..ndlabel import DataArray
from ..util import cc as cc_host
from ..util.convert import to_device, to_numpy
from ..util.history import historicize
from ._helpers import check_regular, core_dim_last, get_dim
from .normalize import norm1d, norm2d

__all__ = ["correlate1d", "correlate2d"]


def _delta_of(coord):
    vals = np.asarray(coord.values)
    if np.issubdtype(vals.dtype, np.datetime64):
        vals = vals.astype("datetime64[ns]").astype(np.int64) / 1e9
    return float(np.round(np.abs(vals[1] - vals[0]), decimals=10))


def _delta_coord(coord, name):
    n = coord.size
    delta = _delta_of(coord)
    lag = cc_host.lag(n, delta, pad=True)
    return DataArray(lag, dims=(name,), name=name, attrs={
        "long_name": f"Delta {coord.attrs.get('long_name', coord.name)}",
        "standard_name":
            f"delta_{coord.attrs.get('standard_name', coord.name)}",
        "units": coord.attrs.get("units", "s"),
        "delta": delta,
        "npts": n,
        "sampling_rate": 1.0 / delta if delta else 1.0,
        "index_min": 0,
        "index_max": 2 * n - 1,
    })


def correlate1d(in1, in2, dim: str = None, normalize: bool = True,
                dtype=None, device="cuda", **kwargs):
    """Cross-correlate two equal-shape arrays along ``dim`` on ``device``
    (``'cuda'`` by default, which raises without a card); the output
    replaces ``dim`` with ``delta_{dim}`` of size 2N-1."""
    dim = get_dim(in1, dim)
    if in1.shape != in2.shape:
        raise ValueError("in1 and in2 should have the same shape")
    check_regular(in1, dim)

    if normalize:
        in1 = norm1d(in1, dim=dim)
        in2 = norm1d(in2, dim=dim)

    d1, dims = core_dim_last(in1, dim, device)
    d2, _ = core_dim_last(in2, dim, device)
    n = d1.shape[-1]
    out = ops.cc.correlate(d1.reshape(-1, n), d2.reshape(-1, n),
                           normalize=False).reshape(d1.shape[:-1] + (-1,))

    new_dim = f"delta_{dim}"
    out_dims = tuple(new_dim if d == dim else d for d in dims)
    odt = np.dtype(dtype or in1.dtype)
    y = DataArray(to_numpy(out).astype(odt), dims=out_dims,
                  name="cc", attrs=_cc_attrs(in1, in2, normalize, odt))
    y._coords = {k: c for k, c in in1.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords[new_dim] = _delta_coord(in1.coords[dim], new_dim)
    historicize(y, f="correlate1d", a={
        "in1": in1.name, "in2": in2.name, "dim": dim,
        "normalize": normalize})
    return y


def _cc_attrs(in1, in2, normalize, dtype):
    """The reference's canonical cc output attrs
    (``xcorr/signal/correlate.py:135-149``) — NOT in1's attrs, so
    downstream ops like ``signal.unbias`` see the correct flags."""
    t = dtype.type
    return {
        "long_name": "Cross-correlation Estimate",
        "standard_name": "cross_correlation_estimate",
        "units": "-",
        "add_offset": t(0.0),
        "scale_factor": t(1.0),
        "valid_range": np.array([-1.0, 1.0], dtype=dtype),
        "normalize": np.byte(normalize),
        "bias_correct": np.byte(0),
        "unbiased": np.byte(0),
        "history_in1": in1.attrs.get("history", ""),
        "history_in2": in2.attrs.get("history", ""),
    }


def correlate2d(in1, in2, dims: tuple = None, normalize: bool = True,
                dtype=None, device="cuda", **kwargs):
    """Cross-correlate two arrays over their trailing two dims via rfft2
    on ``device``, producing ``delta_{d1}``/``delta_{d2}`` coordinates."""
    from ..core.process import resolve_device
    device = resolve_device(device)
    dims = tuple(dims) if dims else in1.dims[-2:]
    if len(dims) != 2:
        raise ValueError("dims should contain two dimensions")
    for d in dims:
        if d not in in1.dims or d not in in2.dims:
            raise ValueError(f'missing dimension "{d}"')
    if in1.shape != in2.shape:
        raise ValueError("in1 and in2 should have the same shape")

    if normalize:
        in1 = norm2d(in1, dims=dims)
        in2 = norm2d(in2, dims=dims)

    order = tuple(d for d in in1.dims if d not in dims) + dims
    a = to_device(in1.transpose(*order).data, device)
    b = to_device(in2.transpose(*order).data, device)
    n1, n2 = a.shape[-2], a.shape[-1]
    f1 = ops.fft.next_fast_len(2 * n1 - 1)
    f2 = ops.fft.next_fast_len(2 * n2 - 1)
    A = torch.fft.rfft2(a, s=(f1, f2))
    B = torch.fft.rfft2(b, s=(f1, f2))
    r = torch.fft.irfft2(A * torch.conj(B), s=(f1, f2))
    # circular -> fftshifted linear lags on both axes
    r = ops.cc.lag_slice_of_circular(r.movedim(-2, -1), n1, f1, 0,
                                     2 * n1 - 1).movedim(-1, -2)
    r = ops.cc.lag_slice_of_circular(r, n2, f2, 0, 2 * n2 - 1)

    nd1, nd2 = f"delta_{dims[0]}", f"delta_{dims[1]}"
    out_dims = tuple(d for d in order[:-2]) + (nd1, nd2)
    odt = np.dtype(dtype or in1.dtype)
    y = DataArray(to_numpy(r).astype(odt), dims=out_dims,
                  name="cc", attrs=_cc_attrs(in1, in2, normalize, odt))
    y._coords = {k: c for k, c in in1.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords[nd1] = _delta_coord(in1.coords[dims[0]], nd1)
    y._coords[nd2] = _delta_coord(in1.coords[dims[1]], nd2)
    historicize(y, f="correlate2d", a={
        "in1": in1.name, "in2": in2.name, "dim": list(dims),
        "normalize": normalize})
    return y
