r"""
:mod:`signal.fft` -- Labelled spectral transforms
=================================================

fft/ifft/rfft/irfft with labelled ``freq``/``time`` coordinates and
"reciprocal attrs" stored on the new coordinate so the inverse transform
restores the original dim name/attrs/origin
(spec: ``xcorr/signal/fft.py:32-544``; port of ``xcorr_tpu/signal/fft.py``).
The transforms run on a torch device; the dtype rules and the labelling
are the JAX package's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ndlabel import DataArray
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import core_dim_last, get_dim

__all__ = ["fft", "ifft", "rfft", "irfft"]

_recip_name = "__reciprocal_name__"
_recip_attr = "__reciprocal_attr__"
_recip_zero = "__reciprocal_zero__"


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _load_reciprocal_attrs(coord):
    name = coord.attrs.get(_recip_name)
    attr = (json.loads(coord.attrs[_recip_attr])
            if _recip_attr in coord.attrs else None)
    return name, attr


def _dump_reciprocal_attrs(coord):
    attrs = {a: coord.attrs[a]
             for a in ("long_name", "standard_name", "units")
             if a in coord.attrs}
    return {
        _recip_name: coord.name,
        _recip_attr: json.dumps(attrs),
        _recip_zero: float(np.asarray(coord.values)[0]),
    }


def _new_dim_checks(x, dim, new_dim, default, new_dim_attrs):
    old_dim, old_dim_attrs = _load_reciprocal_attrs(x.coords[dim])
    new_dim = new_dim or old_dim or default
    if not isinstance(new_dim, str):
        raise TypeError("new_dim should be a string")
    if new_dim in x.dims:
        raise ValueError(f'x already has a dimension "{new_dim}"')
    new_dim_attrs = new_dim_attrs or old_dim_attrs or dict()
    if not isinstance(new_dim_attrs, dict):
        raise TypeError("new_dim_attrs should be a dictionary")
    return new_dim, new_dim_attrs


def _attach_new_coord(y, x, dims, dim, new_dim, values, base_attrs,
                      new_dim_attrs):
    out_dims = tuple(new_dim if d == dim else d for d in dims)
    out = DataArray(np.asarray(y), dims=out_dims, name=x.name,
                    attrs=dict(x.attrs))
    out._coords = {k: c for k, c in x.coords.items()
                   if all(d in out_dims for d in c.dims)}
    coord = DataArray(values, dims=(new_dim,), name=new_dim, attrs={
        **x.coords[dim].attrs, **base_attrs, **new_dim_attrs,
        **_dump_reciprocal_attrs(x.coords[dim]),
    })
    out._coords[new_dim] = coord
    return out


def fft(x, dim: str = None, new_dim: str = None, new_dim_attrs: dict = None,
        dtype=None, device="cuda", **kwargs):
    """Shifted complex FFT along ``dim`` with a labelled ``freq`` coord, on
    ``device`` (``'cuda'`` by default, which raises without a card)."""
    dim = get_dim(x, dim)
    new_dim, new_dim_attrs = _new_dim_checks(x, dim, new_dim, "freq",
                                             new_dim_attrs)
    dtype = np.dtype(dtype or ("complex64" if x.dtype.itemsize <= 4
                               else "complex128"))
    if "complex" not in dtype.name:
        raise TypeError("dtype should be complex.")

    coord = np.asarray(x.coords[dim].values, dtype=np.float64)
    delta = np.round(np.fabs(coord[1] - coord[0]), decimals=10)
    freq = np.fft.fftshift(np.fft.fftfreq(coord.size, d=delta))

    data, dims = core_dim_last(x, dim, device)
    F = torch.fft.fftshift(torch.fft.fft(data.to(_torch_dtype(dtype)),
                                         dim=-1), dim=-1)
    out = _attach_new_coord(
        to_numpy(F).astype(dtype), x, dims, dim, new_dim, freq,
        {"long_name": "Frequency", "standard_name": "frequency",
         "units": "s-1"}, new_dim_attrs)
    if dims != tuple(new_dim if d == dim else d for d in x.dims):
        out = out.transpose(*(new_dim if d == dim else d for d in x.dims))
    historicize(out, f="fft", a={"x": x.name, "dim": dim,
                                 "new_dim": new_dim})
    return out


def ifft(x, dim: str = None, new_dim: str = None, new_dim_attrs: dict = None,
         dtype=None, device="cuda", **kwargs):
    """Inverse of :func:`fft` (complex output, shifted input), on
    ``device``."""
    dim = get_dim(x, dim)
    new_dim, new_dim_attrs = _new_dim_checks(x, dim, new_dim, "time",
                                             new_dim_attrs)
    dtype = np.dtype(dtype or ("complex64" if x.dtype.itemsize <= 8
                               and x.dtype.kind == "c"
                               else "complex64" if x.dtype.itemsize <= 4
                               else "complex128"))

    coord = np.asarray(x.coords[dim].values, dtype=np.float64)
    n = coord.size
    df = np.round(np.fabs(coord[1] - coord[0]), decimals=10)
    time = np.arange(n) / (n * df)
    if _recip_zero in x.coords[dim].attrs:
        time = time + x.coords[dim].attrs[_recip_zero]

    data, dims = core_dim_last(x, dim, device)
    F = torch.fft.ifft(torch.fft.ifftshift(data.to(_torch_dtype(dtype)),
                                           dim=-1), dim=-1)
    out = _attach_new_coord(
        to_numpy(F).astype(dtype), x, dims, dim, new_dim, time,
        {"long_name": "Time", "standard_name": "time", "units": "s"},
        new_dim_attrs)
    historicize(out, f="ifft", a={"x": x.name, "dim": dim,
                                  "new_dim": new_dim})
    return out


def rfft(x, dim: str = None, new_dim: str = None, new_dim_attrs: dict = None,
         dtype=None, device="cuda", **kwargs):
    """Real FFT along ``dim`` on ``device``; even sample counts enforced by
    trimming one sample for odd dims (reference behavior,
    ``xcorr/signal/fft.py:356-359``)."""
    dim = get_dim(x, dim)
    new_dim, new_dim_attrs = _new_dim_checks(x, dim, new_dim, "freq",
                                             new_dim_attrs)
    dtype = np.dtype(dtype or ("float32" if x.dtype.itemsize <= 4
                               else "float64"))
    if "float" not in dtype.name:
        raise TypeError("dtype should be float.")
    cdtype = np.complex64 if dtype == np.float32 else np.complex128

    coord = np.asarray(x.coords[dim].values, dtype=np.float64)
    n = coord.size - 1 if coord.size & 0x1 else coord.size
    fN = np.round(n // 2 / (coord[n - 1] - coord[0]), decimals=0)
    f = np.linspace(0.0, fN, n // 2 + 1)

    data, dims = core_dim_last(x, dim, device)
    F = torch.fft.rfft(data.to(_torch_dtype(dtype)), n=n, dim=-1)
    out = _attach_new_coord(
        to_numpy(F).astype(cdtype), x, dims, dim, new_dim, f,
        {"long_name": "Frequency", "standard_name": "frequency",
         "units": "s-1"}, new_dim_attrs)
    historicize(out, f="rfft", a={"x": x.name, "dim": dim,
                                  "new_dim": new_dim})
    return out


def irfft(x, dim: str = None, new_dim: str = None,
          new_dim_attrs: dict = None, dtype=None, device="cuda", **kwargs):
    """Inverse real FFT along ``dim`` with a labelled time coordinate, on
    ``device``."""
    dim = get_dim(x, dim)
    new_dim, new_dim_attrs = _new_dim_checks(x, dim, new_dim, "time",
                                             new_dim_attrs)
    dtype = np.dtype(dtype or ("float32" if x.dtype.itemsize <= 8
                               else "float64"))
    if "float" not in dtype.name:
        raise TypeError("dtype should be float.")
    cdtype = np.complex64 if dtype == np.float32 else np.complex128

    coord = np.asarray(x.coords[dim].values, dtype=np.float64)
    n = 2 * coord.size - 2
    fN = coord[-1]
    time = np.linspace(0.0, (n - 1) / 2 / fN, n)
    if _recip_zero in x.coords[dim].attrs:
        time = time + x.coords[dim].attrs[_recip_zero]

    data, dims = core_dim_last(x, dim, device)
    y = torch.fft.irfft(data.to(_torch_dtype(cdtype)), dim=-1)
    out = _attach_new_coord(
        to_numpy(y).astype(dtype), x, dims, dim, new_dim, time,
        {"long_name": "Time", "standard_name": "time", "units": "s"},
        new_dim_attrs)
    historicize(out, f="irfft", a={"x": x.name, "dim": dim,
                                   "new_dim": new_dim})
    return out
