r"""
:mod:`signal._helpers` -- Shared wrapper plumbing
=================================================

The one idiom every signal op follows (reference: apply_ufunc pattern,
SURVEY.md §2.4; port of ``xcorr_tpu/signal/_helpers.py``): validate the
core dim, move it last, copy the data to the torch device, run the op,
copy the result back and restore labels.
"""

from __future__ import annotations

import numpy as np

from ..ndlabel import DataArray
from ..util.convert import to_device, to_numpy

__all__ = ["get_dim", "check_regular", "core_dim_last", "wrap_like"]


def get_dim(x: DataArray, dim: str = None):
    """Validate and default the core dimension (last dim)."""
    dim = dim or x.dims[-1]
    if not isinstance(dim, str):
        raise TypeError("dim should be a string")
    if dim not in x.dims:
        raise ValueError(f'x has no dimensions "{dim}"')
    return dim


def check_regular(x: DataArray, dim: str):
    """Require an equidistant coordinate (reference checks the same)."""
    coord = x.coords[dim].values
    if np.issubdtype(coord.dtype, np.datetime64):
        coord = coord.astype("datetime64[ns]").astype(np.int64) / 1e9
    d = np.diff(np.asarray(coord, dtype=np.float64))
    if d.size and not np.allclose(d, d[0], rtol=1e-6, atol=1e-10):
        raise ValueError(f'coordinate "{dim}" should be regularly spaced')


def core_dim_last(x: DataArray, dim: str, device):
    """Return (tensor on ``device`` with ``dim`` moved last, the dim order
    used). ``device`` goes through ``core.process.resolve_device``: a
    CUDA device raises when torch sees none."""
    from ..core.process import resolve_device
    device = resolve_device(device)
    order = tuple(d for d in x.dims if d != dim) + (dim,)
    return to_device(x.transpose(*order).data, device), order


def wrap_like(data, x: DataArray, order, name=None, attrs=None):
    """Rebuild a DataArray in ``order`` dims, then restore ``x``'s dim
    order; carries ``x``'s coords. ``data`` may be a tensor on any
    device."""
    out = DataArray(to_numpy(data), dims=order, name=name or x.name,
                    attrs=dict(attrs if attrs is not None else x.attrs))
    out._coords = {k: c for k, c in x.coords.items()
                   if all(d in order for d in c.dims)}
    if order != x.dims and set(order) == set(x.dims):
        out = out.transpose(*x.dims)
    return out
