r"""
:mod:`signal.timeshift` -- Spectral time shift
==============================================

Sub-sample shift via phase ramp on a torch device (spec:
``xcorr/signal/timeshift.py:23-117``; used by postprocess with
per-(pair, time) delays, ``xcorr/core/postprocess.py:117,138``; port of
``xcorr_tpu/signal/timeshift.py``).

Divergence from the reference, as in the JAX package: the circular FFT
length equals the dim length, but odd lengths are preserved (the
reference's rfft/irfft path trims one sample for odd dims; we pass ``n``
explicitly).
"""

from __future__ import annotations

import numpy as np

from .. import ops
from ..ndlabel import DataArray
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import check_regular, core_dim_last, get_dim, wrap_like

__all__ = ["timeshift"]


def timeshift(x, delay, dtype=None, dim: str = None, fast: bool = True,
              device="cuda", **kwargs):
    """Shift ``x`` along ``dim`` by ``delay`` seconds (scalar or a
    DataArray broadcast over the batch dims) on ``device`` (``'cuda'`` by
    default, which raises without a card)."""
    dim = get_dim(x, dim)
    check_regular(x, dim)

    coord = x.coords[dim]
    delta = float(coord.attrs.get("delta", np.median(np.diff(
        np.asarray(coord.values, dtype=np.float64)))))

    dims = tuple(d for d in x.dims if d != dim) + (dim,)
    batch = dims[:-1]
    if isinstance(delay, DataArray):
        if dim in delay.dims:
            raise ValueError(f'delay cannot depend on dim "{dim}"')
        for d in delay.dims:
            if d not in x.dims:
                raise ValueError(f'delay dim "{d}" not existing in x')
        # broadcast delay onto the batch dims in `dims` order (minus dim)
        dvals = delay
        for d in batch:
            if d not in dvals.dims:
                dvals = dvals.expand_dims(d)
        dvals = dvals.transpose(*batch) if batch else dvals
        dvals = np.broadcast_to(dvals.data,
                                tuple(x.sizes[d] for d in batch))
    elif not isinstance(delay, (int, float)):
        raise TypeError("delay should be a float or DataArray")
    else:
        dvals = np.full(tuple(x.sizes[d] for d in batch), float(delay))

    data, dims = core_dim_last(x, dim, device)
    out = ops.timeshift.timeshift(data, np.array(dvals, dtype=np.float64),
                                  delta=delta, nfft=data.shape[-1])
    y = wrap_like(to_numpy(out).astype(dtype or x.dtype), x, dims)
    historicize(y, f="timeshift", a={
        "x": x.name, "delay": "DataArray" if isinstance(delay, DataArray)
        else delay, "dim": dim, "fast": fast,
    })
    return y
