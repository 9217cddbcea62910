r"""
:mod:`signal.filter` -- Zero-phase Butterworth filter
=====================================================

Labelled wrapper over the chunked closed-form SOS filter of
:mod:`xcorr_tpu_torch.ops.filter`, on a torch device (spec:
``xcorr/signal/filter.py:27-120`` = butter + sosfiltfilt; port of
``xcorr_tpu/signal/filter.py``). A row no longer than the filter's edge
padding raises ``ValueError``, as in the JAX package and scipy.
"""

from __future__ import annotations

from .. import ops
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import core_dim_last, get_dim, wrap_like

__all__ = ["filter"]


def filter(x, frequency, btype: str = "highpass", order: int = 2,
           dim: str = None, device="cuda"):
    """Zero-phase Butterworth filter along ``dim`` on ``device``
    (``'cuda'`` by default, which raises without a card).

    ``frequency``: corner (or (min, max) pair) in Hz; the sampling rate is
    read from the dim coordinate's ``sampling_rate`` attr.
    """
    dim = get_dim(x, dim)
    if "sampling_rate" not in x.coords[dim].attrs:
        raise ValueError(f'Dimension "{dim}" has no attribute '
                         '"sampling_rate"!')
    if not (isinstance(frequency, float) or
            (isinstance(frequency, (tuple, list)) and len(frequency) == 2)):
        raise ValueError("Corner frequency should be a `float` or "
                         "tuple-pair with (min, max)!")
    btype = btype or "highpass"
    fs = x.coords[dim].attrs["sampling_rate"]
    sos = ops.filter.butter_sos(order, frequency, btype, fs)

    data, dims = core_dim_last(x, dim, device)
    out = ops.filter.sosfiltfilt(sos, data)
    y = wrap_like(to_numpy(out).astype(x.dtype), x, dims)
    historicize(y, f="filter", a={
        "x": y.name, "frequency": frequency, "btype": btype,
        "order": order, "dim": dim,
    })
    return y
