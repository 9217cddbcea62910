r"""
:mod:`signal.peak_local_max` -- 2-D local peak detection
========================================================

Local maxima over the trailing two dims via max-filter comparison
(spec: ``xcorr/signal/peak_local_max.py:95-188`` =
skimage.feature.peak_local_max; port of
``xcorr_tpu/signal/peak_local_max.py``) on a torch device.

The JAX package's ``reduce_window`` max filter over a
``(2·min_distance+1)²`` window with ``-inf`` "SAME" padding is taken here
as two ``max_pool2d`` passes, a row window then a column window, each
padded with ``-inf``: the maximum of a square window is the maximum of its
column maxima, so the mask is the same bit for bit, at ``2·(2·md+1)``
comparisons per element instead of ``(2·md+1)²``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from ..ndlabel import DataArray, Dataset
from ..util.convert import to_device, to_numpy
from ..util.history import historicize

__all__ = ["peak_local_max"]


def _max_filter_2d(data, md: int):
    """Sliding-window maximum over the trailing two dims of a float
    tensor, window ``2·md+1`` square, ``-inf`` outside."""
    shape = data.shape
    size = 2 * md + 1
    x = data.reshape((-1, 1) + tuple(shape[-2:]))
    x = torch.nn.functional.max_pool2d(x, (1, size), stride=1,
                                       padding=(0, md))
    x = torch.nn.functional.max_pool2d(x, (size, 1), stride=1,
                                       padding=(md, 0))
    return x.reshape(shape)


def peak_local_max(x, min_distance: int = 1, threshold_abs: float = None,
                   threshold_rel: float = None, exclude_border: bool = True,
                   dims: tuple = None, extend: bool = False,
                   as_dataframe: bool = False, device="cuda", **kwargs):
    """Boolean peak mask (or extended outputs) over the trailing two dims,
    on ``device`` (``'cuda'`` by default, which raises without a card).

    Peaks are points equal to the maximum within a
    ``(2·min_distance+1)²`` neighborhood, above the thresholds.
    """
    from ..core.process import resolve_device
    device = resolve_device(device)
    dims = tuple(dims) if dims else x.dims[-2:]
    order = tuple(d for d in x.dims if d not in dims) + dims
    data = to_device(np.nan_to_num(
        np.asarray(x.transpose(*order).data, dtype=np.float64),
        nan=-np.inf), device)

    mx = _max_filter_2d(data, int(min_distance))
    peaks = (data == mx) & torch.isfinite(data)
    if threshold_abs is not None:
        peaks &= data > threshold_abs
    if threshold_rel is not None:
        peaks &= data > threshold_rel * torch.amax(data, dim=(-2, -1),
                                                   keepdim=True)
    if exclude_border:
        b = int(min_distance)
        mask = np.zeros(data.shape[-2:], dtype=bool)
        if b > 0:
            mask[b:-b, b:-b] = True
        else:
            mask[:, :] = True
        peaks &= to_device(mask, device)
    peaks = to_numpy(peaks)

    out = DataArray(peaks, dims=order, name=f"plm_{x.name}",
                    attrs={"long_name": "Local peak mask", "units": "-",
                           "min_distance": min_distance})
    out._coords = {k: c for k, c in x.coords.items()
                   if all(d in order for d in c.dims)}
    historicize(out, f="peak_local_max", a={
        "x": x.name, "min_distance": min_distance, "dim": list(dims)})

    if not (extend or as_dataframe):
        if order != x.dims:
            out = out.transpose(*x.dims)
        return out

    vals = x.transpose(*order).copy(deep=False)
    vals.data = np.where(peaks, vals.data, np.nan)
    if extend and not as_dataframe:
        ds = Dataset()
        ds[out.name] = out
        ds[f"{x.name}_peaks"] = vals
        return ds

    # long-form DataFrame of peak coordinates + values, ranked by value
    idx = np.argwhere(peaks)
    rows = {}
    for axis, d in enumerate(order):
        coord = x.coords.get(d)
        cvals = (np.asarray(coord.values) if coord is not None
                 else np.arange(x.sizes[d]))
        rows[d] = cvals[idx[:, axis]]
    rows["value"] = np.asarray(x.transpose(*order).data)[tuple(idx.T)]
    df = pd.DataFrame(rows).sort_values("value", ascending=False)
    return df.reset_index(drop=True)
