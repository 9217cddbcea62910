r"""
:mod:`core.postprocess` -- Canonical CCF cleanup
================================================

The signature postprocess chain (spec: ``xcorr/core/postprocess.py:21-150``;
port of ``xcorr_tpu/core/postprocess.py``): select valid-status times,
clip the lag window to a celerity band ``distance/cmax .. distance/cmin``,
then ``unbias -> demean -> taper(5s) -> timeshift(-(pair_offset+time_offset))
-> filter(highpass) -> taper(1.5s)``. ``demean``, ``timeshift`` and
``filter`` run on the torch ``device``; the rest on the host, as in the
JAX package.

The selection of the valid times and the lag window has a port form,
:func:`select`, beside the carried one, :func:`_select_plain`. The
carried form runs ``Dataset.where(m, drop=True)`` over every variable
of the condition's dims, ``cc`` whole (an ``np.where`` over all of it,
then one copy per selected dimension), and then ``cc.where(mlag,
drop=True)``, which copies the kept times whole once more before it
cuts the lags. :func:`select` works out the kept pairs, times and lags
first and copies ``cc``'s kept block once, the lags cut first (a view
where they are contiguous); it writes NaN only into the block, where the
condition is false inside it, and promotes the dtype as ``np.where``
does. The two give equal datasets, bit for bit. ``unbias``'s weights
have a port form too (:func:`..signal._unbias.span_weights`).
:data:`FORMS` names the forms, so that a caller can put the plain ones
in their place.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd

from ..ndlabel import DataArray
from .process import resolve_device

__all__ = ["postprocess", "select", "FORMS"]


def postprocess(ds, lag_lim: tuple = None, time_lim: tuple = None,
                clim: tuple = None, cmin: float = None, cmax: float = None,
                time_min=None, time_max=None, lag_min: float = None,
                lag_max: float = None, filter_kwargs: dict = None,
                device="cuda"):
    """Postprocess a CCF dataset; returns a new dataset with ``cc``
    replaced by the cleaned, lag-windowed estimate. ``device`` defaults to
    ``'cuda'`` and raises up front when torch sees no card."""
    device = resolve_device(device)
    if "postprocess" in ds["cc"].attrs:
        warnings.warn(
            f"Dataset already postprocessed on {ds['cc'].attrs['postprocess']}")
        return ds

    if lag_lim is not None:
        lag_min, lag_max = lag_lim
    if time_lim is not None:
        time_min, time_max = time_lim
    if clim is not None:
        cmin, cmax = clim

    # km->m conversion keys on WHICHEVER celerity bounds were given, as in
    # the JAX package (single-bound clips are supported)
    d = ds["distance"]
    cvals = [c for c in (cmin, cmax) if c is not None]
    d_fact = 1000 if (d.attrs.get("units") == "km" and cvals
                      and all(c > 10 for c in cvals)) else 1

    tvals = ds.coords["time"].values
    time_min = time_min if time_min is not None else tvals.min()
    time_max = time_max if time_max is not None else tvals.max()
    time_min = np.datetime64(pd.Timestamp(time_min))
    time_max = np.datetime64(pd.Timestamp(time_max))

    # valid times only
    m = ((ds["status"] == 1) &
         (ds.coords["time"] >= time_min) & (ds.coords["time"] <= time_max))
    if not m.values.any():
        raise ValueError("No data after extracting valid times")
    dist = ds["distance"]

    lagv = ds.coords["lag"].values
    lag_min = lag_min if lag_min is not None else float(lagv.min())
    lag_max = lag_max if lag_max is not None else float(lagv.max())
    if cmax:
        lag_min = max(lag_min, float(dist.values.min()) * d_fact / cmax)
    if cmin:
        lag_max = min(lag_max, float(dist.values.max()) * d_fact / cmin)

    ds, cc = select(ds.drop_vars("distance"), m, lag_min, lag_max)
    ds["distance"] = dist  # avoids broadcasting distance over time

    filter_kwargs = {
        "frequency": 3.0, "btype": "highpass", "order": 2,
        **(filter_kwargs or {}),
    }

    delay = -(ds["pair_offset"] + ds["time_offset"])

    cc = (
        cc
        .signal.unbias()
        .signal.demean(device=device)
        .signal.taper(max_length=5.0)  # timeshift phase wrapping
        .signal.timeshift(delay=delay, dim="lag", fast=True, device=device)
        .signal.filter(**filter_kwargs, device=device)
        .signal.taper(max_length=3 / 2)  # filter artefacts
    )
    cc.attrs["postprocess"] = f"{pd.to_datetime('now')}"
    cc.coords["lag"].attrs["cmin"] = cmin
    cc.coords["lag"].attrs["cmax"] = cmax

    ds = ds.drop_vars(("cc", "lag", "status"))
    ds["cc"] = cc
    return ds


def select(ds, m, lag_min, lag_max):
    """``ds`` at the pairs and times where the condition ``m`` holds, and
    its ``cc`` there and at the lags in ``[lag_min, lag_max]``: ``(the
    dataset but cc, cc)``, equal to :func:`_select_plain`'s. The variables
    but ``cc`` (a few values per window) take the carried
    ``Dataset.where``, memory layout included: ``timeshift`` reads the
    offsets as laid out, and on the CPU its cos and sin round differently
    over strided delays. ``cc``'s kept block is copied once; the chain
    moves it to the device C-contiguous."""
    out = ds.drop_vars("cc").where(m, drop=True)
    mlag = (out.coords["lag"] >= lag_min) & (out.coords["lag"] <= lag_max)
    lags = np.nonzero(mlag.values)[0]
    if not lags.size:
        raise ValueError("No data after extracting time lag")
    v = ds._vars["cc"]
    cc = _block(v, m, lags)

    # cc's coordinates as ``out["cc"].where(mlag, drop=True)`` carries them
    def on_cc(c):
        return all(d in v.dims for d in c.dims)

    coords = {**mlag._coords, **{k: c for k, c in out._coords.items()
                                 if k != "cc" and on_cc(c)}}
    cc._coords = {k: c.isel({"lag": lags}) if "lag" in c.dims else c
                  for k, c in coords.items() if on_cc(c)}
    return out, cc


def _select_plain(ds, m, lag_min, lag_max):
    """The carried selection (the plain version of :func:`select`):
    ``Dataset.where`` over whole variables, then ``cc.where`` over the
    lag window."""
    ds = ds.where(m, drop=True)
    mlag = (ds.coords["lag"] >= lag_min) & (ds.coords["lag"] <= lag_max)
    if not mlag.values.any():
        raise ValueError("No data after extracting time lag")
    return ds.drop_vars("cc"), ds["cc"].where(mlag, drop=True)


def _block(v, m, lags):
    """``v`` (``cc``) at the pairs and times that ``Dataset.where(m,
    drop=True)`` keeps and at the positions ``lags``, copied once (the
    lags first, a view where they are contiguous), NaN where ``m`` is
    false inside the block, in the dtype ``np.where(m, v, np.nan)``
    gives; no coordinates yet."""
    keep = {}
    for d in m.dims:
        axes = tuple(i for i, dd in enumerate(m.dims) if dd != d)
        keep[d] = np.nonzero(np.any(m.data, axis=axes) if axes
                             else m.data)[0]
    cut = {d: _cut(i) for d, i in {**keep, "lag": lags}.items()}
    view = v.data[tuple(cut[d] if isinstance(cut.get(d), slice)
                        else slice(None) for d in v.dims)]
    if all(not isinstance(cut.get(d), np.ndarray) for d in v.dims):
        block = view.copy()
    else:  # one gather over every axis
        block = view[np.ix_(*(
            cut[d] if isinstance(cut.get(d), np.ndarray) else np.arange(n)
            for d, n in zip(v.dims, view.shape)))]
    # the condition over the block, in v's axis order, length 1 elsewhere
    cond = m.data[np.ix_(*(keep[d] for d in m.dims))]
    order = [d for d in v.dims if d in m.dims]
    cond = cond.transpose([m.dims.index(d) for d in order]).reshape(
        [cond.shape[m.dims.index(d)] if d in m.dims else 1 for d in v.dims])
    dtype = np.where(True, block.reshape(-1)[:0], np.nan).dtype
    if dtype != block.dtype or not cond.all():
        block = np.where(cond, block, np.nan)
    return DataArray(block, dims=v.dims, name=v.name, attrs=dict(v.attrs))


def _cut(idx):
    """Sorted positions as a slice where they are contiguous."""
    if idx[-1] - idx[0] + 1 == idx.size:
        return slice(int(idx[0]), int(idx[-1]) + 1)
    return idx


#: the forms a caller can swap for their plain versions (``_<name>_plain``)
FORMS = ("select",)
