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
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd

from .process import resolve_device

__all__ = ["postprocess"]


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
    ds = ds.drop_vars("distance").where(m, drop=True)
    ds["distance"] = dist  # avoids broadcasting distance over time

    filter_kwargs = {
        "frequency": 3.0, "btype": "highpass", "order": 2,
        **(filter_kwargs or {}),
    }

    delay = -(ds["pair_offset"] + ds["time_offset"])

    lagv = ds.coords["lag"].values
    lag_min = lag_min if lag_min is not None else float(lagv.min())
    lag_max = lag_max if lag_max is not None else float(lagv.max())
    if cmax:
        lag_min = max(lag_min, float(dist.values.min()) * d_fact / cmax)
    if cmin:
        lag_max = min(lag_max, float(dist.values.max()) * d_fact / cmin)

    mlag = (ds.coords["lag"] >= lag_min) & (ds.coords["lag"] <= lag_max)
    if not mlag.values.any():
        raise ValueError("No data after extracting time lag")

    cc = (
        ds["cc"].where(mlag, drop=True)
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
