# Carried from xcorr_tpu/signal/trigger.py (see test_torch_host_copies).
r"""
:mod:`signal.trigger` -- Coincidence triggers
=============================================

Network coincidence triggering on precomputed characteristic functions
(e.g. SNR) along the window-time dimension
(spec: ``xcorr/signal/trigger.py:29-299``). The reference detours through
obspy (``to_stream`` + ``obspy.signal.trigger.coincidence_trigger``); here
the on/off threshold crossings and the coincidence sum are computed
directly on the labelled array (obspy is not part of this build).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..util.history import historicize
from ..util.time import to_datetime
from ._helpers import get_dim

__all__ = ["coincidence_trigger", "trigger_periods", "trigger_values",
           "trigger_onset", "plot_trigs"]


def trigger_onset(charfct, thr_on: float, thr_off: float):
    """On/off index pairs where ``charfct`` rises above ``thr_on`` and
    subsequently falls below ``thr_off`` (obspy ``trigger_onset``
    semantics)."""
    cf = np.asarray(charfct, dtype=np.float64)
    cf = np.nan_to_num(cf, nan=-1.0)
    above_on = cf > thr_on
    above_off = cf > thr_off
    pairs = []
    i, n = 0, cf.size
    while i < n:
        if above_on[i]:
            j = i
            while j < n and above_off[j]:
                j += 1
            pairs.append((i, min(j, n - 1)))
            i = j + 1
        else:
            i += 1
    return pairs


def coincidence_trigger(x, thr_on: float = None, thr_off: float = None,
                        thr_coincidence_sum: int = None,
                        similarity_threshold: float = None,
                        extend: int = None, dim: str = None):
    """Coincidence trigger over the non-time elements of ``x``.

    Returns an integer period-index DataArray over ``dim`` (NaN outside
    triggered periods), with ``nperiods`` in the attrs.
    """
    dim = get_dim(x, dim)
    coord = x.coords[dim]
    if "window_length" not in coord.attrs:
        raise ValueError(f"Coordinate {dim} has no expected time attribute "
                         '"window_length".')
    if "window_overlap" not in coord.attrs:
        raise ValueError(f"Coordinate {dim} has no expected time attribute "
                         '"window_overlap".')
    win_step = (coord.attrs["window_length"]
                * (1 - coord.attrs["window_overlap"]))
    min_step = 3 * win_step

    thr_on = thr_on or 10.0
    thr_off = thr_off or thr_on
    if not isinstance(thr_on, float):
        raise TypeError("On threshold should be of type float.")
    if not isinstance(thr_off, float):
        raise TypeError("Off threshold should be of type float.")
    # similarity gating is opt-in (None disables), mirroring the
    # reference/obspy where the check only runs when templates are
    # supplied (xcorr/signal/trigger.py:146-150). Simplification vs
    # obspy (documented divergence): the elements' characteristic
    # functions share one window-time grid here, so similarity is the
    # zero-lag normalized correlation of the demeaned per-element cf
    # segments over the candidate event, and an event survives when the
    # BEST pair reaches the threshold.
    similarity_gate = similarity_threshold is not None
    if similarity_gate and (
            not isinstance(similarity_threshold, float)
            or not 0 <= similarity_threshold <= 1):
        raise TypeError("Similarity threshold should be of type float "
                        "within (0.0-1.0).")
    extend = extend or 0
    if not isinstance(extend, int) or extend < 0:
        raise TypeError("extend should be a postive integer.")

    # element-wise characteristic functions: flatten non-dim axes
    order = tuple(d for d in x.dims if d != dim) + (dim,)
    data = x.transpose(*order).data
    nelem = int(np.prod(data.shape[:-1])) if data.ndim > 1 else 1
    cfs = data.reshape(nelem, data.shape[-1])

    thr_coincidence_sum = thr_coincidence_sum or nelem
    if (not isinstance(thr_coincidence_sum, int)
            or not 1 <= thr_coincidence_sum <= nelem):
        raise TypeError("Threshold coincidence sum should be of type int "
                        "within (1 to number of elements).")

    tvals = np.asarray(coord.values)
    tsec = (tvals.astype("datetime64[ns]").astype(np.int64) / 1e9
            if np.issubdtype(tvals.dtype, np.datetime64)
            else tvals.astype(np.float64))

    # collect single-element on/off times, sorted by onset
    singles = []
    for e in range(nelem):
        for i, j in trigger_onset(cfs[e], thr_on, thr_off):
            singles.append((tsec[i], tsec[j], e))
    singles.sort()

    # merge into events and apply the coincidence sum
    events = []  # (on, off, {elements})
    for on, off, e in singles:
        if events and on <= events[-1][1]:
            prev = events[-1]
            events[-1] = (prev[0], max(prev[1], off), prev[2] | {e})
        else:
            events.append((on, off, {e}))
    def max_pairwise_similarity(on, off, elems):
        """Best zero-lag normalized correlation among the triggered
        elements' demeaned cf segments over [on, off]."""
        i0 = int(np.searchsorted(tsec, on))
        i1 = int(np.searchsorted(tsec, off, side="right"))
        seg = np.nan_to_num(cfs[sorted(elems), i0:i1], nan=0.0)
        if seg.shape[1] < 2:
            return 1.0
        seg = seg - seg.mean(axis=1, keepdims=True)
        nrm = np.linalg.norm(seg, axis=1)
        u = seg / np.where(nrm == 0, 1.0, nrm)[:, None]
        sim = u @ u.T
        np.fill_diagonal(sim, -np.inf)
        return float(sim.max())

    trigs = [{"time": on, "duration": off - on}
             for on, off, elems in events
             if len(elems) >= thr_coincidence_sum
             and (not similarity_gate or len(elems) < 2
                  or max_pairwise_similarity(on, off, elems)
                  >= similarity_threshold)]

    # period-index array over the time coordinate
    ct_vals = np.full(tvals.shape, -1, dtype=np.int64)
    ct_index = -1
    for trig in trigs:
        if trig["duration"] < min_step:
            continue
        start = trig["time"] - extend * win_step
        end = trig["time"] + trig["duration"] + extend * win_step
        period = (tsec >= start) & (tsec <= end)
        if np.all(ct_vals[period] == -1):
            ct_index += 1
        ct_vals[period] = ct_index

    ct = coord.copy(deep=False, data=ct_vals.astype(np.float64))
    ct.name = f"ct_{x.name}"
    ct.attrs = {
        "long_name": "Coincidence trigger for "
                     f"{x.attrs.get('long_name', x.name)}",
        "standard_name": "coincidence_trigger_"
                         f"{x.attrs.get('standard_name', x.name)}",
        "units": "-",
        "nperiods": ct_index + 1,
    }
    ct._coords = {dim: coord}
    ct.data = np.where(ct_vals > -1, ct_vals.astype(np.float64), np.nan)
    historicize(ct, f="coincidence_trigger", a={
        "x": x.name, "thr_on": thr_on, "thr_off": thr_off,
        "thr_coincidence_sum": thr_coincidence_sum,
        "similarity_threshold": similarity_threshold,
        "extend": extend, "dim": dim})
    return ct


def trigger_periods(trigs):
    """Start/end/days DataFrame per triggered period."""
    dim = trigs.dims[-1]
    tvals = np.asarray(trigs.coords[dim].values)
    vals = np.asarray(trigs.values)
    periods = []
    for index in np.unique(vals[~np.isnan(vals)]):
        sel = vals == index
        start, end = tvals[sel][0], tvals[sel][-1]
        periods.append(pd.DataFrame(
            data={"start": [to_datetime(start)], "end": [to_datetime(end)],
                  "days": [(to_datetime(end) - to_datetime(start))
                           .total_seconds() / 86400.0]},
            index=[int(index)]))
    return pd.concat(periods)


def trigger_values(x, trigs):
    """Triggered values DataFrame for each coordinate of ``x``."""
    dim = trigs.dims[-1]
    vals = np.asarray(trigs.values)
    frames = []
    nper = int(trigs.attrs.get("nperiods",
                               np.nanmax(vals) + 1 if vals.size else 0))
    for i in range(nper):
        sel = np.nonzero(vals == i)[0]
        if sel.size == 0:
            continue
        sub = x.isel({dim: sel})
        df = _to_dataframe(sub, dim)
        df["period"] = i
        frames.append(df)
    return pd.concat(frames).reset_index(drop=True)


def _to_dataframe(da, dim):
    """Flatten a DataArray into a long DataFrame."""
    order = tuple(d for d in da.dims if d != dim) + (dim,)
    data = da.transpose(*order).data
    idx_arrays = [np.asarray(da.coords[d].values) if d in da.coords
                  else np.arange(da.sizes[d]) for d in order]
    mesh = np.meshgrid(*idx_arrays, indexing="ij")
    out = {d: m.reshape(-1) for d, m in zip(order, mesh)}
    out[da.name or "value"] = data.reshape(-1)
    return pd.DataFrame(out)


def plot_trigs(x, trigs, ax=None, ylim=None):
    """Shade the triggered periods of ``trigs`` over the characteristic
    functions ``x`` (reference ``xcorr/signal/trigger.py:269-299``)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    xv = np.asarray(x.values, dtype=np.float64)
    ymin, ymax = ylim or (0.0, float(np.nanmax(xv)) if xv.size else 1.0)
    tv = np.asarray(trigs.values, dtype=np.float64)
    t = np.asarray(trigs.coords["time"].values)
    if not np.isfinite(tv).any():
        return ax
    imin = int(np.nanmin(tv))
    imax = int(np.nanmax(tv))
    for i in range(imin, imax + 1):
        sel = tv == i
        if sel.any():
            ax.fill_between(t, ymin, ymax, where=sel, alpha=0.2,
                            color="black")
    return ax
