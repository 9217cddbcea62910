# Carried from xcorr_tpu/util/time.py (see test_torch_host_copies).
r"""
:mod:`util.time` -- Time utilities
==================================

Datetime conversions, day-range generation, calendar helpers, and the lag
clip-index bookkeeping (reference: ``xcorr/util/time.py``).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

__all__ = ["_one_second", "to_seconds", "to_datetime", "to_UTCDateTime",
           "get_dates", "leap_year", "get_dpm", "get_dpy",
           "update_lag_indices", "_dpm"]

_one_second = pd.to_timedelta("1s")


def to_seconds(time):
    """Convert timedelta64[ns] values to float seconds; pass through
    anything else (``xcorr/util/time.py:27-47``)."""
    if not hasattr(time, "dtype"):
        return time
    if time.dtype != np.dtype("timedelta64[ns]"):
        return time
    return time / _one_second


def to_datetime(time):
    """Lenient conversion to :class:`pandas.Timestamp`
    (``xcorr/util/time.py:50-73``)."""
    if time is None:
        return None
    if hasattr(time, "values") and hasattr(time, "dims"):  # DataArray
        time = time.values
    elif hasattr(time, "datetime"):  # UTCDateTime-like
        time = time.datetime
    return pd.to_datetime(time)


def to_UTCDateTime(time):
    """Convert to the framework's UTCDateTime
    (``xcorr/util/time.py:76-91`` analog; obspy's class replaced by
    :class:`xcorr_tpu.stream.UTCDateTime`)."""
    from ..stream.trace import UTCDateTime
    return UTCDateTime(to_datetime(time))


def update_lag_indices(lag):
    """Recompute ``index_min``/``index_max`` attrs from the lag coordinate
    values (``xcorr/util/time.py:94-108``). These indices address the full
    un-clipped 2·npts-1 lag vector."""
    for attr in ["sampling_rate", "delta", "npts", "index_min", "index_max"]:
        if attr not in lag.attrs:
            raise KeyError(f'Lag has no attribute "{attr}"!')
    if lag.attrs["units"] != "s":
        raise ValueError("Lag time unit should be seconds.")
    lag_max = (lag.attrs["npts"] - 1) * lag.attrs["delta"]
    srate = lag.attrs["sampling_rate"]
    lag.attrs["index_min"] = int(round((lag.values[0] + lag_max) * srate))
    lag.attrs["index_max"] = int(round((lag.values[-1] + lag_max) * srate + 1))


def get_dates(start, end):
    """List of calendar days touched by [start, end]
    (``xcorr/util/time.py:111-155``)."""
    start, end = to_datetime(start), to_datetime(end)
    if start.normalize() == end.normalize():
        days = pd.date_range(start.normalize(), end.normalize(), freq="1D")
    else:
        days = pd.date_range(
            start.normalize(),
            end.normalize() + (pd.Timedelta("1D")
                               if end != end.normalize() else pd.Timedelta(0)),
            freq="1D",
        )
        days = days[days <= end]
    return days


_dpm = {
    "noleap": [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "365_day": [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "standard": [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "gregorian": [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "proleptic_gregorian": [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "all_leap": [0, 31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "366_day": [0, 31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "360_day": [0, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30],
}


def leap_year(year: int, cal: str = "standard"):
    """Whether ``year`` is a leap year in the given calendar
    (``xcorr/util/time.py:158-190``)."""
    leap = False
    if cal in ("standard", "gregorian", "proleptic_gregorian", "julian") \
            and year % 4 == 0:
        leap = True
        if (cal == "proleptic_gregorian" and year % 100 == 0
                and year % 400 != 0):
            leap = False
        elif (cal in ("standard", "gregorian") and year % 100 == 0
              and year % 400 != 0 and year < 1583):
            leap = False
    return leap


def get_dpm(time, cal: str = "standard"):
    """Days per month for each timestamp in ``time``."""
    idx = pd.DatetimeIndex(np.asarray(time))
    out = np.array([_dpm[cal][m] for m in idx.month], dtype=int)
    leap = np.array([leap_year(y, cal) and m == 2
                     for y, m in zip(idx.year, idx.month)])
    return out + leap.astype(int)


def get_dpy(time, cal: str = "standard"):
    """Days per year for each timestamp in ``time``."""
    idx = pd.DatetimeIndex(np.asarray(time))
    return np.array(
        [366 if leap_year(y, cal) else 365 for y in idx.year], dtype=int)
