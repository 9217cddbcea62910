# Carried from xcorr_tpu/stream/duration.py (see test_torch_host_copies).
r"""
:mod:`stream.duration` -- Stream duration accounting
====================================================

Per-SEED-id total duration/npts/gap accounting including overlap
compensation (reference: ``xcorr/stream/duration.py:17-73``).
"""

from __future__ import annotations

import pandas as pd

__all__ = ["duration"]


def duration(stream, receiver: str = None, sampling_rate: float = None):
    """DataFrame with per-SEED-id time/npts/gaps totals, optionally
    filtered to one receiver and/or one sampling rate (reference
    ``xcorr/stream/duration.py:17-18``)."""
    rows = {}
    for tr in stream:
        if receiver and tr.id != receiver:
            continue
        if sampling_rate is not None and \
                tr.stats.sampling_rate != sampling_rate:
            continue
        row = rows.setdefault(tr.id, {
            "id": tr.id, "npts": 0, "time": 0.0, "segments": 0,
            "starttime": tr.stats.starttime, "endtime": tr.stats.endtime,
            "sampling_rate": tr.stats.sampling_rate})
        row["npts"] += tr.stats.npts
        row["time"] += tr.stats.npts / tr.stats.sampling_rate
        row["segments"] += 1
        if tr.stats.starttime < row["starttime"]:
            row["starttime"] = tr.stats.starttime
        if tr.stats.endtime > row["endtime"]:
            row["endtime"] = tr.stats.endtime
    out = []
    for row in rows.values():
        span = row["endtime"] - row["starttime"] + \
            1.0 / row["sampling_rate"]
        row["gaps"] = max(0.0, span - row["time"])
        row["overlaps"] = max(0.0, row["time"] - span)
        out.append(row)
    return pd.DataFrame(out)
