# Carried from xcorr_tpu/core/merge.py (see test_torch_host_copies).
r"""
:mod:`core.merge` -- Merge CCF datasets
=======================================

Merge many per-day datasets by coordinates
(spec: ``xcorr/core/merge.py:21-89``).
"""

from __future__ import annotations

import pandas as pd

from ..ndlabel import combine_by_coords

__all__ = ["merge"]


def merge(datasets: list, extract: bool = False, verb: int = 0, **kwargs):
    """Combine validated datasets along their shared coords; optionally
    mask cc where status != 1."""
    from ..io.validate import validate_list

    datasets = validate_list(datasets, verb=verb, **kwargs)
    ds = combine_by_coords(datasets)

    ds.attrs["title"] = "{} - {} to {}".format(
        ds.attrs.get("title", "").split(" - ")[0],
        pd.Timestamp(ds.coords["time"].values[0]).strftime("%Y.%j"),
        pd.Timestamp(ds.coords["time"].values[-1]).strftime("%Y.%j"),
    ).strip()
    ds.attrs["history"] = (ds.attrs.get("history", "")
                           + f", Merged @ {pd.to_datetime('now')}")
    if extract:
        ds["cc"] = ds["cc"].where(ds["status"] == 1)
    return ds
