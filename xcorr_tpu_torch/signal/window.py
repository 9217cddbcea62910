# Carried from xcorr_tpu/signal/window.py (see test_torch_host_copies).
r"""
:mod:`signal.window` -- Coordinate-based window vectors
=======================================================

Build a taper window DataArray over a coordinate
(spec: ``xcorr/signal/window.py:27-116``).
"""

from __future__ import annotations

import numpy as np

from .. import ops
from ..ndlabel import DataArray

__all__ = ["window"]


def window(coord, wtype: str = "hann", max_percentage: float = None,
           max_length: float = None, side: str = "both"):
    """Taper window over a 1-D coordinate DataArray."""
    if len(coord.dims) != 1:
        raise ValueError("coord must be one-dimensional")
    n = coord.size
    delta = None
    vals = np.asarray(coord.values)
    if "delta" in coord.attrs:
        delta = float(coord.attrs["delta"])
    elif n > 1:
        if np.issubdtype(vals.dtype, np.datetime64):
            delta = float(np.diff(vals[:2]).astype("timedelta64[ns]")
                          .astype(np.int64) / 1e9)
        else:
            delta = float(vals[1] - vals[0])
    sampling_rate = 1.0 / delta if delta else 1.0
    w = ops.taper.taper_vector(
        n, wtype=wtype or "hann", max_percentage=max_percentage,
        max_length=max_length, sampling_rate=sampling_rate,
        side=side or "both", dtype=np.float64)
    out = DataArray(w, dims=coord.dims, name="win",
                    attrs={"long_name": "Taper window", "units": "-",
                           "wtype": wtype or "hann"})
    out._coords = {coord.name: coord}
    return out
