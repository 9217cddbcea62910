# Carried from xcorr_tpu/io/filesystem.py (see test_torch_host_copies).
r"""
:mod:`io.filesystem` -- Canonical shard paths
=============================================

One netCDF file per (pair, day) in an SDS-like tree
``root/year/pair/pair.yyyy.doy.nc``
(reference: ``xcorr/io/filesystem.py:28-97``).
"""

from __future__ import annotations

import os

from ..util.receiver import check_receiver, split_pair
from ..util.time import to_datetime

__all__ = ["ncfile"]


def ncfile(pair, time, root: str = None, verify_receiver: bool = True):
    """Canonical output path ``root/year/pair/pair.yyyy.doy.nc``."""
    if hasattr(pair, "values"):
        pair = str(pair.values.astype("<U")) if hasattr(
            pair.values, "astype") else str(pair.values)
    if not isinstance(pair, str):
        pair = str(pair)
    if verify_receiver:
        for receiver in split_pair(pair):
            check_receiver(receiver, allow_wildcards=False, raise_error=True)
    time = to_datetime(time)
    fname = "{p}.{y:04d}.{d:03d}.nc".format(p=pair, y=time.year,
                                            d=time.dayofyear)
    if root is None:
        return fname
    return os.path.join(root, f"{time.year:04d}", pair, fname)
