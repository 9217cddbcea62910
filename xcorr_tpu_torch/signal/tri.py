# Carried from xcorr_tpu/signal/tri.py (see test_torch_host_copies).
r"""
:mod:`signal.tri` -- Triangular masks and mirroring
===================================================

Upper/lower-triangle masks over a (time1, time2) plane and diagonal
mirror-filling (spec: ``xcorr/signal/tri.py:19-115``; used by the
timelapse pipeline's symmetry, ``xcorr/scripts/timelapse.py:348-362``).
"""

from __future__ import annotations

import numpy as np

from ..ndlabel import DataArray

__all__ = ["tri_mask", "tri_mirror"]


def tri_mask(coord1, coord2, k: int = 0, upper: bool = True):
    """Boolean mask DataArray over (coord1, coord2): the (upper or lower)
    triangle offset by diagonal ``k``."""
    n1, n2 = coord1.size, coord2.size
    fn = np.triu if upper else np.tril
    m = fn(np.ones((n1, n2), dtype=bool), k=k)
    out = DataArray(m, dims=(coord1.name, coord2.name), name="tri_mask")
    out._coords = {coord1.name: coord1, coord2.name: coord2}
    return out


def tri_mirror(x, mask=None, dims: tuple = None, upper: bool = True):
    """Fill the opposite triangle of ``x`` by mirroring across the
    diagonal of the trailing (or given) two dims."""
    dims = tuple(dims) if dims else x.dims[-2:]
    a1, a2 = x.dims.index(dims[0]), x.dims.index(dims[1])
    data = np.array(x.data)
    swapped = np.swapaxes(data, a1, a2)
    if mask is not None:
        keep = np.asarray(mask.data, dtype=bool)
    else:
        n1, n2 = data.shape[a1], data.shape[a2]
        fn = np.triu if upper else np.tril
        keep = fn(np.ones((n1, n2), dtype=bool))
    # broadcast mask to full shape at the right axes
    shape = [1] * data.ndim
    shape[a1], shape[a2] = data.shape[a1], data.shape[a2]
    keep = keep.reshape(shape)
    out = np.where(keep, data, swapped)
    y = x.copy(deep=False, data=out)
    return y
