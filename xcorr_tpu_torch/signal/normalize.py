# Carried from xcorr_tpu/signal/normalize.py (see test_torch_host_copies).
r"""
:mod:`signal.normalize` -- Vector/matrix norm scaling
=====================================================

Normalize by the vector norm along one dim (norm1d) or the matrix norm
over two dims (norm2d) (spec: ``xcorr/signal/normalize.py:33-155``).
"""

from __future__ import annotations

import numpy as np

from ..util.history import historicize
from ._helpers import get_dim

__all__ = ["norm1d", "norm2d"]


def norm1d(x, dim: str = None, **kwargs):
    """x / ||x||_2 along ``dim``."""
    dim = get_dim(x, dim)
    axis = x.dims.index(dim)
    norm = np.linalg.norm(np.nan_to_num(x.data), axis=axis, keepdims=True)
    y = x.copy(deep=False,
               data=x.data / np.where(norm == 0, 1.0, norm))
    historicize(y, f="norm1d", a={"x": x.name, "dim": dim})
    return y


def norm2d(x, dims: tuple = None, **kwargs):
    """x / ||x||_F over the trailing two dims (or ``dims``)."""
    dims = tuple(dims) if dims else x.dims[-2:]
    axes = tuple(x.dims.index(d) for d in dims)
    norm = np.linalg.norm(np.nan_to_num(x.data), axis=axes, keepdims=True)
    y = x.copy(deep=False,
               data=x.data / np.where(norm == 0, 1.0, norm))
    historicize(y, f="norm2d", a={"x": x.name, "dim": list(dims)})
    return y
