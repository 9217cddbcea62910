# Carried from xcorr_tpu/signal/rms.py (see test_torch_host_copies).
r"""
:mod:`signal.rms` -- Root-mean-square
=====================================

Mean-of-squares then sqrt along a dimension
(spec: ``xcorr/signal/rms.py:23-68``).
"""

from __future__ import annotations

import numpy as np

from ..util.history import historicize
from ._helpers import get_dim

__all__ = ["rms"]


def rms(x, dim: str = None, keep_attrs: bool = True):
    """RMS of ``x`` along ``dim`` (NaN-aware)."""
    dim = get_dim(x, dim)
    y = (x.astype(np.float64) ** 2).mean(dim)
    y.data = np.sqrt(y.data)
    y.name = x.name
    if keep_attrs:
        y.attrs = dict(x.attrs)
    if "long_name" in y.attrs:
        y.attrs["long_name"] = "Root-mean-square " + y.attrs["long_name"]
    historicize(y, f="rms", a={"x": x.name, "dim": dim})
    return y
