# Carried from xcorr_tpu/signal/taper.py (see test_torch_host_copies).
r"""
:mod:`signal.taper` -- Taper
============================

Apply a window taper along a dimension
(spec: ``xcorr/signal/taper.py:23-85``).
"""

from __future__ import annotations

from ..util.history import historicize
from ._helpers import get_dim
from .window import window

__all__ = ["taper"]


def taper(x, wtype: str = None, max_percentage: float = None,
          max_length: float = None, side: str = None, dim: str = None):
    """Taper ``x`` along ``dim`` (default: last)."""
    dim = get_dim(x, dim)
    wtype = wtype or "hann"
    side = side or "both"
    w = window(x.coords[dim], wtype, max_percentage, max_length, side)
    y = x * w.astype(x.dtype)
    y.name = x.name
    y.attrs = dict(x.attrs)
    historicize(y, f="taper", a={
        "x": x.name, "wtype": wtype, "max_percentage": max_percentage,
        "max_length": max_length, "side": side, "dim": dim,
    })
    return y
