r"""
:mod:`signal.detrend` -- Detrend / demean
=========================================

NaN-aware constant/linear detrending along a dimension, on a torch device
(spec: ``xcorr/signal/detrend.py:31-145``; port of
``xcorr_tpu/signal/detrend.py``).
"""

from __future__ import annotations

from .. import ops
from ..util.convert import to_numpy
from ..util.history import historicize
from ._helpers import core_dim_last, get_dim, wrap_like

__all__ = ["detrend", "demean"]

_OPS = {"constant": ops.detrend.demean, "demean": ops.detrend.demean,
        "linear": ops.detrend.detrend_linear}


def detrend(x, dim: str = None, type: str = None, device="cuda", **kwargs):
    """Remove the mean ('constant'/'demean') or least-squares line
    ('linear') along ``dim`` on ``device`` (``'cuda'`` by default, which
    raises without a card)."""
    dim = get_dim(x, dim)
    type = type or "constant"
    if type not in _OPS:
        raise ValueError(f"unknown detrend type {type!r}")
    data, dims = core_dim_last(x, dim, device)
    out = _OPS[type](data)
    y = wrap_like(to_numpy(out).astype(x.dtype), x, dims)
    historicize(y, f="detrend", a={"x": x.name, "type": type, "dim": dim})
    return y


def demean(x, **kwargs):
    """Remove the mean along the core dim."""
    return detrend(x, type="demean", **kwargs)
