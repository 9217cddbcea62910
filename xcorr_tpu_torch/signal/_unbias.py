r"""
:mod:`signal._unbias` -- unbias weights over the clipped lags alone
===================================================================

:func:`signal.unbias.unbias_weights` needs the weights ``npts/(npts-|k|)``
of the lags the coordinate keeps, ``index_min .. index_max - 1`` of the
full ``2·npts - 1`` lag range. The carried form
(:func:`_span_weights_plain`) builds the whole range with
:func:`util.cc.weight` and slices it: 8,639,999 float64 values per call
at a day's 50 Hz lags, of which a celerity window keeps a few thousand.
:func:`span_weights` computes the kept span alone, by the same
operations on the same float64 operands, so each weight is the same
correctly rounded division and the two are equal bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..util.cc import weight

__all__ = ["span_weights"]


def span_weights(npts, index_min, index_max):
    """``weight(npts, pad=True)[index_min:index_max]``, computed over
    that span only."""
    nn = npts * 2 - 1
    n = (nn + 1) // 2
    start, stop, _ = slice(index_min, index_max).indices(int(nn))
    k = np.arange(start, max(start, stop), dtype=np.float64) - (n - 1)
    return n / (n - np.abs(k))


def _span_weights_plain(npts, index_min, index_max):
    """The carried weights: the whole lag range, then the span (the plain
    version of :func:`span_weights`)."""
    return weight(npts, pad=True)[index_min:index_max]
