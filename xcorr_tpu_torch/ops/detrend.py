r"""
:mod:`ops.detrend` -- Demean / detrend
======================================

NaN-aware constant and linear detrending along the last axis of a tensor
(spec: ``xcorr/signal/detrend.py:31-145``; port of
``xcorr_tpu/ops/detrend.py``). Closed-form least squares: elementwise
work and reductions, no factorization.
"""

from __future__ import annotations

import torch

__all__ = ["demean", "detrend_linear", "detrend_simple"]


def demean(x):
    """Subtract the (NaN-aware) mean along the last axis."""
    return x - torch.nanmean(x, dim=-1, keepdim=True)


def detrend_simple(x):
    """Subtract the line through the FIRST and LAST samples along the
    last axis: obspy's ``detrend('simple')``, an endpoint line, not the
    least-squares fit (``stream/trace.py`` detrend)."""
    n = x.shape[-1]
    if n < 2:
        return x
    first = x[..., :1]
    slope = (x[..., -1:] - first) / (n - 1)
    t = torch.arange(n, dtype=x.dtype, device=x.device)
    return x - (first + slope * t)


def detrend_linear(x):
    """Remove the least-squares line along the last axis (NaN-aware).

    The fit runs on a time axis CENTERED on the row's valid samples, so
    every sum is either sign-definite or scaled by the data: the
    uncentered normal equations subtract near-equal ~n^3 sums, which at
    day scale in float32 cancel catastrophically (the reference measured
    an O(0.01) offset left by a 1e-3/sample trend over 4.75M samples).
    """
    n = x.shape[-1]
    t = torch.arange(n, dtype=x.dtype, device=x.device) - 0.5 * (n - 1)
    valid = ~torch.isnan(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xf = torch.where(valid, x, zero)
    cnt = valid.sum(dim=-1, keepdim=True).to(x.dtype)
    st = torch.where(valid, t, zero).sum(dim=-1, keepdim=True)
    tm = torch.where(cnt != 0, st / cnt, zero)   # valid-sample center
    u = t - tm
    um = torch.where(valid, u, zero)
    suu = (um * um).sum(dim=-1, keepdim=True)   # sign-definite
    sx = xf.sum(dim=-1, keepdim=True)
    ym = torch.where(cnt != 0, sx / cnt, zero)
    sux = (um * xf).sum(dim=-1, keepdim=True)   # sum(u) = 0 on valid
    slope = torch.where(suu != 0, sux / suu, zero)
    return x - (ym + slope * u)
