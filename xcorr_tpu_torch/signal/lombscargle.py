r"""
:mod:`signal.lombscargle` -- Lomb-Scargle periodogram
=====================================================

NaN-tolerant Lomb-Scargle over an axis
(spec: ``xcorr/signal/lombscargle.py:106-141`` =
scipy.signal.lombscargle with per-row valid masks; port of
``xcorr_tpu/signal/lombscargle.py``) in float64 on a torch device.

The classic Lomb (1976) / Scargle (1982) estimator with the :math:`\tau`
phase offset is a set of masked trigonometric sums, so the whole
(rows x freqs) periodogram vectorizes into four matrix products:

.. math::

    \tan 2\omega\tau = \frac{\sum_i m_i \sin 2\omega t_i}
                            {\sum_i m_i \cos 2\omega t_i}

with per-row masks :math:`m_i`; the numerators/denominators of the
periodogram then follow from the masked first/second-harmonic sums via
double-angle identities. The ``(F, T)`` trigonometric tables are built
and multiplied in blocks over T of at most :data:`BLOCK_ELEMENTS`
elements; the products run in float64, which cuBLAS never takes to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ndlabel import DataArray
from ..util.convert import to_device, to_numpy
from ..util.history import historicize
from ._helpers import get_dim

__all__ = ["lombscargle", "BLOCK_ELEMENTS"]

#: most elements of one block of an (F, T) trigonometric table
BLOCK_ELEMENTS = 1 << 25


def _lombscargle_rows(flat, coord, ang, normalize: bool):
    """(R, T) float64 rows with NaN gaps, (T,) sample times, (F,) angular
    freqs, all on one device -> (R, F) periodogram
    (scipy.signal.lombscargle semantics, per-row masked, rows centered on
    their valid mean)."""
    valid = ~torch.isnan(flat)
    m = valid.to(flat.dtype)
    n = m.sum(-1, keepdim=True)                        # (R, 1)
    ysum = torch.where(valid, flat, 0.0).sum(-1, keepdim=True)
    mean = ysum / torch.clamp(n, min=1.0)
    y = torch.where(valid, flat - mean, 0.0)

    F, T = ang.shape[0], coord.shape[0]
    a, b, cc2, ss2 = torch.zeros((4, flat.shape[0], F), dtype=flat.dtype,
                                 device=flat.device)
    step = max(1, BLOCK_ELEMENTS // max(F, 1))
    for t0 in range(0, T, step):
        wt = ang[:, None] * coord[None, t0:t0 + step]  # (F, t)
        c1, s1 = torch.cos(wt), torch.sin(wt)
        c2 = c1 * c1 - s1 * s1                         # cos 2wt
        s2 = 2.0 * s1 * c1                             # sin 2wt
        yb, mb = y[:, t0:t0 + step], m[:, t0:t0 + step]
        a = a + yb @ c1.T                              # (R, F)
        b = b + yb @ s1.T
        cc2 = cc2 + mb @ c2.T
        ss2 = ss2 + mb @ s2.T

    two_wtau = torch.atan2(ss2, cc2)
    c2t, s2t = torch.cos(two_wtau), torch.sin(two_wtau)
    ct, st = torch.cos(0.5 * two_wtau), torch.sin(0.5 * two_wtau)
    yc = a * ct + b * st                               # sum y cos w(t-tau)
    ys = b * ct - a * st                               # sum y sin w(t-tau)
    cc = 0.5 * (n + c2t * cc2 + s2t * ss2)             # sum cos^2 w(t-tau)
    ss = 0.5 * (n - c2t * cc2 - s2t * ss2)             # sum sin^2 w(t-tau)
    p = 0.5 * (yc * yc / cc + ys * ys / ss)
    if normalize:
        p = p * (2.0 / torch.clamp((y * y).sum(-1, keepdim=True),
                                   min=torch.finfo(flat.dtype).tiny))
    return torch.where(n >= 2, p, torch.nan)


def lombscargle(x, freqs=None, nfreqs: int = 100, dim: str = None,
                normalize: bool = False, device="cuda", **kwargs):
    """Lomb-Scargle periodogram along ``dim``, skipping NaN samples
    per row, on ``device`` (``'cuda'`` by default, which raises without a
    card)."""
    from ..core.process import resolve_device
    device = resolve_device(device)
    dim = get_dim(x, dim)
    coord = np.asarray(x.coords[dim].values, dtype=np.float64)
    if freqs is None:
        span = coord[-1] - coord[0]
        fmin = 1.0 / span
        fmax = 0.5 * (coord.size - 1) / span
        freqs = np.linspace(fmin, fmax, nfreqs)
    freqs = np.asarray(freqs, dtype=np.float64)
    ang = 2 * np.pi * freqs

    order = tuple(d for d in x.dims if d != dim) + (dim,)
    data = x.transpose(*order).data
    flat = np.asarray(data, dtype=np.float64).reshape(-1, data.shape[-1])
    out = to_numpy(_lombscargle_rows(
        to_device(flat, device), to_device(coord, device),
        to_device(ang, device), normalize))
    out = out.reshape(data.shape[:-1] + (freqs.size,))

    out_dims = tuple(d for d in order if d != dim) + ("freq",)
    y = DataArray(out, dims=out_dims, name=x.name, attrs=dict(x.attrs))
    y._coords = {k: c for k, c in x.coords.items()
                 if all(d in out_dims for d in c.dims)}
    y._coords["freq"] = DataArray(freqs, dims=("freq",), name="freq", attrs={
        "long_name": "Frequency", "units": "s-1"})
    historicize(y, f="lombscargle", a={"x": x.name, "dim": dim,
                                       "normalize": normalize})
    return y
