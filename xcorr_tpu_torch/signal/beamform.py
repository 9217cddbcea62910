r"""
:mod:`signal.beamform` -- Plane-wave beamforming
================================================

Least-squares plane-wave fit over an array of receivers
(spec: ``xcorr/signal/beamform.py:25-234``; port of
``xcorr_tpu/signal/beamform.py``): co-array receiver couples via
``triu_indices``, per-couple lag from the correlation argmax (optionally of
the envelope), then the LSE ``(AᵀA)⁻¹Aᵀτ`` giving slowness, direction of
arrival, velocity and residual.

All M co-array couples go through one
:func:`xcorr_tpu_torch.ops.cc.correlate` call on a torch device, with the
envelope and the argmax there too; the LSE runs in numpy on the host.
"""

from __future__ import annotations

import numpy as np

from .. import ops
from ..ndlabel import DataArray, Dataset
from ..util import cc as cc_host
from ..util.convert import to_device, to_numpy
from ..util.metadata import global_attrs

__all__ = ["plane_wave_estimate", "plane_wave"]


def plane_wave_estimate(s, x, y, dim: str = None, dtype=None,
                        envelope: bool = False, device="cuda", **kwargs):
    """LSE plane wave from array signals ``s`` and local x/y coordinates
    (km). Returns a Dataset with ``s_x, s_y, doa, vel, err``. The
    correlations run on ``device`` (``'cuda'`` by default, which raises
    without a card)."""
    from ..core.process import resolve_device
    device = resolve_device(device)
    dim = dim or s.dims[-1]
    if dim not in s.dims:
        raise ValueError(f's has no dimensions "{dim}"')
    dtype = np.dtype(dtype or "float64")
    if "float" not in dtype.name:
        raise TypeError("dtype should be float.")
    if len(x.dims) != 1 or len(y.dims) != 1:
        raise ValueError("x and y should be one-dimensional")
    rdim = x.dims[0]
    if rdim not in s.dims:
        raise ValueError(f's has no dimension "{rdim}"')

    # co-array couples
    N = s.sizes[rdim]
    i0, i1 = np.triu_indices(N, 1)
    M = i0.size
    xv = np.asarray(x.values, dtype=np.float64)
    yv = np.asarray(y.values, dtype=np.float64)
    A = np.stack([xv[i1] - xv[i0], yv[i1] - yv[i0]], axis=1)  # (M, 2)
    ATAinvAT = np.linalg.inv(A.T @ A) @ A.T  # (2, M)

    # batch all couples into one correlation call:
    # move rdim first, dim last -> (N, ..., n)
    order = (rdim,) + tuple(d for d in s.dims if d not in (rdim, dim)) \
        + (dim,)
    data = to_device(np.asarray(s.transpose(*order).data, dtype=dtype),
                     device)
    n = data.shape[-1]
    a = data[i0].reshape(-1, n)  # (M * ..., n)
    b = data[i1].reshape(-1, n)
    cc = ops.cc.correlate(a, b, normalize=True)
    cc = cc.reshape((M,) + tuple(data.shape[1:-1]) + (-1,))
    if envelope:
        from .hilbert import _analytic
        cc = _analytic(cc).abs()
    amax = to_numpy(cc.abs().argmax(-1))  # (M, ...)

    coord = s.coords[dim]
    vals = np.asarray(coord.values)
    if np.issubdtype(vals.dtype, np.datetime64):
        vals = vals.astype("datetime64[ns]").astype(np.int64) / 1e9
    delta = float(np.abs(vals[1] - vals[0]))
    lags = cc_host.lag(n, delta, pad=True)
    tau = np.asarray(lags)[amax]  # (M, ...)
    tau = np.moveaxis(tau, 0, -1)  # (..., M)

    # vectorized LSE
    slow = np.einsum("km,...m->...k", ATAinvAT, tau)  # (..., 2)
    ns = np.linalg.norm(slow, axis=-1)
    with np.errstate(divide="ignore"):
        vel = np.where(ns > 0, 1.0 / np.where(ns > 0, ns, 1.0), np.inf)
    doa = np.where(
        ns > 0,
        np.degrees(np.arctan2(slow[..., 0], slow[..., 1])) % 360.0, 0.0)
    e = tau - np.einsum("mk,...k->...m", A, slow)
    err = np.einsum("...m,...m->...", e, e)

    out_dims = tuple(d for d in order if d not in (rdim, dim))
    out_coords = {k: c for k, c in s.coords.items()
                  if all(d in out_dims for d in c.dims)}

    ds = Dataset()
    ds.attrs = global_attrs({
        "title": (kwargs.pop("title", "")
                  + " Least-Squares Estimated Plane Wave").strip(),
        **kwargs,
        "references": (
            "Bendat, J. Samuel, & Piersol, A. Gerald. (1971). "
            "Random data : analysis and measurement procedures. "
            "New York (N.Y.): Wiley-Interscience."),
    })
    ds.attrs["envelope"] = np.int8(envelope)

    def var(data_, attrs, name):
        da = DataArray(np.asarray(data_, dtype=dtype), dims=out_dims,
                       name=name, attrs=attrs)
        da._coords = dict(out_coords)
        return da

    ds["x"] = x
    ds["y"] = y
    ds["s_x"] = var(slow[..., 0] * 1e3, {
        "long_name": "Horizontal slowness x-component",
        "units": "s km-1"}, "s_x")
    ds["s_y"] = var(slow[..., 1] * 1e3, {
        "long_name": "Horizontal slowness y-component",
        "units": "s km-1"}, "s_y")
    ds["doa"] = var(doa, {
        "long_name": "Direction of arrival",
        "standard_name": "direction_of_arrival",
        "units": "degree", "reference": "clockwise from north"}, "doa")
    ds["vel"] = var(vel, {
        "long_name": "Horizontal velocity",
        "standard_name": "horizontal_velocity", "units": "m s-1"}, "vel")
    ds["err"] = var(err, {
        "long_name": "Error minimum value",
        "standard_name": "error_min_value", "units": "s2"}, "err")
    return ds


plane_wave = plane_wave_estimate
