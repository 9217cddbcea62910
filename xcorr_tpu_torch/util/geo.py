# Carried from xcorr_tpu/util/geo.py (see test_torch_host_copies).
r"""
:mod:`util.geo` -- Geodesy
==========================

Self-contained WGS84 geodesy replacing the reference's pyproj dependency
(``xcorr/util/receiver.py:348-476`` uses ``pyproj.Geod.inv`` for pair
distances and ``pyproj.Proj(aeqd)`` for local beamforming coordinates).

Implements Vincenty's inverse formula (accurate to <0.5 mm on WGS84 for
non-antipodal points) and an azimuthal-equidistant projection built on it:
``x = s·sin(az), y = s·cos(az)`` with geodesic distance ``s`` and forward
azimuth ``az`` from the projection center — the geodesic aeqd definition.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ELLIPSOIDS", "inverse", "aeqd_xy"]

ELLIPSOIDS = {
    # name: (semi-major axis a [m], inverse flattening 1/f)
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "sphere": (6371008.7714, np.inf),
}


def inverse(lon1, lat1, lon2, lat2, ellipsoid: str = "WGS84",
            max_iter: int = 200, tol: float = 1e-12):
    """Geodesic inverse problem: forward azimuth, back azimuth and distance.

    Vectorized Vincenty inverse. Angles in decimal degrees; distance in
    meters. Returns ``(az12, az21, dist)`` matching ``pyproj.Geod.inv``.
    """
    a, inv_f = ELLIPSOIDS[ellipsoid]
    f = 0.0 if np.isinf(inv_f) else 1.0 / inv_f
    b = a * (1 - f)

    lon1, lat1, lon2, lat2 = (np.asarray(x, dtype=np.float64)
                              for x in (lon1, lat1, lon2, lat2))
    L = np.radians(lon2 - lon1)
    U1 = np.arctan((1 - f) * np.tan(np.radians(lat1)))
    U2 = np.arctan((1 - f) * np.tan(np.radians(lat2)))
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)

    lam = L.copy()
    for _ in range(max_iter):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt(
            (cosU2 * sin_lam) ** 2
            + (cosU1 * sinU2 - sinU1 * cosU2 * cos_lam) ** 2
        )
        cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cos_lam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(sin_sigma != 0,
                                 cosU1 * cosU2 * sin_lam / sin_sigma, 0.0)
        cos2_alpha = 1 - sin_alpha ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos_2sigma_m = np.where(
                cos2_alpha != 0,
                cos_sigma - 2 * sinU1 * sinU2 / np.where(
                    cos2_alpha != 0, cos2_alpha, 1.0),
                0.0,
            )
        C = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        lam_prev = lam
        lam = L + (1 - C) * f * sin_alpha * (
            sigma + C * sin_sigma * (
                cos_2sigma_m
                + C * cos_sigma * (-1 + 2 * cos_2sigma_m ** 2)
            )
        )
        if np.all(np.abs(lam - lam_prev) < tol):
            break

    u2 = cos2_alpha * (a ** 2 - b ** 2) / b ** 2
    A = 1 + u2 / 16384 * (4096 + u2 * (-768 + u2 * (320 - 175 * u2)))
    B = u2 / 1024 * (256 + u2 * (-128 + u2 * (74 - 47 * u2)))
    delta_sigma = B * sin_sigma * (
        cos_2sigma_m
        + B / 4 * (
            cos_sigma * (-1 + 2 * cos_2sigma_m ** 2)
            - B / 6 * cos_2sigma_m
            * (-3 + 4 * sin_sigma ** 2) * (-3 + 4 * cos_2sigma_m ** 2)
        )
    )
    dist = b * A * (sigma - delta_sigma)

    az12 = np.degrees(np.arctan2(
        cosU2 * np.sin(lam),
        cosU1 * sinU2 - sinU1 * cosU2 * np.cos(lam),
    ))
    az21 = np.degrees(np.arctan2(
        cosU1 * np.sin(lam),
        -sinU1 * cosU2 + cosU1 * sinU2 * np.cos(lam),
    )) + 180.0
    az21 = np.mod(az21 + 180.0, 360.0) - 180.0
    # coincident points: zero distance, zero azimuths
    coincident = (np.abs(L) < 1e-15) & (np.abs(U1 - U2) < 1e-15)
    dist = np.where(coincident, 0.0, dist)
    return az12, az21, dist


def aeqd_xy(lon, lat, lon0, lat0, ellipsoid: str = "WGS84"):
    """Geodesic azimuthal-equidistant local coordinates (meters).

    Points project to ``(s·sin(az), s·cos(az))`` with geodesic distance
    ``s`` and forward azimuth ``az`` from the center ``(lon0, lat0)`` —
    the same definition as PROJ's ellipsoidal ``aeqd`` used by the
    reference for beamforming (``xcorr/util/receiver.py:406-476``).
    """
    az12, _, dist = inverse(
        np.broadcast_to(np.float64(lon0), np.shape(lon)),
        np.broadcast_to(np.float64(lat0), np.shape(lat)),
        lon, lat, ellipsoid=ellipsoid)
    az = np.radians(az12)
    return dist * np.sin(az), dist * np.cos(az)
