# Carried from xcorr_tpu/util/receiver.py (see test_torch_host_copies).
r"""
:mod:`util.receiver` -- Receiver utilities
==========================================

SEED-id validation/parsing, receiver-pair splitting with R/T component
substitution, inventory filtering, and WGS84 pair geodesy
(reference: ``xcorr/util/receiver.py``).
"""

from __future__ import annotations

from re import match

import numpy as np

from . import geo

__all__ = ["check_receiver", "split_pair", "split_pairs", "receiver_to_dict",
           "receiver_to_str", "get_receiver_channel", "get_pair_inventory",
           "get_receiver_coordinates", "get_pair_distance",
           "get_pair_xy_coordinates"]

_regex_seed_id = (
    r"^([A-Z,0-9]{2})\.([A-Z,0-9]{3,5})\.([0-9]{0,2})\.([A-Z]{2}[0-9,A-Z]{1})"
)
_regex_seed_id_wildcards = (
    r"^([A-Z,?*]{1,2})\.([A-Z,0-9,?*]{1,5})\."
    r"([0-9,?*]{0,2})\.([0-9,A-Z,?*]{1,3})"
)


def check_receiver(receiver: str, allow_wildcards: bool = False,
                   raise_error: bool = False):
    """Validate a receiver SEED-id string
    ('{network}.{station}.{location}.{channel}')."""
    if allow_wildcards is False:
        if "*" in receiver or "?" in receiver:
            if raise_error:
                raise ValueError(
                    "Receiver SEED-id cannot contain wildcards (? or *)! "
                    "Be specific."
                )
            return False
        if not match(_regex_seed_id, receiver):
            if raise_error:
                raise ValueError(
                    "Receiver SEED-id is not of valid format "
                    '"network.station.location.channel".'
                )
            return False
    else:
        if not match(_regex_seed_id_wildcards, receiver):
            if raise_error:
                raise ValueError(
                    "Receiver SEED-id is not of valid format "
                    '"network.station.location.channel".'
                )
            return False
    return True


def split_pair(pair, separator: str = "-", substitute: bool = False,
               three_components: str = None, to_dict: bool = False):
    """Split a receiver-pair string into SEED-ids, optionally substituting
    rotated 'R'/'T' orientation codes with the raw three components
    (``xcorr/util/receiver.py:93-157``)."""
    if hasattr(pair, "values"):  # DataArray
        pair = pair.values
    if isinstance(pair, np.ndarray):
        pair = str(pair.astype("<U"))
    if not isinstance(pair, str):
        raise TypeError("Pair should be a string, ndarray or DataArray")

    three_components = three_components or "12Z"
    if three_components not in ("12Z", "NEZ"):
        raise ValueError('three_components should be either "12Z" or "NEZ"!')

    receivers = pair.split(separator)
    if substitute:
        tmp = []
        for r in receivers:
            if r[-1] in "RT":
                tmp += [r[:-1] + c for c in three_components]
            else:
                tmp += [r]
        receivers = tmp
    return [receiver_to_dict(r) for r in receivers] if to_dict else receivers


def split_pairs(pairs, **kwargs):
    """Split many receiver-pair strings."""
    return [split_pair(pair=p, **kwargs) for p in pairs]


def receiver_to_dict(receiver: str):
    """SEED-id string -> dict with network/station/location/channel."""
    return dict(zip(
        ["network", "station", "location", "channel"],
        receiver.split("."),
    ))


def receiver_to_str(receiver: dict):
    """SEED-id dict -> string."""
    return "{network}.{station}.{location}.{channel}".format(**receiver)


def get_receiver_channel(receiver):
    """Channel code of a receiver SEED-id (str or dict)."""
    if isinstance(receiver, dict):
        return receiver["channel"]
    return receiver.split(".")[3]


def get_pair_inventory(pair, inventory, times=None):
    """Filter an inventory to the pair's receivers (and period).

    ``inventory`` is an :class:`xcorr_tpu.stream.Inventory`; returns its
    ``select``-filtered subset covering both receivers of ``pair`` (or of
    each pair in a list).
    """
    pairs = pair if isinstance(pair, (list, tuple, np.ndarray)) else [pair]
    receivers = set()
    for p in pairs:
        for r in split_pair(p, substitute=True):
            receivers.add(r)
    t0 = t1 = None
    if times is not None:
        times = np.asarray(times)
        t0, t1 = times.min(), times.max()
    return inventory.select_receivers(sorted(receivers), starttime=t0,
                                      endtime=t1)


def get_receiver_coordinates(receiver: str, inventory):
    """Longitude/latitude (decimal degrees) of a receiver from the
    inventory."""
    coords = inventory.get_coordinates(receiver)
    return coords["longitude"], coords["latitude"]


def get_pair_distance(pair, inventory, poi: dict = None,
                      ellipsoid: str = "WGS84", km: bool = True):
    """Geodesic distance between the receivers of ``pair``; if ``poi`` is
    given, the difference of each receiver's distance to the
    point-of-interest (``xcorr/util/receiver.py:348-403``)."""
    r0, r1 = split_pair(pair, substitute=False)[:2]
    lon0, lat0 = get_receiver_coordinates(r0, inventory)
    lon1, lat1 = get_receiver_coordinates(r1, inventory)
    if poi:
        _, _, d0 = geo.inverse(poi["longitude"], poi["latitude"], lon0, lat0,
                               ellipsoid=ellipsoid)
        _, _, d1 = geo.inverse(poi["longitude"], poi["latitude"], lon1, lat1,
                               ellipsoid=ellipsoid)
        d = abs(float(d0) - float(d1))
    else:
        _, _, d = geo.inverse(lon0, lat0, lon1, lat1, ellipsoid=ellipsoid)
        d = float(d)
    return d * 1e-3 if km else d


def get_pair_xy_coordinates(pairs, inventory, ellipsoid: str = "WGS84",
                            km: bool = True):
    """Local azimuthal-equidistant x/y coordinates of all receivers in
    ``pairs``, centered on their mean lon/lat — used for plane-wave
    beamforming (``xcorr/util/receiver.py:406-476``).

    Returns ``(receivers, x, y)`` with x/y in km (default) or m.
    """
    receivers, lons, lats = [], [], []
    for p in pairs:
        for r in split_pair(p, substitute=False):
            if r not in receivers:
                lon, lat = get_receiver_coordinates(r, inventory)
                receivers.append(r)
                lons.append(lon)
                lats.append(lat)
    lons, lats = np.asarray(lons), np.asarray(lats)
    x, y = geo.aeqd_xy(lons, lats, lons.mean(), lats.mean(),
                       ellipsoid=ellipsoid)
    fact = 1e-3 if km else 1.0
    return receivers, x * fact, y * fact
