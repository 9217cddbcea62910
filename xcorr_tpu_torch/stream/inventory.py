# Carried from xcorr_tpu/stream/inventory.py (see test_torch_host_copies).
r"""
:mod:`stream.inventory` -- Station inventory
============================================

A lightweight station-metadata inventory replacing the reference's
``obspy.Inventory`` usage: receiver coordinates for geodesy
(``xcorr/util/receiver.py:326-345``), sensitivity and poles-and-zeros
instrument responses for the preprocess DSL's ``remove_response`` /
``remove_sensitivity`` ops (``xcorr/stream/process.py:58-65``).

Channels are plain records; responses are PAZ + overall sensitivity,
evaluated on the host as complex frequency-response curves that the device
pipeline divides out spectrally.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PAZResponse", "Channel", "Inventory", "flat_response"]


@dataclass
class PAZResponse:
    """Poles-and-zeros response with gain and overall sensitivity.

    ``evaluate`` returns the complex response at given frequencies for the
    requested output quantity: 'DISP', 'VEL' (native) or 'ACC'.
    """
    poles: list = field(default_factory=list)
    zeros: list = field(default_factory=list)
    gain: float = 1.0          # A0 normalization factor
    sensitivity: float = 1.0   # overall instrument sensitivity (counts/(m/s))
    input_units: str = "M/S"

    def evaluate(self, freqs, output: str = "VEL"):
        s = 2j * np.pi * np.asarray(freqs, dtype=np.float64)
        num = np.ones_like(s, dtype=np.complex128)
        for z in self.zeros:
            num *= s - complex(z)
        den = np.ones_like(s, dtype=np.complex128)
        for p in self.poles:
            den *= s - complex(p)
        with np.errstate(divide="ignore", invalid="ignore"):
            resp = self.gain * self.sensitivity * num / den
        resp[~np.isfinite(resp)] = 0.0
        # native input units -> requested output: a response defined as
        # counts-per-native converts as R_want = R_native * s^(native-want)
        # with order DISP=0, VEL=1, ACC=2 (VEL = s * DISP in Laplace domain)
        order = {"M": 0, "DISP": 0, "M/S": 1, "VEL": 1,
                 "M/S**2": 2, "ACC": 2, "PA": 1}
        native = order.get((self.input_units or "M/S").upper(), 1)
        want = order[output.upper()]
        if native != want:
            with np.errstate(divide="ignore", invalid="ignore"):
                resp = resp * s ** (native - want)
            resp[~np.isfinite(resp)] = 0.0
        return resp

    def to_dict(self):
        return {
            "poles": [[p.real, p.imag] for p in map(complex, self.poles)],
            "zeros": [[z.real, z.imag] for z in map(complex, self.zeros)],
            "gain": self.gain,
            "sensitivity": self.sensitivity,
            "input_units": self.input_units,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            poles=[complex(*p) for p in d.get("poles", [])],
            zeros=[complex(*z) for z in d.get("zeros", [])],
            gain=d.get("gain", 1.0),
            sensitivity=d.get("sensitivity", 1.0),
            input_units=d.get("input_units", "M/S"),
        )


def flat_response():
    """Unity response (used when no inventory is provided)."""
    return PAZResponse()


@dataclass
class Channel:
    """One channel epoch: seed id parts, coordinates and response."""
    network: str
    station: str
    location: str
    channel: str
    latitude: float = 0.0
    longitude: float = 0.0
    elevation: float = 0.0
    starttime: object = None
    endtime: object = None
    response: PAZResponse = field(default_factory=flat_response)

    @property
    def id(self):
        return f"{self.network}.{self.station}.{self.location}.{self.channel}"


class Inventory:
    """Collection of channel epochs with obspy-like lookups."""

    def __init__(self, channels=None):
        self.channels = list(channels) if channels else []

    def __len__(self):
        return len(self.channels)

    def __add__(self, other):
        return Inventory(self.channels + list(other.channels))

    def add(self, channel: Channel):
        self.channels.append(channel)
        return self

    def _find(self, seed_id: str, time=None):
        from .trace import UTCDateTime
        for c in self.channels:
            if c.id != seed_id:
                continue
            if time is not None:
                t = UTCDateTime(time)
                if c.starttime is not None and t < UTCDateTime(c.starttime):
                    continue
                if c.endtime is not None and t > UTCDateTime(c.endtime):
                    continue
            return c
        raise KeyError(f"no matching channel for {seed_id!r}")

    def get_coordinates(self, seed_id: str, time=None):
        c = self._find(seed_id, time)
        return {"latitude": c.latitude, "longitude": c.longitude,
                "elevation": c.elevation}

    def get_response(self, seed_id: str, time=None):
        return self._find(seed_id, time).response

    def get_sensitivity(self, seed_id: str, time=None):
        return self._find(seed_id, time).response.sensitivity

    def select_receivers(self, receivers, starttime=None, endtime=None):
        """Subset inventory to the given SEED-ids (wildcards allowed in
        channel position via fnmatch)."""
        from fnmatch import fnmatch
        keep = [c for c in self.channels
                if any(fnmatch(c.id, r) for r in receivers)]
        return Inventory(keep)

    def select(self, network="*", station="*", location="*", channel="*",
               **kw):
        from fnmatch import fnmatch
        keep = [c for c in self.channels
                if fnmatch(c.network, network) and fnmatch(c.station, station)
                and fnmatch(c.location, location)
                and fnmatch(c.channel, channel)]
        return Inventory(keep)

    # -- (de)serialization ---------------------------------------------------

    def to_json(self, path=None):
        payload = [{
            "network": c.network, "station": c.station,
            "location": c.location, "channel": c.channel,
            "latitude": c.latitude, "longitude": c.longitude,
            "elevation": c.elevation,
            "starttime": str(c.starttime) if c.starttime else None,
            "endtime": str(c.endtime) if c.endtime else None,
            "response": c.response.to_dict(),
        } for c in self.channels]
        text = json.dumps(payload, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, path_or_text):
        try:
            payload = json.loads(path_or_text)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_text) as f:
                payload = json.load(f)
        channels = []
        for d in payload:
            resp = PAZResponse.from_dict(d.pop("response", {}))
            channels.append(Channel(response=resp, **d))
        return cls(channels)
