# Carried from xcorr_tpu/stream/fdsn.py (see test_torch_host_copies).
r"""
:mod:`stream.fdsn` -- FDSN dataselect web-service fetch
=======================================================

Minimal FDSN ``dataselect`` client (reference: obspy's FDSN client used at
``xcorr/stream/client.py:730-758``). Fetches one receiver-day of miniSEED
over HTTP and decodes it with the native codec. Network access is entirely
optional — the waterfall client treats any failure as "no data".
"""

from __future__ import annotations

import urllib.parse
import urllib.request

from .trace import Stream, UTCDateTime

__all__ = ["fdsn_dataselect", "KNOWN_BASE_URLS"]

KNOWN_BASE_URLS = {
    "IRIS": "https://service.iris.edu",
    "ORFEUS": "https://www.orfeus-eu.org",
    "GFZ": "https://geofon.gfz-potsdam.de",
}


def fdsn_dataselect(base_url: str, receiver: str, date, timeout: float = 30.0,
                    verb: int = 0) -> Stream:
    """GET /fdsnws/dataselect/1/query for one receiver-day."""
    base = KNOWN_BASE_URLS.get(base_url, base_url).rstrip("/")
    net, sta, loc, cha = receiver.split(".")
    t0 = UTCDateTime(date)
    params = urllib.parse.urlencode({
        "network": net, "station": sta, "location": loc or "--",
        "channel": cha,
        "starttime": str(t0).rstrip("Z"),
        "endtime": str(t0 + 86400.0).rstrip("Z"),
        "format": "miniseed",
    })
    url = f"{base}/fdsnws/dataselect/1/query?{params}"
    if verb > 0:
        print("FDSN GET", url)
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        payload = resp.read()
    if not payload:
        return Stream()
    from ..native.mseed import read_mseed_bytes
    return Stream(read_mseed_bytes(payload))
