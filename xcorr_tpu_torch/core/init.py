# Carried from xcorr_tpu/core/init.py (see test_torch_host_copies).
r"""
:mod:`core.init` -- Initialize the CCF dataset
==============================================

Build the empty self-describing CCF Dataset with the reference schema
(spec: ``xcorr/core/init.py:25-327``): coords ``pair``/``time``/``lag``,
vars ``distance``/``status``/``pair_offset``/``time_offset``/``cc``
(+ optional ``hash``), CF-1.9 global attrs and the metadata sha256 stamp.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd

from .. import stream as stream_mod
from .. import util
from ..ndlabel import Dataset

__all__ = ["init"]


def init(pair: str, starttime, endtime, preprocess: dict, attrs: dict,
         sampling_rate: float, window_length: float = 86400.0,
         window_overlap: float = 0.875, clip_lag=None,
         unbiased_cc: bool = False, closed: str = "left",
         dtype=np.float32, inventory=None, stationary_poi: dict = None,
         hash_waveforms: bool = False, pack_cc: bool = False,
         complevel: int = 1):
    """Initialize an N-D labelled CCF dataset for one receiver pair.

    ``complevel`` sets the zlib level baked into every variable's
    storage encoding (default 1 — see the divergence note below;
    ``complevel=9`` restores the reference's exact storage config;
    ``complevel=0`` stores uncompressed — fastest shard writes, e.g.
    for throughput-bound campaigns combined with ``pack_cc=True``).

    ``pack_cc=True`` stores the ``cc`` variable CF-packed as int16 with
    a per-file ``scale_factor`` (realizing the schema's reserved
    ``scale_factor``/``add_offset`` attrs, reference
    ``xcorr/core/init.py:126-127``): shards shrink ~45% and the
    writer-thread zlib cost roughly halves, at a quantization error of
    ``max|cc|/32765/2`` (~1.5e-5 for normalized CCFs — the same order
    as the tunnel wire codec). Off by default (reference stores f32).
    """
    if not isinstance(attrs, dict):
        raise TypeError("attrs must be a dict of global metadata")
    for key, hint in (("institution", "Institution, department"),
                      ("author", "Name - E-mail"),
                      ("source", "Data source description")):
        if key not in attrs:
            raise KeyError(
                f"required global attr {key!r} missing (e.g. {hint!r})")
    if not isinstance(pair, str):
        raise TypeError(
            "pair must be a 'RECEIVER-RECEIVER' SEED-id string")

    starttime = util.time.to_datetime(starttime)
    endtime = util.time.to_datetime(endtime)
    delta = 1.0 / sampling_rate
    npts = int(window_length * sampling_rate)
    # DIVERGENCE from the reference's complevel 9 (xcorr/core/init.py:121):
    # on f32 CCF data gzip-9+shuffle costs 19.4 s per production shard
    # for 14.8% size reduction, while gzip-1+shuffle reaches 13.7% in
    # 3.3 s (measured; noise-like mantissas simply don't deflate).
    # Level 1 keeps the standard netCDF zlib encoding — files stay
    # readable by any netCDF tool — and cuts the dominant cost of the
    # end-to-end shard pipeline. Override via init(complevel=) or
    # write(variable_encoding=).
    # complevel=0 -> genuinely uncompressed (not gzip level 0, which
    # still pays the deflate-framing pass): ~6x faster shard writes
    encoding = ({"zlib": True, "complevel": int(complevel),
                 "shuffle": True} if int(complevel) > 0
                else {"zlib": False})

    dataset = Dataset()
    dataset.attrs = {
        "title": (
            (attrs.get("title", "") + " Cross-correlations - {}{}".format(
                starttime.strftime("%Y.%j"),
                " to {}".format(endtime.strftime("%Y.%j"))
                if starttime.strftime("%Y.%j") != endtime.strftime("%Y.%j")
                else ""))
        ).strip(),
        "institution": attrs["institution"],
        "author": attrs["author"],
        "source": attrs["source"],
        "history": "Created @ {}".format(pd.to_datetime("now")),
        "references": (
            "Bendat, J. Samuel, & Piersol, A. Gerald. (1971). "
            "Random data : analysis and measurement procedures. "
            "New York (N.Y.): Wiley-Interscience."),
        "comment": attrs.get("comment", "n/a"),
        "Conventions": "CF-1.9",
        "xcorr_version": util.metadata.version,
        "dependencies_version": util.metadata.list_versions(as_str=True),
    }

    # pair coordinate with hashed preprocess config
    dataset.coords["pair"] = np.array([pair], dtype=object)
    dataset.coords["pair"].attrs = {
        "long_name": "Cross-correlation receiver pair",
        "standard_name": "receiver_pair",
        "units": "-",
        "preprocess": stream_mod.process.hash_operations(preprocess),
    }

    # time windows
    freq_s = window_length * (1 - window_overlap)
    times = pd.date_range(start=starttime, end=endtime,
                          freq=f"{freq_s:.0f}s", inclusive=closed or "both")
    dataset.coords["time"] = times.values
    dataset.coords["time"].attrs = {
        "window_length": window_length,
        "window_overlap": window_overlap,
        "closed": str(closed),
    }

    # lag coordinate (optionally clipped)
    lag = util.cc.lag(npts, delta, pad=True)
    if clip_lag is not None:
        msg = ("clip_lag must be seconds: a single float (symmetric "
               "window) or a (start, end) float tuple")
        if isinstance(clip_lag, float):
            clip_lag = (-abs(clip_lag), abs(clip_lag))
        elif isinstance(clip_lag, tuple) and len(clip_lag) == 2:
            if not all(isinstance(v, float) for v in clip_lag):
                raise TypeError(msg)
        else:
            raise TypeError(msg)
        nmin = int(np.argmin(np.abs(lag - clip_lag[0])))
        nmax = int(np.argmin(np.abs(lag - clip_lag[1])))
    else:
        nmin = 0
        nmax = 2 * npts - 1
    dataset.coords["lag"] = lag[nmin:nmax]
    dataset.coords["lag"].attrs = {
        "long_name": "Time lag",
        "standard_name": "time_lag",
        "units": "s",
        "sampling_rate": float(sampling_rate),
        "delta": float(delta),
        "npts": int(npts),
        "clip_lag": np.array(clip_lag if clip_lag is not None else []),
        "index_min": int(nmin),
        "index_max": int(nmax),
    }

    # pair distance
    if inventory is not None:
        distance = util.receiver.get_pair_distance(
            pair=pair, inventory=inventory, poi=stationary_poi,
            ellipsoid="WGS84", km=True)
    else:
        distance = 0.0
    dataset["distance"] = (
        ("pair",), np.ones((1,), dtype=np.float64) * distance,
        {
            "long_name": "receiver pair distance",
            "standard_name": "receiver_pair_distance",
            "units": "km",
            "description": (("relative to poi" if stationary_poi
                             else "absolute") + " WGS84 geodetic distance"),
            "relative_to_poi": (json.dumps(stationary_poi)
                                if stationary_poi else "n/a"),
        },
        encoding,
    )

    nt = dataset.coords["time"].size
    dataset["status"] = (
        ("pair", "time"), np.zeros((1, nt), dtype=np.int8),
        {
            "long_name": "processing status",
            "standard_name": "processing_status",
            "units": "-",
            "valid_range": np.int8([-1, 1]),
            "flag_values": np.int8([-1, 0, 1]),
            "flag_meanings": "missing_data not_processed processed",
        },
        encoding,
    )

    if hash_waveforms:
        dataset["hash"] = (
            ("pair", "time"),
            np.array([["n/a"] * nt], dtype=object),
            {
                "long_name": "pair preprocessed stream hash",
                "standard_name": "pair_preprocessed_stream_hash",
                "units": "-",
                "description": (
                    "Openssl SHA256 hash of the pair preprocessed waveform "
                    "stream. Be aware that stream/pair order matters! "
                    "The hash is updated per trace and includes the "
                    "stats with keys=['network', 'station', 'location', "
                    "'channel', 'starttime', 'endtime', 'sampling_rate', "
                    "'delta', 'npts'], sorted and dumped to json with 4 "
                    "character space indentation and separators ',' and "
                    "':', followed by the hash of each sample byte "
                    "representation."),
            },
            encoding,
        )

    dataset["pair_offset"] = (
        ("pair", "time"), np.zeros((1, nt), dtype=np.float64),
        {
            "long_name": "receiver pair start sample offset",
            "standard_name": "receiver_pair_start_sample_offset",
            "units": "s",
            "description": (
                "offset = receiver[0].starttime - receiver[1].starttime"),
        },
        encoding,
    )
    dataset["time_offset"] = (
        ("pair", "time"), np.zeros((1, nt), dtype=np.float64),
        {
            "long_name": "first receiver start sample offset",
            "standard_name": "first_receiver_start_sample_offset",
            "units": "s",
            "description": (
                "offset = receiver[0].starttime - time + window_length/2"),
        },
        encoding,
    )

    dataset["cc"] = (
        ("pair", "time", "lag"),
        np.zeros((1, nt, dataset.coords["lag"].size), dtype=dtype),
        {
            "long_name": "Cross-correlation Estimate",
            "standard_name": "cross-correlation_estimate",
            "units": "-",
            "add_offset": np.dtype(dtype).type(0.0),
            "scale_factor": np.dtype(dtype).type(1.0),
            "valid_range": np.dtype(dtype).type([-1.0, 1.0]),
            "normalize": np.int8(1),
            "bias_correct": np.int8(unbiased_cc),
            "unbiased": np.int8(0),
        },
        {**encoding, "dtype": "int16"} if pack_cc else encoding,
    )

    dataset.attrs["sha256_hash_metadata"] = util.hasher.hash_Dataset(
        dataset, metadata_only=True)
    return dataset
