# Carried from xcorr_tpu/util/hasher.py (see test_torch_host_copies).
r"""
:mod:`util.hasher` -- sha256 provenance hashing
===============================================

Canonical sha256 hashing of python objects, traces/streams and labelled
arrays/datasets, reproducing the reference's provenance semantics
(``xcorr/util/hasher.py``): stable sorted-key JSON serialization, the same
ignore-keys (``sha256_hash*``, ``add_offset``, ``scale_factor``), metadata
vs full-data hashing, and per-trace stats+samples hashing.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

__all__ = ["hash", "hash_obj", "hash_Trace", "hash_Stream",
           "hash_DataArray", "hash_Dataset"]

_ignore_keys = ["sha256_hash", "sha256_hash_metadata",
                "add_offset", "scale_factor"]

_trace_keys = ["network", "station", "location", "channel", "starttime",
               "endtime", "sampling_rate", "delta", "npts"]

_enc = "utf-8"


def _filter_obj(obj):
    return {k: obj[k] for k in obj.keys() if k not in _ignore_keys}


def _to_serializable(obj):
    if isinstance(obj, (np.int8, np.int16, np.int32, np.int64)):
        return int(obj)
    if isinstance(obj, (np.float32, np.float64)):
        return float(obj)
    return repr(obj)


def to_json(obj):
    """Stable JSON representation used for hashing (sorted keys, compact
    separators, 4-space indent; matches ``xcorr/util/hasher.py:38-48``)."""
    return json.dumps(
        _filter_obj(obj),
        separators=(",", ":"),
        sort_keys=True,
        indent=4,
        skipkeys=False,
        default=_to_serializable,
    )


def hash(var, **kwargs):
    """Dispatch on type: DataArray, Dataset, Stream, Trace or plain object."""
    from ..ndlabel import DataArray, Dataset
    from ..stream.trace import Stream, Trace
    if isinstance(var, DataArray):
        return hash_DataArray(var, **kwargs)
    if isinstance(var, Dataset):
        return hash_Dataset(var, **kwargs)
    if isinstance(var, Stream):
        return hash_Stream(var, **kwargs)
    if isinstance(var, Trace):
        return hash_Trace(var, **kwargs)
    return hash_obj(var, **kwargs)


def hash_obj(obj, hashlib_obj=None, debug: bool = False):
    """sha256 of the canonical JSON serialization of ``obj``."""
    h = hashlib_obj or hashlib.sha256()
    h.update(to_json(obj).encode(_enc))
    if debug:
        print(f"Obj {type(obj)} hash", h.hexdigest())
    return None if hashlib_obj else h.hexdigest()


def hash_Trace(trace, hashlib_obj=None, debug: bool = False):
    """sha256 of a trace: selected stats keys as canonical JSON, followed by
    the per-sample byte representation (``xcorr/util/hasher.py:142-181``)."""
    h = hashlib_obj or hashlib.sha256()
    stats = {key: trace.stats[key] for key in _trace_keys}
    h.update(to_json(stats).encode(_enc))
    # identical digest to the reference's per-sample loop, in one update
    h.update(np.ascontiguousarray(trace.data).tobytes())
    if debug:
        print(f"Trace {trace.id} hash", h.hexdigest())
    return None if hashlib_obj else h.hexdigest()


def hash_Stream(stream, hashlib_obj=None, debug: bool = False):
    """sha256 of a stream: trace hashes chained in stream order."""
    h = hashlib_obj or hashlib.sha256()
    for trace in stream:
        hash_Trace(trace, hashlib_obj=h, debug=debug)
    if debug:
        print("Stream hash", h.hexdigest())
    return None if hashlib_obj else h.hexdigest()


def hash_DataArray(darray, metadata_only: bool = True, hashlib_obj=None,
                   debug: bool = False):
    """sha256 of a labelled array: name, dims repr, attrs JSON, and
    (optionally) the raw data bytes (``xcorr/util/hasher.py:274-319``)."""
    h = hashlib_obj or hashlib.sha256()
    h.update((darray.name or "").encode(_enc))
    h.update(repr(tuple(darray.dims)).encode(_enc))
    h.update(to_json(darray.attrs).encode(_enc))
    if not metadata_only:
        data = np.asarray(darray.data)
        if data.dtype == np.dtype(object):
            for d in np.nditer(data, flags=["refs_ok"]):
                h.update(str(d).encode(_enc))
        else:
            # one buffer update produces the identical digest to the
            # reference's per-element nditer loop, ~100x faster on
            # day-scale arrays. nditer iterates in MEMORY (K) order, so
            # serialize in K order too — a transposed view must hash
            # like the reference, not like its C-ordered copy
            h.update(data.ravel(order="K").tobytes())
    if debug:
        print(darray.name, h.hexdigest())
    return None if hashlib_obj else h.hexdigest()


def hash_Dataset(dataset, metadata_only: bool = True, hashlib_obj=None,
                 debug: bool = False):
    """sha256 of a dataset: sorted coords then sorted data variables
    (``xcorr/util/hasher.py:218-271``). Global attrs only enter the hash
    when ``metadata_only=False``."""
    h = hashlib_obj or hashlib.sha256()
    if not metadata_only:
        h.update(to_json(dataset.attrs).encode(_enc))
    for coord in sorted(dataset.coords):
        hash_DataArray(dataset[coord], hashlib_obj=h,
                       metadata_only=metadata_only, debug=debug)
    for var in sorted(dataset):
        hash_DataArray(dataset[var], hashlib_obj=h,
                       metadata_only=metadata_only, debug=debug)
    if debug:
        print("Dataset hash", h.hexdigest())
    return None if hashlib_obj else h.hexdigest()
