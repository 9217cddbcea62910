r"""
:mod:`io.netcdf` -- netCDF-4 storage on the port's own HDF5 codec
=================================================================

Self-describing dataset persistence on plain HDF5, written and read by
:mod:`io.hdf5` (numpy + zlib; no HDF5 library, so the shards are written
and read wherever the port runs). Files follow netCDF-4 conventions —
dimension-scale coordinate datasets, gzip+shuffle encoding, CF
attributes — so external netCDF tooling can open the shards, and carry a
small set of ``_xcorr_*`` attributes that make the round trip through
:mod:`xcorr_tpu_torch.ndlabel` type-exact (datetime64/bool/str
restoration). The API and its semantics are the JAX package's
``xcorr_tpu/io/netcdf.py``: each package reads the other's files to the
same Dataset.

Reference behavior being reproduced: ``xcorr/io/read.py`` /
``xcorr/io/write.py`` persistence of the CCF Dataset with zlib-9+shuffle
encoding (``xcorr/core/init.py:121``).
"""

from __future__ import annotations

import itertools
import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ndlabel import DataArray, Dataset
from . import hdf5

__all__ = ["to_netcdf", "from_netcdf"]

_STR_DTYPE = hdf5.string_dtype()

# arrays at least this large go through the threaded chunk compressor
# (zlib releases the GIL, so compression parallelizes across chunks;
# the codec's normal write path compresses chunk after chunk). The file
# stays a standard shuffle+deflate HDF5/netCDF-4.
_PARALLEL_WRITE_MIN = 4 << 20
_PARALLEL_WRITE_THREADS = 8


def _shuffle_bytes(block):
    """The HDF5 shuffle filter (byte-plane transpose) in numpy."""
    s = block.dtype.itemsize
    if s == 1:
        return block.tobytes()
    a = np.ascontiguousarray(block).reshape(-1).view(np.uint8)
    return np.ascontiguousarray(a.reshape(-1, s).T).tobytes()


def _default_chunks(shape, dtype):
    """Chunk layout for the threaded writer: one chunk per trailing row
    for nd arrays (the CCF layout (pair, time, lag) -> (1, 1, lag)),
    ~8-way splits for 1-D arrays."""
    if len(shape) >= 2:
        return (1,) * (len(shape) - 1) + (shape[-1],)
    n = int(shape[0])
    target = max(1 << 18, -(-n // _PARALLEL_WRITE_THREADS))
    return (min(n, target),)


def _direct_chunk_write(dset, data, chunks, complevel, shuffle):
    """Compress chunks in a thread pool and store them verbatim via
    ``write_direct_chunk`` (bit-identical to the serial shuffle +
    deflate pipeline; edge chunks zero-padded to full chunk size, as
    HDF5 itself stores them); the codec builds the chunk B-tree over
    them when the file closes."""
    shape = data.shape
    coords = list(itertools.product(
        *[range(0, shape[i], chunks[i]) for i in range(len(shape))]))

    def prep(off):
        sl = tuple(slice(o, min(o + c, s))
                   for o, c, s in zip(off, chunks, shape))
        block = np.ascontiguousarray(data[sl])
        if block.shape != tuple(chunks):
            full = np.zeros(chunks, dtype=data.dtype)
            full[tuple(slice(0, b) for b in block.shape)] = block
            block = full
        buf = _shuffle_bytes(block) if shuffle else block.tobytes()
        return off, zlib.compress(buf, complevel)

    nthreads = min(_PARALLEL_WRITE_THREADS, len(coords))
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        for off, payload in ex.map(prep, coords):
            dset.write_direct_chunk(off, payload)


def _encode_data(data):
    """Convert numpy data to an HDF5-storable array + restoration attrs."""
    extra = {}
    if np.issubdtype(data.dtype, np.datetime64):
        extra["_xcorr_dtype"] = str(data.dtype)
        extra["units"] = "nanoseconds since 1970-01-01"
        extra["calendar"] = "proleptic_gregorian"
        data = data.astype("datetime64[ns]").astype(np.int64)
    elif np.issubdtype(data.dtype, np.timedelta64):
        extra["_xcorr_dtype"] = str(data.dtype)
        extra["units"] = "nanoseconds"
        data = data.astype("timedelta64[ns]").astype(np.int64)
    elif data.dtype == bool:
        extra["_xcorr_dtype"] = "bool"
        data = data.astype(np.int8)
    elif data.dtype == object or data.dtype.kind in "US":
        extra["_xcorr_dtype"] = "str"
        data = np.asarray(data, dtype=object)
    return data, extra


def _decode_data(data, attrs):
    """Invert :func:`_encode_data` using the restoration attrs."""
    want = attrs.get("_xcorr_dtype")
    if want is None:
        return data
    if want.startswith("datetime64"):
        return data.astype(np.int64).astype("datetime64[ns]").astype(want)
    if want.startswith("timedelta64"):
        return data.astype(np.int64).astype("timedelta64[ns]").astype(want)
    if want == "bool":
        return data.astype(bool)
    if want == "str":
        out = np.empty(data.shape, dtype=object)
        flat_in = data.reshape(-1)
        flat_out = out.reshape(-1)
        for i, v in enumerate(flat_in):
            flat_out[i] = v.decode("utf-8") if isinstance(v, bytes) else str(v)
        return out
    return data


def _encode_attr(value):
    """Convert one attribute value to an HDF5-storable form.

    Returns (storable, was_json): dicts/lists-of-mixed go through JSON.
    """
    if isinstance(value, dict):
        return json.dumps(value), True
    if value is None:
        return "n/a", False
    # datetime64/timedelta64 have no native HDF5 equivalent (the codec
    # raises, as h5py does); store ISO-8601 / str form like CF attribute
    # conventions.
    # np.datetime64 is an np.generic, so check before that branch.
    if isinstance(value, (np.datetime64, np.timedelta64)):
        return str(value), False
    if isinstance(value, (str, bytes, int, float, np.generic)):
        return value, False
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind in "USmM":
        return json.dumps([str(v) for v in arr.tolist()]), True
    return arr, False


def _write_attrs(h5obj, attrs):
    json_keys = []
    for k, v in attrs.items():
        sv, was_json = _encode_attr(v)
        if was_json:
            json_keys.append(k)
        h5obj.attrs[k] = sv
    if json_keys:
        h5obj.attrs["_xcorr_json_attrs"] = json.dumps(json_keys)


# HDF5/netCDF-4 internal attributes hidden from user attrs (the same set
# h5netcdf masks)
_HIDDEN_ATTRS = {"CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST",
                 "_Netcdf4Dimid", "_Netcdf4Coordinates", "_NCProperties"}


def _read_attrs(h5obj):
    raw = {k: v for k, v in h5obj.attrs.items() if k not in _HIDDEN_ATTRS}
    json_keys = set()
    if "_xcorr_json_attrs" in raw:
        json_keys = set(json.loads(raw.pop("_xcorr_json_attrs")))
    out = {}
    for k, v in raw.items():
        if isinstance(v, bytes):
            v = v.decode("utf-8")
        if k in json_keys:
            v = json.loads(v)
        elif isinstance(v, np.ndarray) and v.dtype.kind in "OS":
            v = np.asarray([x.decode("utf-8") if isinstance(x, bytes)
                            else str(x) for x in v.reshape(-1)]
                           ).reshape(v.shape)
        out[k] = v
    return out


def _encoding_kwargs(encoding):
    kw = {}
    if not encoding:
        return kw
    if encoding.get("zlib"):
        kw["compression"] = "gzip"
        kw["compression_opts"] = int(encoding.get("complevel", 4))
    if encoding.get("shuffle"):
        kw["shuffle"] = True
    if encoding.get("chunksizes"):
        kw["chunks"] = tuple(encoding["chunksizes"])
    return kw


def _pack_floats(data, idt, encoding):
    """CF packed-data encoding: quantize a float array to ``idt``
    (int16/int32) with ``scale_factor``/``add_offset`` attrs, NaN/inf
    mapped to ``_FillValue`` (the integer minimum). The reference's CCF
    schema already reserves the attrs (``xcorr/core/init.py:126-127``
    placeholders scale_factor=1/add_offset=0); this realizes them.

    Auto-derived scale: ``max|data - add_offset| / (imax - 2)`` — one
    scale per variable per file (CF semantics). Quantization error is
    ``scale/2`` absolute; for normalized CCFs (|cc| <= 1) that is
    ~1.6e-5, the same order as the tunnel wire codec's per-row
    quantization (util/xfer.py)."""
    info = np.iinfo(idt)
    fill = idt.type(encoding.get("_FillValue", info.min))
    off = float(encoding.get("add_offset", 0.0))
    scale = encoding.get("scale_factor")
    finite = np.isfinite(data)
    if scale is None:
        m = float(np.max(np.abs(data[finite] - off))) if finite.any() \
            else 0.0
        scale = m / (info.max - 2) if m > 0 else 1.0
    scale = float(scale)
    q = np.round((data - off) / scale)
    q = np.where(finite, np.clip(q, info.min + 1, info.max), fill)
    attrs = {"scale_factor": np.float64(scale),
             "add_offset": np.float64(off), "_FillValue": fill}
    return q.astype(idt), attrs


def pack_roundtrip(data, encoding):
    """The exact value round trip a CF-packed variable undergoes through
    :func:`to_netcdf` + :func:`from_netcdf` (quantize -> decode to
    float32, non-finite -> NaN). ``write`` uses this to compute the
    full-data sha256 on what a reader of the packed file will actually
    see (the stored hash must match the reader's recomputed digest)."""
    idt = np.dtype(encoding["dtype"])
    q, attrs = _pack_floats(np.asarray(data), idt, encoding)
    out = (q.astype(np.float32) * np.float32(attrs["scale_factor"])
           + np.float32(attrs["add_offset"]))
    out[q == attrs["_FillValue"]] = np.nan
    return out


def to_netcdf(ds: Dataset, path, mode: str = "w", engine=None, **kw):
    """Persist a Dataset as a netCDF-4 flavored HDF5 file."""
    if ds.encoding.get("header_only"):
        raise ValueError(
            "refusing to write a header-only dataset: its large data "
            "variables are zero placeholders (re-read without "
            "header_only=True to persist)")
    with hdf5.File(path, mode) as f:
        _write_attrs(f, ds.attrs)
        dims = ds.dims
        # coordinate (dimension-scale) datasets first
        for name, coord in ds._coords.items():
            _write_var(f, name, coord, ds.encoding.get(name))
            if coord.dims == (name,):
                f[name].make_scale(name)
        # phony dims (no coordinate variable): store sizes for the reader
        phony = {d: s for d, s in dims.items() if d not in ds._coords}
        if phony:
            f.attrs["_xcorr_phony_dims"] = json.dumps(phony)
        for name, var in ds._vars.items():
            _write_var(f, name, var, ds.encoding.get(name))
            for i, d in enumerate(var.dims):
                if d in ds._coords and ds._coords[d].dims == (d,):
                    f[name].dims[i].attach_scale(f[d])
        coord_names = list(ds._coords)
        f.attrs["_xcorr_coordinates"] = json.dumps(coord_names)


def _write_var(f, name, var, encoding):
    data, extra = _encode_data(np.asarray(var.data))
    kw = _encoding_kwargs(encoding)
    pdt = (encoding or {}).get("dtype")
    if pdt is not None and np.issubdtype(np.dtype(pdt), np.integer) \
            and np.issubdtype(data.dtype, np.floating):
        data, pack_attrs = _pack_floats(data, np.dtype(pdt), encoding)
        extra = {**extra, **pack_attrs}
    if data.dtype == object:
        dset = f.create_dataset(name, shape=data.shape, dtype=_STR_DTYPE,
                                **kw)
        if data.size:
            dset[...] = data
    elif kw.get("compression") == "gzip" and data.size and \
            data.nbytes >= _PARALLEL_WRITE_MIN and \
            (os.cpu_count() or 1) > 1:
        chunks = kw.get("chunks") or _default_chunks(data.shape,
                                                     data.dtype)
        dset = f.create_dataset(
            name, shape=data.shape, dtype=data.dtype, chunks=chunks,
            compression="gzip",
            compression_opts=kw.get("compression_opts", 4),
            shuffle=kw.get("shuffle", False))
        _direct_chunk_write(dset, data, chunks,
                            kw.get("compression_opts", 4),
                            kw.get("shuffle", False))
    else:
        dset = f.create_dataset(name, data=data, **kw)
    _write_attrs(dset, {**var.attrs, **extra,
                        "_xcorr_dims": json.dumps(list(var.dims))})


# data variables above this element count are left undecoded by
# header-only reads (resume/status scans); coordinates always decode
_HEADER_ONLY_MAX_ELEMS = 65536


def from_netcdf(path, header_only: bool = False, **kw) -> Dataset:
    """Load a Dataset written by :func:`to_netcdf` (or a compatible
    netCDF-4 file using dimension scales).

    ``header_only`` skips DECOMPRESSING large data variables (>
    ``_HEADER_ONLY_MAX_ELEMS`` elements, e.g. the 1.6M-lag ``cc``
    payload) and substitutes zero placeholders of the decoded
    shape/dtype — every attribute/coordinate/encoding transform still
    runs, so metadata digests and ``status``-flag checks are identical
    to a full read at ~1% of the cost. The dataset is marked
    ``encoding["header_only"]`` and :func:`to_netcdf` refuses to
    persist it (placeholder payloads must never reach disk)."""
    ds = Dataset()
    with hdf5.File(path, "r") as f:
        ds.attrs = _read_attrs(f)
        coord_names = json.loads(ds.attrs.pop("_xcorr_coordinates", "[]"))
        ds.attrs.pop("_xcorr_phony_dims", None)
        for name in f.keys():
            dset = f[name]
            attrs = _read_attrs(dset)
            dims_json = attrs.pop("_xcorr_dims", None)
            if dims_json is not None:
                var_dims = tuple(json.loads(dims_json))
            else:  # foreign netCDF: use dimension scales / fallback names
                var_dims = tuple(
                    (dset.dims[i].keys()[0] if len(dset.dims[i]) else
                     f"phony_dim_{i}") for i in range(dset.ndim))
            # one is-coordinate predicate for BOTH the placeholder
            # decision and the ds._coords classification below — a
            # foreign file's large dimension-scale coordinate must
            # decode, not placeholder
            is_coord = name in coord_names or (dims_json is None and
                                               var_dims == (name,))
            if (header_only and not is_coord
                    and dset.size > _HEADER_ONLY_MAX_ELEMS):
                raw = np.zeros(dset.shape, dtype=dset.dtype)
            else:
                raw = dset[...]
            data = _decode_data(raw, attrs)
            # recover the storage encoding (zlib/shuffle/chunks) so a
            # read -> modify -> write resume round trip preserves the
            # file's compression instead of silently rewriting raw
            enc = {}
            if dset.compression == "gzip":
                enc = {"zlib": True,
                       "complevel": int(dset.compression_opts),
                       "shuffle": bool(dset.shuffle)}
            # CF packed data (integer storage + scale_factor/add_offset
            # attrs): decode to float32, _FillValue -> NaN; the packing
            # moves into ds.encoding[name] so round trips re-pack
            if np.issubdtype(data.dtype, np.integer) and \
                    ("scale_factor" in attrs or "add_offset" in attrs):
                fill = attrs.pop("_FillValue", None)
                scale = float(attrs.pop("scale_factor", 1.0))
                off = float(attrs.pop("add_offset", 0.0))
                mask = (data == fill) if fill is not None else None
                # carry dtype (so round trips re-pack) but NOT the
                # scale: the next write re-derives it from the updated
                # data — a resume adding larger-amplitude windows must
                # not clip against the old file's max
                enc["dtype"] = str(data.dtype)
                if fill is not None:
                    enc["_FillValue"] = int(fill)
                data = (data.astype(np.float32) * np.float32(scale)
                        + np.float32(off))
                if mask is not None:
                    data[mask] = np.nan
            if enc:
                ds.encoding[name] = enc
            attrs.pop("_xcorr_dtype", None)
            if attrs.get("units") == "nanoseconds since 1970-01-01":
                attrs.pop("units")
                attrs.pop("calendar", None)
            elif attrs.get("units") == "nanoseconds" and \
                    np.issubdtype(data.dtype, np.timedelta64):
                attrs.pop("units")
            da = DataArray(data, dims=var_dims, name=name, attrs=attrs)
            if is_coord:
                ds._coords[name] = da
            else:
                ds._vars[name] = da
    ds.encoding["source"] = str(path)
    if header_only:
        ds.encoding["header_only"] = True
    return ds
