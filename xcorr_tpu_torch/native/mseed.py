# Carried from xcorr_tpu/native/mseed.py (see test_torch_host_copies).
r"""
:mod:`native.mseed` -- ctypes bindings for the miniSEED codec
=============================================================

Python interface to ``libxcmseed.so`` (see ``mseed.cpp``): read miniSEED
files/buffers into :class:`xcorr_tpu.stream.Trace` objects and write
Steim1-compressed records. Builds the shared library on first use when the
compiled artifact is missing (g++ is part of the toolchain).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["read_mseed", "read_mseed_bytes", "write_mseed", "encode_mseed",
           "scan_mseed", "scan_mseed_bytes", "available"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_lib = None


class _Segment(ctypes.Structure):
    _fields_ = [
        ("network", ctypes.c_char * 3),
        ("station", ctypes.c_char * 6),
        ("location", ctypes.c_char * 3),
        ("channel", ctypes.c_char * 4),
        ("starttime", ctypes.c_double),
        ("sampling_rate", ctypes.c_double),
        ("npts", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("samples", ctypes.c_void_p),
    ]


def _build():
    """Path of the shared library, built on first use with ``g++`` and
    the flags of ``xcorr_tpu/native/Makefile`` into the port's build
    directory (``ops._build.build_dir()``, git-ignored), never into the
    package; the name carries a hash of ``mseed.cpp``, so an edited
    source rebuilds."""
    import hashlib
    import threading
    from ..ops._build import build_dir
    src = os.path.join(_DIR, "mseed.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = build_dir() / f"libxcmseed-{tag}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}"
        subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-Wall",
                        "-fPIC", "-std=c++17", "-shared", "-o", tmp, src],
                       check=True)
        os.replace(tmp, path)
    return str(path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.xcm_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(_Segment))]
    lib.xcm_decode.restype = ctypes.c_int
    lib.xcm_free.argtypes = [ctypes.POINTER(_Segment), ctypes.c_int]
    lib.xcm_free.restype = None
    lib.xcm_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(_Segment))]
    lib.xcm_scan.restype = ctypes.c_int
    lib.xcm_encode_steim1.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.xcm_encode_steim1.restype = ctypes.c_int64
    lib.xcm_free_bytes.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.xcm_free_bytes.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native codec can be loaded/built."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def read_mseed_bytes(payload: bytes):
    """Decode a miniSEED buffer into a list of Traces (merged per id where
    contiguous)."""
    from ..stream.trace import Stats, Trace

    lib = _load()
    segs = ctypes.POINTER(_Segment)()
    n = lib.xcm_decode(payload, len(payload), ctypes.byref(segs))
    traces = []
    try:
        for i in range(n):
            s = segs[i]
            npdtype = {0: np.int32, 1: np.float32, 2: np.float64}[s.dtype]
            buf = ctypes.cast(
                s.samples,
                ctypes.POINTER(ctypes.c_uint8 * (
                    s.npts * np.dtype(npdtype).itemsize)))
            data = np.frombuffer(bytes(buf.contents),
                                 dtype=npdtype).copy()
            stats = Stats(
                network=s.network.decode().strip(),
                station=s.station.decode().strip(),
                location=s.location.decode().strip(),
                channel=s.channel.decode().strip(),
                starttime=float(s.starttime),
                sampling_rate=float(s.sampling_rate),
            )
            traces.append(Trace(data, stats))
    finally:
        lib.xcm_free(segs, n)
    return _merge_contiguous(traces)


def _merge_contiguous(traces):
    """Join record-level segments that are exactly contiguous.

    One ``np.concatenate`` per contiguous RUN, not per record — the
    per-record append was quadratic over a day file's ~27k records
    (measured 23 s for a 4.3M-sample Steim1 day on one core; batched:
    the decode itself dominates again)."""
    out = []
    run = []  # buffered record data of the current contiguous run

    def flush():
        if not run:
            return
        head = out[-1]
        head.data = run[0] if len(run) == 1 else np.concatenate(run)
        head.stats.npts = head.data.size
        run.clear()

    for tr in traces:
        if out:
            prev = out[-1]
            # prev.stats.npts tracks the buffered run via the running
            # sample count; endtime derives from it
            dt = tr.stats.starttime - prev.stats.endtime
            if (prev.id == tr.id
                    and prev.stats.sampling_rate == tr.stats.sampling_rate
                    and abs(dt - 1.0 / tr.stats.sampling_rate) < 1e-4):
                run.append(tr.data)
                prev.stats.npts += tr.data.size
                continue
        flush()
        out.append(tr)
        run.append(tr.data)
    flush()
    return out


def read_mseed(path: str):
    """Decode a miniSEED file into Traces."""
    with open(path, "rb") as f:
        return read_mseed_bytes(f.read())


def scan_mseed_bytes(payload: bytes):
    """Header-only coverage scan of a miniSEED buffer.

    Returns ``[(seed_id, starttime_epoch_s, npts, sampling_rate), ...]``
    per record WITHOUT decoding any payload — the native walk touches
    only the 64-byte fixed headers + blockette 1000, so scanning a
    compressed day file costs ~1% of a full decode. npts is the
    header's sample count: a corrupt payload can still decode short, so
    treat coverage as advisory (availability flags, not data).
    """
    lib = _load()
    segs = ctypes.POINTER(_Segment)()
    n = lib.xcm_scan(payload, len(payload), ctypes.byref(segs))
    out = []
    try:
        for i in range(n):
            s = segs[i]
            seed_id = ".".join([
                s.network.decode().strip(), s.station.decode().strip(),
                s.location.decode().strip(), s.channel.decode().strip()])
            out.append((seed_id, float(s.starttime), int(s.npts),
                        float(s.sampling_rate)))
    finally:
        lib.xcm_free(segs, n)
    return out


def scan_mseed(path: str):
    """Header-only coverage scan of a miniSEED file (see
    :func:`scan_mseed_bytes`)."""
    with open(path, "rb") as f:
        return scan_mseed_bytes(f.read())


def encode_mseed(trace, reclen: int = 512) -> bytes:
    """Encode one Trace as big-endian Steim1 miniSEED records."""
    lib = _load()
    data = np.ascontiguousarray(np.round(trace.data).astype(np.int32)) \
        if trace.data.dtype.kind in "fi" else None
    if data is None:
        raise TypeError("only numeric traces can be Steim1-encoded")
    s = trace.stats
    out = ctypes.POINTER(ctypes.c_uint8)()
    nbytes = lib.xcm_encode_steim1(
        s.network.encode(), s.station.encode(), s.location.encode(),
        s.channel.encode(), float(s.starttime.timestamp),
        float(s.sampling_rate),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(data.size), reclen, ctypes.byref(out))
    if nbytes < 0:
        raise RuntimeError(f"mseed encode failed ({nbytes})")
    try:
        return bytes(bytearray(ctypes.cast(
            out, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents))
    finally:
        lib.xcm_free_bytes(out)


def write_mseed(path: str, trace, reclen: int = 512):
    """Write one Trace as a miniSEED file (int32 Steim1)."""
    payload = encode_mseed(trace, reclen=reclen)
    with open(path, "wb") as f:
        f.write(payload)
    return path
