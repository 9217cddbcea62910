# Carried from xcorr_tpu/stream/sds.py (see test_torch_host_copies).
r"""
:mod:`stream.sds` -- SDS day-file archive
=========================================

SeisComP Data Structure archive access: one file per
(net, sta, loc, cha, day) under ``root/YEAR/NET/STA/CHA.D/``
(reference: ``obspy.clients.filesystem.sds`` used by
``xcorr/stream/client.py:560-651`` and the writer ``to_SDS``,
``xcorr/stream/to_SDS.py:35-251``).

Day files are stored as HDF5 (samples + stats attrs) or miniSEED (decoded
by the native C++ codec, :mod:`xcorr_tpu_torch.native`); the format is
sniffed from the file's magic bytes on read. A process decodes each day
file once while it is unchanged (:mod:`._daycache`).
"""

from __future__ import annotations

import os
from glob import glob

from . import _daycache
from .trace import Stream, Stats, Trace, UTCDateTime

__all__ = ["SDSArchive", "sds_path", "to_SDS"]

_HDF5_MAGIC = b"\x89HDF"


from contextlib import contextmanager


@contextmanager
def _day_lock(path, exclusive: bool):
    """fcntl flock on ``path + ".lock"``: exclusive for writers, shared
    for readers. flock is tied to the open file description, so every
    ``open`` here contends correctly across processes AND across
    threads of one process (a reader must never see a day file
    mid-write — h5py/mseed writes are not atomic)."""
    import fcntl
    try:
        lockf = open(path + ".lock", "a")
    except OSError:
        if exclusive:
            raise  # a writer that cannot lock must not proceed
        # read-only archive (EROFS/EACCES): nobody can be writing it
        # either, so lock-free reads are safe — don't require write
        # access just to read curated archives
        yield
        return
    with lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def sds_path(root, net, sta, loc, cha, time, sds_type="D"):
    """Canonical SDS day-file path (no extension, SDS convention)."""
    t = UTCDateTime(time)
    fname = f"{net}.{sta}.{loc}.{cha}.{sds_type}.{t.year}.{t.julday:03d}"
    return os.path.join(root, f"{t.year:04d}", net, sta,
                        f"{cha}.{sds_type}", fname)


class SDSArchive:
    """Read/write SDS day files."""

    def __init__(self, root: str, sds_type: str = "D", format: str = "h5"):
        self.root = root
        self.sds_type = sds_type
        self.format = format

    def path(self, net, sta, loc, cha, time):
        return sds_path(self.root, net, sta, loc, cha, time, self.sds_type)

    def read(self, seed_id: str, time) -> Stream:
        """Read the day file covering ``time`` for ``seed_id``
        (wildcards allowed via glob). Reads take the day file's SHARED
        lock: a prefetch thread must never observe a half-written file
        (writers hold the exclusive lock; fcntl flock contends between
        threads of one process too — each ``open`` is its own file
        description)."""
        net, sta, loc, cha = seed_id.split(".")
        pattern = self.path(net, sta, loc, cha, time)
        traces = []
        for path in sorted(glob(pattern)):
            with _day_lock(path, exclusive=False):
                traces.extend(read_dayfile(path))
        return Stream(traces)

    def coverage(self, seed_id: str, time) -> list:
        """Header-only coverage of the day file(s) covering ``time``:
        ``[(seed_id, starttime_epoch_s, npts, sampling_rate), ...]``
        without decoding sample payloads — miniSEED files cost a
        64-byte-per-record header walk (native ``xcm_scan``), HDF5 day
        files an attribute read. Availability scans of long archives
        then skip the full Steim decode per (receiver, day)."""
        net, sta, loc, cha = seed_id.split(".")
        pattern = self.path(net, sta, loc, cha, time)
        segs = []
        for path in sorted(glob(pattern)):
            with _day_lock(path, exclusive=False):
                segs.extend(scan_dayfile(path))
        return segs

    def write(self, stream: Stream, verb: int = 0):
        """Write each trace into its day slot.

        Concurrent writers to the same day file are serialized with an
        fcntl advisory lock — the host-side analogue of the reference's
        per-SEED-id ``distributed.Lock`` (``xcorr/stream/client.py:
        321-323``; unlocked parallel SDS access corrupts files there).
        """
        for tr in stream:
            s = tr.stats
            path = self.path(s.network, s.station, s.location, s.channel,
                             s.starttime)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with _day_lock(path, exclusive=True):
                if self.format == "mseed":
                    from ..native.mseed import write_mseed
                    write_mseed(path, tr)
                else:
                    write_dayfile_h5(path, tr)
                _daycache.DAYS.invalidate(path)
            if verb > 0:
                print(f"SDS write: {path}")


def read_dayfile(path) -> list:
    """Read one SDS day file: decoded once per process while it is
    unchanged, the Traces the caller's own copies."""
    return _daycache.DAYS.read(path, _decode_dayfile)


def _decode_dayfile(path) -> list:
    """Decode one SDS day file, sniffing HDF5 vs miniSEED."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _HDF5_MAGIC:
        return _read_dayfile_h5(path)
    from ..native.mseed import read_mseed
    return read_mseed(path)


def scan_dayfile(path) -> list:
    """Header-only coverage of one SDS day file: ``(seed_id,
    starttime_epoch_s, npts, sampling_rate)`` per segment, no sample
    decode (see :meth:`SDSArchive.coverage`)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _HDF5_MAGIC:
        from ..io import hdf5

        def _s(v):
            # fixed-length HDF5 strings round-trip as bytes
            return v.decode() if isinstance(v, bytes) else str(v)

        segs = []
        with hdf5.File(path, "r") as f:
            for name in f:
                a = f[name].attrs
                seed_id = ".".join([
                    _s(a.get("network", "")), _s(a.get("station", "")),
                    _s(a.get("location", "")), _s(a.get("channel", ""))])
                segs.append((seed_id, float(int(a["starttime_ns"]) / 1e9),
                             int(a["npts"]), float(a["sampling_rate"])))
        return segs
    from ..native.mseed import scan_mseed
    return scan_mseed(path)


def _read_dayfile_h5(path):
    from ..io import hdf5
    traces = []
    with hdf5.File(path, "r") as f:
        for name in f:
            dset = f[name]
            stats = Stats({
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in dset.attrs.items()})
            stats.starttime = UTCDateTime(int(dset.attrs["starttime_ns"])
                                          / 1e9)
            traces.append(Trace(dset[...], stats))
    return traces


def write_dayfile_h5(path, trace: Trace):
    from ..io import hdf5
    with hdf5.File(path, "a") as f:
        name = f"{trace.id}.{trace.stats.starttime.ns}"
        if name in f:
            del f[name]
        dset = f.create_dataset(name, data=trace.data,
                                compression="gzip", compression_opts=4,
                                shuffle=True)
        s = trace.stats
        dset.attrs.update({
            "network": s.network, "station": s.station,
            "location": s.location, "channel": s.channel,
            "sampling_rate": float(s.sampling_rate),
            "npts": int(s.npts),
            "starttime_ns": int(s.starttime.ns),
        })


def to_SDS(stream: Stream, sds_path_root: str, extra_samples: int = 0,
           method: str = "overwrite", verb: int = 0, **kwargs):
    """Write streams into the SDS tree, day-sliced with ``extra_samples``
    overlap (reference ``xcorr/stream/to_SDS.py:30-97`` semantics)."""
    archive = SDSArchive(sds_path_root)
    for tr in stream:
        fs = tr.stats.sampling_rate
        t0 = tr.stats.starttime
        t1 = tr.stats.endtime
        # day boundaries covered by the trace
        import pandas as pd
        day0 = pd.Timestamp(t0.ns).normalize()
        day1 = pd.Timestamp(t1.ns).normalize()
        for day in pd.date_range(day0, day1, freq="1D"):
            d0 = UTCDateTime(day)
            d1 = d0 + 86400.0 + extra_samples / fs
            piece = tr.slice(d0, d1 - 1.0 / fs)
            if piece.stats.npts == 0:
                continue
            archive.write(Stream([piece]), verb=verb)
    return True
