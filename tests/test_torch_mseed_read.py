"""The port's miniSEED read path against the JAX package on the CPU.

``xcorr_tpu_torch.native.mseed.read_mseed_bytes`` joins a buffer's records
into one array per contiguous run inside the library; it must give the
Traces of ``xcorr_tpu.native.mseed.read_mseed_bytes`` (one Trace per
record, joined in Python) bit for bit: order, ids, start nanoseconds,
sampling rate, npts, dtype, samples and the Stats' keys. So must the
port's own per-record plain version, and ``SDSArchive.read`` through the
port's day-file cache, whose single flight, invalidation, byte bound and
copies are checked here too. The encoder gives the JAX package's bytes.

Records are built with ``struct`` (every encoding the decoder reads, both
byte orders, 512- and 4096-byte records, start times to the header's
1e-4 s tick) or by the codec's own Steim1 encoder; all data comes from
seeded numpy generators.
"""
import datetime as dt
import os
import struct
import sys
import threading
import time
import types

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu.native import mseed as jm
from xcorr_tpu.stream import sds as jsds
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.stream import _daycache
from xcorr_tpu_torch.stream import sds as tsds

TICK = 10_000                      # header ticks per second (1e-4 s)
T0 = 13_886_208_000_000            # 2014-01-02T00:00:00 in ticks
DAY = "2014-01-02"
SDS_ID = ("XX", "STA", "", "HHZ")


# ------------------------------------------------------------- records


def _btime(ticks, bo):
    t = dt.datetime(1970, 1, 1) + dt.timedelta(seconds=ticks // TICK)
    return struct.pack(bo + "HHBBBBH", t.year, t.timetuple().tm_yday,
                       t.hour, t.minute, t.second, 0, ticks % TICK)


def _steim(x, level, bo, nframes):
    """Steim1/2 frames of ``x`` (int32): the densest of the encoder's
    word forms that fits, no compression search."""
    d = np.diff(np.concatenate([[x[0]], x])).astype(np.int64)
    forms = ([(4, 8, 1, None), (2, 16, 2, None), (1, 32, 3, None)]
             if level == 1 else
             [(7, 4, 3, 2), (3, 10, 2, 3), (1, 30, 2, 1)])
    words, i = [], 0
    while i < len(d):
        for k, bits, c, dnib in forms:
            chunk = list(d[i:i + k]) + [0] * (k - len(d[i:i + k]))
            lim = 1 << (bits - 1)
            if all(-lim <= v < lim for v in chunk):
                break
        if level == 1:
            fmt = {8: "b", 16: "h", 32: "i"}[bits]
            word = struct.pack(bo + fmt * k, *chunk)
        else:
            v = dnib << 30
            for j, val in enumerate(chunk):
                v |= (val & ((1 << bits) - 1)) << (bits * (k - 1 - j))
            word = struct.pack(bo + "I", v)
        words.append((c, word))
        i += k
    out = b""
    for f in range(nframes):
        slots = 13 if f == 0 else 15
        ws, words = words[:slots], words[slots:]
        ctrl = 0
        body = b""
        if f == 0:
            body = struct.pack(bo + "ii", x[0], x[-1])
        for w, (c, word) in enumerate(ws, start=3 if f == 0 else 1):
            ctrl |= c << (2 * (15 - w))
            body += word
        out += struct.pack(bo + "I", ctrl) + body
        out += b"\0" * (64 - len(out) % 64) if len(out) % 64 else b""
    assert not words, "samples do not fit the record"
    return out


def record(x, ticks, fs=(250, 1), enc=3, reclen=512, bo=">", data_bo=None,
           sid=("IM", "H03S1", "", "EDH"), timecorr=0, nsamp=None):
    """One miniSEED record of samples ``x`` starting at ``ticks``;
    ``fs`` the header's (factor, multiplier), ``enc`` its encoding (1
    int16, 3 int32, 4 float32, 5 float64, 10 Steim1, 11 Steim2)."""
    data_bo = data_bo or bo
    net, sta, loc, cha = (f.encode() if isinstance(f, str) else f
                          for f in sid)
    hdr = (b"000001D " + sta.ljust(5)[:5] + loc.ljust(2)[:2]
           + cha.ljust(3)[:3] + net.ljust(2)[:2] + _btime(ticks, bo)
           + struct.pack(bo + "Hhh", len(x) if nsamp is None else nsamp,
                         *fs)
           + struct.pack(bo + "BBBBiHH", 0, 0, 0, 1, timecorr, 64, 48)
           + struct.pack(bo + "HHBBBB", 1000, 0, enc,
                         1 if data_bo == ">" else 0,
                         reclen.bit_length() - 1, 0))
    hdr += b"\0" * (64 - len(hdr))
    if enc in (10, 11):
        body = _steim(np.asarray(x, np.int32), enc - 9, data_bo,
                      (reclen - 64) // 64)
    else:
        fmt = {1: "h", 3: "i", 4: "f", 5: "d"}[enc]
        body = struct.pack(f"{data_bo}{len(x)}{fmt}", *x)
    assert len(body) <= reclen - 64
    return hdr + body + b"\0" * (reclen - 64 - len(body))


def _ints(rng, n, scale=1000):
    return np.round(scale * rng.standard_normal(n)).astype(np.int32)


def _trace(pkg, data, start, fs=250.0, sid=("IM", "H03S1", "", "EDH")):
    net, sta, loc, cha = sid
    return pkg.stream.Trace(data, pkg.stream.Stats(
        network=net, station=sta, location=loc, channel=cha,
        starttime=start, sampling_rate=fs))


def _steim1(data, start, fs=250.0, reclen=512, sid=None):
    """The port's encoder on one trace (its bytes are the JAX package's:
    ``test_encode_mseed_matches_reference``)."""
    return tm.encode_mseed(_trace(xcorr_tpu_torch, data, start, fs,
                                  sid or ("IM", "H03S1", "", "EDH")),
                           reclen=reclen)


# ---------------------------------------------------------------- files


def _pieces(rng):
    """One trace encoded in pieces of uneven length, as a writer that
    appends its buffers leaves a day file."""
    x = _ints(rng, 30_000)
    cuts = [0, 411, 5000, 5001, 17_333, 30_000]
    return b"".join(_steim1(x[a:b], 1388620800.0 + a / 250.0)
                    for a, b in zip(cuts, cuts[1:]))


def _gaps(rng):
    starts = [0.0, 30.0, 30.0 + 2000 / 250.0 + 0.5, 100.0]
    return b"".join(_steim1(_ints(rng, 2000), 1388620800.0 + s)
                    for s in starts)


def _overlaps(rng):
    starts = [0.0, 6.0, 7.996, 30.0, 29.0]
    return b"".join(_steim1(_ints(rng, 2000), 1388620800.0 + s)
                    for s in starts)


def _interleaved(rng):
    """Records of three ids, one after another in turns, and ids equal
    only once stripped or joined: 'ABC' beside 'ABC  ' and 'ABC\\0\\0', and
    network 'A.' station 'B' beside network 'A' station '.B' (both
    'A..B..HHZ')."""
    a = _steim1(_ints(rng, 4000), 1388620800.0)
    b = _steim1(_ints(rng, 4000), 1388620800.0,
                sid=("IM", "H03S2", "", "EDH"))
    c = _steim1(_ints(rng, 4000), 1388620800.0,
                sid=("IM", "H03S3", "", "EDH"))
    recs = [p[i:i + 512] for i in range(0, len(a), 512) for p in (a, b, c)]
    out = b"".join(recs[:20]) + b"".join(recs[20::3]) + b"".join(
        recs[21::3])
    x = _ints(rng, 40)
    for k, sid in enumerate([("IM", b"ABC  ", "", "HHZ"),
                             ("IM", b"ABC\0\0", "", "HHZ"),
                             ("IM", b"ABC", "", "HHZ"),
                             ("A.", "B", "", "HHZ"),
                             ("A", ".B", "", "HHZ")]):
        out += record(x[8 * k:8 * k + 8], T0 + 320 * k, sid=sid)
    return out


def _rate_change(rng):
    x = _ints(rng, 300)
    return (record(x[:100], T0, fs=(250, 1))
            + record(x[100:200], T0 + 4000, fs=(200, 1))
            + record(x[200:], T0 + 9000, fs=(200, 1)))


#: sampling rates as (factor, multiplier): 250, 200, 40 and 3 Hz, 1/3 Hz
#: and 0.1 Hz, whose periods fall on, beside and between header ticks
RATES = [(250, 1), (200, 1), (40, 1), (3, 1), (1, -3), (-10, 1)]


def _rate(fact, mult):
    """The header's rate as the decoder forms it."""
    r = float(fact) if fact > 0 else -1.0 / fact
    return r * mult if mult > 0 else r / -mult


def _tolerance(rng, offsets=(-2, -1, 0, 1, 2)):
    """Records whose start lies 0, 1 or 2 ticks (1e-4 s) off the open
    run's end plus one period, at each rate: the 1e-4 s tolerance decided
    by the float arithmetic on both sides of it."""
    out = b""
    for fact, mult in RATES:
        ticks, n = T0, 0
        for _ in range(12):
            k = int(rng.integers(3, 9))
            out += record(_ints(rng, k), ticks, fs=(fact, mult))
            n += k
            ticks = (T0 + round(n / _rate(fact, mult) * TICK)
                     + int(rng.choice(offsets)))
    return out


def _encodings(rng):
    """Every encoding the decoder reads, both byte orders, big- and
    little-endian headers; contiguous, so runs mix dtypes (int32 with
    float32 or float64 promotes to float64, as ``np.concatenate``)."""
    ints = _ints(rng, 50)
    f32 = rng.standard_normal(50).astype(np.float32)
    f64 = rng.standard_normal(50)
    big = _ints(rng, 50, scale=2e8)
    runs = [
        # integers only: an int32 run
        [(11, big, ">", ">"), (11, ints, "<", "<"), (10, big, ">", "<"),
         (1, ints, ">", ">"), (3, ints, "<", ">"), (3, big, ">", ">")],
        # integers and floats: float64
        [(3, ints, ">", ">"), (4, f32, ">", ">"), (4, f32, "<", "<"),
         (5, f64, ">", "<"), (3, ints, ">", ">"), (11, big, ">", ">")],
        [(4, f32, ">", ">"), (5, f64, "<", ">")],
        # floats alone keep their width
        [(4, f32, ">", ">"), (4, f32, "<", ">")],
        [(5, f64, ">", ">"), (5, f64, ">", "<")],
    ]
    out, ticks = b"", T0
    for run in runs:
        for enc, x, bo, dbo in run:
            out += record(x, ticks, enc=enc, bo=bo, data_bo=dbo)
            ticks += len(x) * 40
        ticks += 10 * TICK
    return out


def _reclen_4096(rng):
    x = _ints(rng, 20_000, scale=2e6)
    return (_steim1(x, 1388620800.0, reclen=4096)
            + record(_ints(rng, 900), T0 + 20_000 * 40, enc=3, reclen=4096)
            + record(_ints(rng, 1500, scale=100), T0 + 20_900 * 40,
                     enc=11, reclen=4096))


def _degenerate(rng):
    """A Steim record whose frames hold no difference (npts 0), within a
    run, after one and before one; a time correction not yet applied; a
    header counting more samples than its record holds; an id with a NUL
    inside a field."""
    x = _ints(rng, 16)
    empty = bytearray(record(x[:4], T0 + 400, enc=10))
    empty[64:512] = b"\0" * 448
    return (record(x[:10], T0) + bytes(empty)
            + record(x[10:], T0 + 400) + record(x, T0 + 4000, timecorr=40)
            + record(x, T0 + 4600) + record(x, T0 + 8000, nsamp=300)
            + record(x, T0 + 9000, enc=1, nsamp=1000)
            + record(x, T0 + 9000, sid=("IM", b"H0\0S1", "", "EDH")))


def _cut_short(rng):
    return _steim1(_ints(rng, 5000), 1388620800.0)[:-700]


def _cut_in_header(rng):
    return _steim1(_ints(rng, 5000), 1388620800.0)[:5 * 512 + 30]


def _not_mseed(rng):
    return b"<?xml version='1.0'?>" + rng.bytes(4000)


def _empty(rng):
    return b""


def _zero_rate(rng):
    """A record at 0 Hz after another of its id: Python's merge divides by
    the rate, so both paths raise ZeroDivisionError."""
    x = _ints(rng, 10)
    return record(x, T0, fs=(0, 1)) + record(x, T0 + 400, fs=(0, 1))


FILES = {f.__name__.lstrip("_"): f for f in (
    _pieces, _gaps, _overlaps, _interleaved, _rate_change, _tolerance,
    _encodings, _reclen_4096, _degenerate, _cut_short, _cut_in_header,
    _not_mseed, _empty)}


def _payload(name):
    return FILES[name](np.random.default_rng(sorted(FILES).index(name)))


def assert_same(got, want):
    """Equal Traces: order, ids, starttime ns, sampling rate, npts, dtype,
    samples bit for bit, and the Stats' keys in order."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.id == w.id
        assert g.stats.starttime.ns == w.stats.starttime.ns
        assert type(g.stats.sampling_rate) is type(w.stats.sampling_rate)
        assert g.stats.sampling_rate == w.stats.sampling_rate
        assert g.stats.npts == w.stats.npts == g.data.size
        assert g.data.dtype == w.data.dtype
        assert g.data.tobytes() == w.data.tobytes()
        assert list(g.stats) == list(w.stats)
        assert {k: v for k, v in g.stats.items() if k != "starttime"} == \
            {k: v for k, v in w.stats.items() if k != "starttime"}


@pytest.fixture(autouse=True)
def fresh_cache():
    _daycache.DAYS.clear()
    yield
    _daycache.DAYS.clear()


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_mseed_bytes_matches_reference(name):
    payload = _payload(name)
    want = jm.read_mseed_bytes(payload)
    assert_same(tm.read_mseed_bytes(payload), want)
    assert_same(tm._read_mseed_bytes_plain(payload), want)


def test_the_matrix_reaches_its_cases():
    """The files are what their names say: many runs, mixed dtypes, the
    tolerance decided both ways at each rate."""
    runs = {n: tm.read_mseed_bytes(_payload(n)) for n in FILES}
    assert [len(runs[n]) for n in ("pieces", "gaps", "overlaps")] == \
        [1, 4, 5]
    assert len(runs["interleaved"]) > 20
    assert {tr.id for tr in runs["interleaved"]} >= {"IM.ABC..HHZ",
                                                     "A..B..HHZ"}
    assert [tr.stats.sampling_rate for tr in runs["rate_change"]] == \
        [250.0, 200.0]
    assert {tr.data.dtype.name for tr in runs["encodings"]} == \
        {"int32", "float32", "float64"}
    per_rate = {}
    for tr in runs["tolerance"]:
        per_rate.setdefault(tr.stats.sampling_rate, []).append(tr)
    assert len(per_rate) == len(RATES)
    assert all(1 < len(v) < 12 for v in per_rate.values()), \
        {k: len(v) for k, v in per_rate.items()}
    assert runs["not_mseed"] == runs["empty"] == []
    assert sum(tr.stats.npts for tr in runs["cut_short"]) < 5000


def test_zero_rate_raises_as_the_reference():
    payload = _zero_rate(np.random.default_rng(0))
    for read in (jm.read_mseed_bytes, tm.read_mseed_bytes,
                 tm._read_mseed_bytes_plain):
        with pytest.raises(ZeroDivisionError):
            read(payload)


def _write_day(root, payload):
    path = tsds.sds_path(str(root), *SDS_ID, DAY)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)
    return path


@pytest.mark.parametrize("name", sorted(FILES))
def test_sds_read_matches_reference(tmp_path, name):
    """``SDSArchive.read`` of the file as a day file: the decode, then a
    copy from the cache, each equal to the JAX package's read."""
    _write_day(tmp_path, _payload(name))
    sid, when = ".".join(SDS_ID), DAY + "T12:00"
    want = jsds.SDSArchive(str(tmp_path)).read(sid, when)
    for _ in range(2):
        got = tsds.SDSArchive(str(tmp_path)).read(sid, when)
        assert type(got) is xcorr_tpu_torch.stream.Stream
        assert_same(got.traces, want.traces)


def test_whole_day_encodes_and_reads(tmp_path):
    """A 250 Hz day, 21.6 M samples: one encode call (linear, so it
    ends), read back whole to its samples, equal to the JAX package's
    read of the same bytes and of the same SDS day file."""
    rng = np.random.default_rng(7)
    x = _ints(rng, 21_600_000)
    x[::1000] += 1 << 24               # 32-bit differences too
    t0 = time.perf_counter()
    payload = _steim1(x, 1388620800.0)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = tm.read_mseed_bytes(payload)
    read_s = time.perf_counter() - t0
    print(f"250 Hz day: encode {enc_s:.3f} s, {len(payload)} bytes; "
          f"read {read_s:.3f} s")
    assert len(got) == 1 and got[0].data.dtype == np.int32
    np.testing.assert_array_equal(got[0].data, x)
    assert got[0].stats.starttime.ns == 1388620800 * 10**9
    assert_same(got, jm.read_mseed_bytes(payload))
    _write_day(tmp_path, payload)
    sid, when = ".".join(SDS_ID), DAY + "T12:00"
    assert_same(tsds.SDSArchive(str(tmp_path)).read(sid, when).traces,
                jsds.SDSArchive(str(tmp_path)).read(sid, when).traces)


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("n,reclen,kind", [
    (1, 512, "noise"), (7, 512, "noise"), (412, 512, "flat"),
    (413, 512, "flat"), (419, 512, "steps"), (420, 512, "steps"),
    (421, 512, "steps"), (3772, 4096, "flat"), (100_000, 512, "noise"),
    (100_000, 4096, "steps"), (400_000, 512, "noise"),
    (400_000, 512, "float"), (250_000, 256, "steps")])
def test_encode_mseed_matches_reference(n, reclen, kind):
    """Byte-equal Steim1 records from both encoders: records filled to
    their last word (flat data packs four samples a word), 8-, 16- and
    32-bit differences, float data rounded, 256- to 4096-byte records."""
    rng = np.random.default_rng(n + reclen)
    if kind == "flat":
        x = np.full(n, 17, np.int32)
    elif kind == "steps":
        x = _ints(rng, n, scale=30)
        x[::5] += rng.integers(-(1 << 30), 1 << 30, x[::5].size,
                               dtype=np.int32)
    elif kind == "float":
        x = 1e3 * rng.standard_normal(n)
    else:
        x = _ints(rng, n)
        x[::97] += 1_000_000
    start = "2014-01-02T03:04:05.1234"
    got = tm.encode_mseed(_trace(xcorr_tpu_torch, x, start, 40.0),
                          reclen=reclen)
    assert got == jm.encode_mseed(_trace(xcorr_tpu, x, start, 40.0),
                                  reclen=reclen)
    back = tm.read_mseed_bytes(got)
    np.testing.assert_array_equal(back[0].data, np.round(x).astype(np.int32))


# ------------------------------------------------------------------ cache


def _two_days(root):
    """Two day files of one station, written through the archive."""
    rng = np.random.default_rng(11)
    archive = tsds.SDSArchive(str(root), format="mseed")
    for day in ("2014-01-02", "2014-01-03"):
        archive.write(xcorr_tpu_torch.stream.Stream([_trace(
            xcorr_tpu_torch, _ints(rng, 50_000), day, fs=5.0)]))
    return archive, "IM.H03S1..EDH"


def test_concurrent_readers_decode_each_file_once(tmp_path, monkeypatch):
    """16 threads (8 per day file, more than this machine's cores) with a
    short switch interval: each file is decoded once, and every reader
    gets the file's samples in arrays of its own."""
    archive, sid = _two_days(tmp_path)
    decodes = []
    real = tsds._decode_dayfile

    def slow_decode(path):
        decodes.append(path)
        time.sleep(0.05)
        return real(path)

    monkeypatch.setattr(tsds, "_decode_dayfile", slow_decode)
    days = ["2014-01-02T06:00", "2014-01-03T06:00"] * 8
    gate = threading.Barrier(len(days))
    got = [None] * len(days)

    def reader(i):
        gate.wait(timeout=30)
        got[i] = archive.read(sid, days[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(len(days))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(decodes) == sorted(set(decodes)) and len(decodes) == 2
    for i, st in enumerate(got):
        assert_same(st.traces, got[i % 2].traces)
        assert len(st) == 1 and st[0].stats.npts == 50_000
    arrays = [st[0].data for st in got]
    assert len({id(a) for a in arrays}) == len(arrays)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays)
                   for b in arrays[i + 1:])


def test_mutated_trace_leaves_the_next_read_unchanged(tmp_path):
    """Both the decoding read and a cached one hand out Traces whose
    samples and stats a caller may change in place."""
    archive, sid = _two_days(tmp_path)
    decoded = archive.read(sid, "2014-01-02T06:00")
    cached = archive.read(sid, "2014-01-02T06:00")
    want = decoded[0].data.copy()
    for st in (decoded, cached):
        st[0].data[:] = -1
        st[0].data += 3
        st[0].stats.starttime += 100.0
        st[0].stats.network = "ZZ"
    again = archive.read(sid, "2014-01-02T06:00")
    np.testing.assert_array_equal(again[0].data, want)
    assert again[0].id == "IM.H03S1..EDH"
    assert again[0].stats.starttime.ns == \
        pd.Timestamp("2014-01-02").value


def test_rewrite_through_the_archive_is_seen(tmp_path, monkeypatch):
    """The same path, inode and size, written again within the file
    system's time granularity: the write drops the cached decode."""
    archive, sid = _two_days(tmp_path)
    before = archive.read(sid, "2014-01-02T06:00")
    data = before[0].data[::-1].copy()
    # a stat that cannot tell the files apart: only the write's
    # invalidation can
    path = archive.path("IM", "H03S1", "", "EDH", "2014-01-02")
    frozen = os.stat(path)
    monkeypatch.setattr(_daycache, "os", types.SimpleNamespace(
        path=os.path, stat=lambda p: frozen if p == path else os.stat(p)))
    archive.write(xcorr_tpu_torch.stream.Stream([_trace(
        xcorr_tpu_torch, data, "2014-01-02", fs=5.0)]))
    after = archive.read(sid, "2014-01-02T06:00")
    np.testing.assert_array_equal(after[0].data, data)


def test_eviction_at_the_byte_bound(tmp_path, monkeypatch):
    """With room for one day file, reading the second evicts the first,
    which is then decoded again; a file larger than the bound is never
    kept."""
    archive, sid = _two_days(tmp_path)
    decodes = []
    real = tsds._decode_dayfile
    monkeypatch.setattr(tsds, "_decode_dayfile",
                        lambda p: decodes.append(p) or real(p))
    monkeypatch.setattr(_daycache, "MAX_BYTES", 50_000 * 4)
    for day in ("02", "02", "03", "03", "02"):
        archive.read(sid, f"2014-01-{day}T06:00")
    assert [p[-3:] for p in decodes] == ["002", "003", "002"]
    assert _daycache.DAYS.nbytes == 50_000 * 4
    monkeypatch.setattr(_daycache, "MAX_BYTES", 50_000 * 4 - 1)
    _daycache.DAYS.clear()
    for day in ("02", "02"):
        archive.read(sid, f"2014-01-{day}T06:00")
    assert len(decodes) == 5 and _daycache.DAYS.nbytes == 0


def test_failed_decode_is_not_kept(tmp_path, monkeypatch):
    archive, sid = _two_days(tmp_path)
    real = tsds._decode_dayfile
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient")
        return real(path)

    monkeypatch.setattr(tsds, "_decode_dayfile", flaky)
    with pytest.raises(OSError):
        archive.read(sid, "2014-01-02T06:00")
    assert len(archive.read(sid, "2014-01-02T06:00")) == 1
    assert len(calls) == 2


# --------------------------------------------------------------- campaign

FS = 5.0
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
CHAIN = [
    ("detrend", {"type": "demean"}),
    ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
    ("taper", {"type": "cosine", "max_percentage": 0.05,
               "max_length": 30.0}),
]


def test_host_campaign_same_shards_with_and_without_cache(tmp_path,
                                                          monkeypatch):
    """``lazy_process`` (host engine) over a miniSEED archive: the shard
    written through the cache equals, bit for bit, the one written with
    every read decoding afresh; the cached run decodes each of the four
    day files once."""
    synth = xcorr_tpu_torch.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 0.0,
                                  "IU.RAR.10.BHZ": 4.0},
        source_period=600.0, source_amplitude=20.0)
    sds = str(tmp_path / "sds")
    archive = tsds.SDSArchive(sds, format="mseed")
    for receiver in PAIR.split("-"):
        for day in ("2013-12-31", "2014-01-01"):
            tr = synth._synthesize_day(receiver, day)[0]
            tr.data = np.round(1000 * tr.data).astype(np.int32)
            archive.write(xcorr_tpu_torch.stream.Stream([tr]))
    ch = xcorr_tpu_torch.stream.Channel
    inv = xcorr_tpu_torch.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])
    args = dict(preprocess={"EDH": CHAIN, "BHZ": CHAIN},
                attrs={"institution": "t", "author": "t", "source": "t"},
                sampling_rate=FS, window_length=3600.0,
                window_overlap=0.5, clip_lag=(-100.0, 100.0),
                inventory=inv)
    times = pd.date_range("2014-01-01", periods=1, freq="1D")

    def campaign(tag):
        root = str(tmp_path / tag)
        assert xcorr_tpu_torch.lazy_process(
            [PAIR], times, args, {"sds_root": sds}, inventory=inv,
            root=root, nworkers=1, verb=0, device="cpu") == [True]
        return xcorr_tpu_torch.read(
            xcorr_tpu_torch.ncfile(PAIR, times[0], root))

    real, decodes = tsds._decode_dayfile, []
    monkeypatch.setattr(tsds, "read_dayfile", real)
    monkeypatch.setattr(_daycache.DAYS, "views",
                        lambda path, decode: decode(path))
    want = campaign("fresh")
    monkeypatch.undo()
    monkeypatch.setattr(tsds, "_decode_dayfile",
                        lambda p: decodes.append(p) or real(p))
    got = campaign("cached")
    assert len(decodes) == len(set(decodes)) == 4
    assert (got["status"].values == 1).all()
    for name in ("cc", "status", "pair_offset", "time_offset"):
        assert got[name].values.tobytes() == want[name].values.tobytes()
