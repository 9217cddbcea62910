"""The port's read of one window from an SDS archive against the JAX
package on the CPU.

``xcorr_tpu_torch.stream._window.merge_window`` must return what the
carried ``Stream(traces).merge(method=1, fill_value="interpolate")
.trim(start, end)`` returns, bit for bit: the same Traces in the same
order, dtypes, Stats and samples, while it allocates only the window. The
matrix holds it to the JAX package's merge and trim over windows in one,
two and three days, gaps inside and across each edge of the window,
overlaps, equal starts, several ids, two sampling rates, windows past the
data, integer and float samples and window ends half a sample off the
grid. ``Client.get_waveforms`` over a miniSEED archive written by the
port's encoder is held to the JAX package's client; the day-file cache's
arrays are read-only and a production chain leaves them as they were;
``SDSArchive.read`` still hands out writable copies. All data comes from
seeded numpy generators.
"""
import hashlib
import os

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import _daycache, _window
from xcorr_tpu_torch.stream import sds as tsds

T0 = pd.Timestamp("2014-01-02")
FS = 2.0
DAY = 100.0                       # s of a "day" of the in-memory matrix


@pytest.fixture(autouse=True)
def fresh_cache():
    _daycache.DAYS.clear()
    yield
    _daycache.DAYS.clear()


def assert_same(got, want):
    """Equal Traces: order, ids, start nanoseconds, sampling rate (type
    and value), npts, dtype, samples bit for bit, and the Stats' keys in
    order."""
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


# ------------------------------------------------------------- the matrix

#: case -> (pieces, window): each piece (channel, start s after T0,
#: sampling rate, samples), the window (start, end) in s after T0
CASES = {
    "one_day": ([("BHZ", 0.0, FS, 200)], (20.0, 80.0)),
    "two_days": ([("BHZ", 0.0, FS, 200), ("BHZ", DAY, FS, 200)],
                 (50.0, 150.0)),
    "three_days": ([("BHZ", 0.0, FS, 200), ("BHZ", DAY, FS, 200),
                    ("BHZ", 2 * DAY, FS, 200)], (50.0, 250.0)),
    "days_out_of_order": ([("BHZ", 2 * DAY, FS, 200), ("BHZ", 0.0, FS, 200),
                           ("BHZ", DAY, FS, 200)], (10.0, 290.0)),
    "gap_inside": ([("BHZ", 0.0, FS, 200), ("BHZ", 120.0, FS, 80)],
                   (50.0, 150.0)),
    "gaps_inside": ([("BHZ", 0.0, FS, 60), ("BHZ", 40.0, FS, 30),
                     ("BHZ", 70.0, FS, 90)], (5.0, 110.0)),
    "gap_across_start": ([("BHZ", 0.0, FS, 100), ("BHZ", 80.0, FS, 100)],
                         (60.0, 120.0)),
    "gap_across_end": ([("BHZ", 0.0, FS, 100), ("BHZ", 80.0, FS, 100)],
                       (10.0, 65.0)),
    "window_in_gap": ([("BHZ", 0.0, FS, 100), ("BHZ", 80.0, FS, 100)],
                      (55.0, 70.0)),
    "overlap": ([("BHZ", 0.0, FS, 200), ("BHZ", 60.0, FS, 200)],
                (30.0, 130.0)),
    "overlap_inside": ([("BHZ", 0.0, FS, 300), ("BHZ", 40.0, FS, 40)],
                       (20.0, 100.0)),
    "equal_starts": ([("BHZ", 0.0, FS, 200), ("BHZ", 0.0, FS, 120),
                      ("BHZ", 0.0, FS, 240)], (10.0, 110.0)),
    "equal_starts_gap": ([("BHZ", 0.0, FS, 40), ("BHZ", 50.0, FS, 20),
                          ("BHZ", 50.0, FS, 60)], (15.0, 60.0)),
    "wildcard_ids": ([("BHZ", 0.0, FS, 200), ("BH1", 10.0, FS, 100),
                      ("BH2", 0.0, FS, 80), ("BH1", 70.0, FS, 100),
                      ("BH2", 50.0, FS, 150)], (20.0, 90.0)),
    "two_rates": ([("BHZ", 0.0, FS, 200), ("BHZ", 0.0, 2 * FS, 300),
                   ("BHZ", 120.0, 2 * FS, 100)], (20.0, 140.0)),
    "past_the_data": ([("BHZ", 10.0, FS, 160)], (-20.0, 130.0)),
    "before_the_data": ([("BHZ", 10.0, FS, 160)], (-50.0, -10.0)),
    "after_the_data": ([("BHZ", 10.0, FS, 160)], (150.0, 200.0)),
    "off_grid_piece": ([("BHZ", 0.0, FS, 100), ("BHZ", 60.1, FS, 100)],
                       (20.0, 100.0)),
}
DTYPES = ["int32", "float32", "float64", "int32+float32"]
#: the window's ends on the grid, or half a sample later
OFFSETS = [0.0, 0.5 / FS]


def _pieces(pkg, case, dtype, seed):
    rng = np.random.default_rng(seed)
    dtypes = dtype.split("+")
    traces = []
    for i, (cha, start, fs, n) in enumerate(CASES[case][0]):
        kind = dtypes[i % len(dtypes)]
        data = (rng.integers(-5000, 5000, n) if kind.startswith("int")
                else 1e3 * rng.standard_normal(n)).astype(kind)
        traces.append(pkg.stream.Trace(data, pkg.stream.Stats(
            network="IU", station="RAR", location="10", channel=cha,
            starttime=T0 + pd.Timedelta(seconds=start), sampling_rate=fs)))
    return traces


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as error:
        return None, error


@pytest.mark.parametrize("offset", OFFSETS, ids=["on_grid", "half_off"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_window_matches_merge_and_trim(case, dtype, offset):
    seed = sorted(CASES).index(case) * 10 + DTYPES.index(dtype)
    a, b = CASES[case][1]
    start = T0 + pd.Timedelta(seconds=a + offset)
    end = T0 + pd.Timedelta(seconds=b + offset)
    want, raised = _outcome(lambda: xcorr_tpu.stream.Stream(
        _pieces(xcorr_tpu, case, dtype, seed)).merge(
        method=1, fill_value="interpolate").trim(start, end))
    traces = _pieces(xcorr_tpu_torch, case, dtype, seed)
    for tr in traces:
        tr.data.flags.writeable = False
    got, error = _outcome(lambda: _window.merge_window(traces, start, end))
    if raised is not None:
        assert error is not None and str(error) == str(raised)
        return
    assert error is None
    assert type(got) is xcorr_tpu_torch.stream.Stream
    assert_same(got.traces, want.traces)
    for tr in got:
        assert tr.data.flags.writeable and tr.data.flags.owndata


def test_the_matrix_reaches_its_cases():
    """The cases are what their names say: gaps interpolated across the
    window's edges from samples outside it, empty windows, a merge that
    raises where the carried one does."""
    def run(case, offset=0.0):
        a, b = CASES[case][1]
        return _window.merge_window(
            _pieces(xcorr_tpu_torch, case, "float64", 1),
            T0 + pd.Timedelta(seconds=a + offset),
            T0 + pd.Timedelta(seconds=b + offset))
    # a window before the data ends at a negative index of the union,
    # which the carried trim's slice counts from the union's end
    assert [tr.stats.npts for tr in run("before_the_data")] == [121]
    assert [tr.stats.npts for tr in run("after_the_data")] == [0]
    assert [tr.stats.channel for tr in run("wildcard_ids")] == \
        ["BH1", "BH2", "BHZ"]
    assert [tr.stats.sampling_rate for tr in run("two_rates")] == \
        [FS, 2 * FS]
    # a window inside a gap: a line between two samples outside it
    (tr,) = run("window_in_gap")
    assert tr.stats.npts == 31 and np.allclose(np.diff(tr.data, 2), 0.0)
    # a piece a quarter sample off the grid of the first is placed by
    # rounding, and one whose end rounds past the union raises
    assert run("off_grid_piece")[0].stats.npts == 161
    traces = _pieces(xcorr_tpu_torch, "one_day", "float64", 1)
    traces += [traces[0].copy()]
    traces[1].stats.starttime += 1.5 / FS
    traces[1].data, traces[1].stats.npts = traces[1].data[:2], 2
    traces[0].data, traces[0].stats.npts = traces[0].data[:1], 1
    with pytest.raises(ValueError):
        _window.merge_window(traces, T0, T0 + pd.Timedelta(seconds=10))
    with pytest.raises(ValueError):
        xcorr_tpu_torch.stream.Stream([t.copy() for t in traces]).merge(
            method=1, fill_value="interpolate")


# ------------------------------------------------------------ the archive

SDS_FS = 1.0
STATION = ("IU", "RAR", "10")
ARCHIVE_DAYS = pd.date_range("2014-01-01", periods=4, freq="1D")


def _day_pieces(cha, iday, fs):
    """A day file's pieces, (start s after midnight, samples): whole days
    but for a gap in BHZ's second day, an overlap in BH1's, and BH2's
    second day a quarter sample off the grid."""
    n = int(86400 * fs)
    if (cha, iday) == ("BHZ", 1):
        return [(0.0, int(36000 * fs)), (37800.0, n - int(37800 * fs))]
    if (cha, iday) == ("BH1", 1):
        return [(0.0, int(50000 * fs)), (49000.0, n - int(49000 * fs))]
    if (cha, iday) == ("BH2", 1):
        return [(0.25 / fs, n)]
    return [(0.0, n)]


def _write_archive(root, fs=SDS_FS, days=ARCHIVE_DAYS, seconds=None,
                   seed=5):
    """miniSEED day files of BH1, BH2, BHZ at ``fs`` written by the port's
    encoder; ``seconds`` keeps only those seconds after each midnight
    (``(lo, hi)``)."""
    rng = np.random.default_rng(seed)
    for cha in ("BH1", "BH2", "BHZ"):
        for iday, day in enumerate(days):
            payload = b""
            for start, n in _day_pieces(cha, iday, fs):
                lo, hi = seconds or (0.0, 86400.0)
                i0 = max(int(np.ceil((lo - start) * fs)), 0)
                i1 = min(int(np.floor((hi - start) * fs)), n)
                if i1 <= i0:
                    continue
                data = np.round(1e3 * rng.standard_normal(i1 - i0)) \
                    .astype(np.int32)
                payload += tm.encode_mseed(xcorr_tpu_torch.stream.Trace(
                    data, xcorr_tpu_torch.stream.Stats(
                        network=STATION[0], station=STATION[1],
                        location=STATION[2], channel=cha,
                        starttime=day + pd.Timedelta(
                            seconds=start + i0 / fs),
                        sampling_rate=fs)))
            path = tsds.sds_path(str(root), *STATION, cha, day)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(payload)


#: (receiver, centre time, duration): one day, two, three, a window past
#: the archive's end (the per-day path), the wildcard
WINDOWS = {
    "one_day": ("IU.RAR.10.BHZ", "2014-01-02T10:15", 3600.0),
    "gap_at_edge": ("IU.RAR.10.BHZ", "2014-01-02T09:00", 7200.0),
    "two_days": ("IU.RAR.10.BH1", "2014-01-02T00:00", 86400.0),
    "three_days": ("IU.RAR.10.BHZ", "2014-01-02T12:00", 86400.0),
    "off_grid": ("IU.RAR.10.BH2", "2014-01-02T12:00", 86400.0),
    "past_the_end": ("IU.RAR.10.BHZ", "2014-01-04T20:00", 86400.0),
    "wildcard": ("IU.RAR.10.BH?", "2014-01-02T12:00", 86400.0),
}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("sds")
    _write_archive(root)
    return str(root)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_client_get_waveforms_matches_reference(archive, window):
    """``Client.get_waveforms`` over the archive: the window read through
    the cache's views and ``merge_window`` is the JAX package's client's,
    bit for bit, cold and from the cache; so is the carried read."""
    receiver, time, duration = WINDOWS[window]
    kw = dict(receiver=receiver, time=time, duration=duration,
              allow_wildcards=True, download=False)
    want = xcorr_tpu.stream.Client(sds_root=archive).get_waveforms(**kw)
    assert len(want) and all(tr.stats.npts for tr in want)
    client = xcorr_tpu_torch.stream.Client(sds_root=archive)
    for _ in range(2):
        assert_same(client.get_waveforms(**kw).traces, want.traces)
    t0 = pd.Timestamp(time) - pd.Timedelta(seconds=duration * 0.55)
    t1 = t0 + pd.Timedelta(seconds=duration * 1.1)
    assert_same(
        _window.read_window(client.archives[0], receiver, t0, t1).traces,
        _window._read_window_plain(client.archives[0], receiver, t0,
                                   t1).traces)


def test_short_archive_falls_through_to_the_next(archive, tmp_path):
    """A first archive whose data ends before the window does is passed
    over for the next one, as the carried coverage test decides."""
    _write_archive(tmp_path, days=ARCHIVE_DAYS[:2], seed=7)
    kw = dict(receiver="IU.RAR.10.BHZ", time="2014-01-02T12:00",
              duration=86400.0, download=False)
    roots = [str(tmp_path), archive]
    want = xcorr_tpu.stream.Client(sds_root_read=roots).get_waveforms(**kw)
    got = xcorr_tpu_torch.stream.Client(sds_root_read=roots) \
        .get_waveforms(**kw)
    assert_same(got.traces, want.traces)
    full = xcorr_tpu_torch.stream.Client(sds_root=archive) \
        .get_waveforms(**kw)
    assert_same(got.traces, full.traces)


def _cached_arrays():
    return {key: [tr.data for tr in traces]
            for key, (traces, _) in _daycache.DAYS._done.items()}


def test_cached_arrays_are_read_only(archive):
    receiver = "IU.RAR.10.BHZ"
    client = xcorr_tpu_torch.stream.Client(sds_root=archive)
    st = client.get_waveforms(receiver=receiver, time="2014-01-02T12:00",
                              duration=86400.0, download=False)
    assert st[0].data.flags.writeable
    cached = _cached_arrays()
    assert len(cached) == 3
    views = _window.day_views(client.archives[0], receiver, "2014-01-02")
    assert [id(v.data) for v in views] == [
        id(a) for key, arrays in cached.items() for a in arrays
        if key[0].endswith(".002")]
    for arrays in cached.values():
        for a in arrays:
            assert not a.flags.writeable
            with pytest.raises(ValueError, match="read-only"):
                a[0] = 1
    with pytest.raises(ValueError, match="read-only"):
        views[0].data += 1
    # a view's Stats are the caller's own
    views[0].stats.network = "ZZ"
    again = _window.day_views(client.archives[0], receiver, "2014-01-02")
    assert again[0].stats.network == "IU"
    assert again[0].data is views[0].data


def test_sds_read_hands_out_writable_copies(archive):
    """The public ``SDSArchive.read`` after the window read filled the
    cache: writable arrays of the caller's own, equal to the JAX
    package's read."""
    client = xcorr_tpu_torch.stream.Client(sds_root=archive)
    client.get_waveforms(receiver="IU.RAR.10.BH?", time="2014-01-02T12:00",
                         duration=86400.0, allow_wildcards=True,
                         download=False)
    cached = [a for arrays in _cached_arrays().values() for a in arrays]
    assert len(cached) >= 9
    for cha in ("BH1", "BH2", "BHZ"):
        sid = f"IU.RAR.10.{cha}"
        want = xcorr_tpu.stream.SDSArchive(archive).read(sid, "2014-01-02")
        got = tsds.SDSArchive(archive).read(sid, "2014-01-02")
        assert_same(got.traces, want.traces)
        (tr, *_) = tsds.read_dayfile(tsds.sds_path(archive, *STATION, cha,
                                                   "2014-01-02"))
        for t in (*got, tr):
            assert t.data.flags.writeable
            assert not any(np.shares_memory(t.data, a) for a in cached)
            t.data[:] = 7


def test_production_chain_leaves_the_cache_unchanged(tmp_path):
    """The production BHR chain (response removed, rotations, the
    Lanczos step) on a window fetched through the cache: the result is
    the JAX package's, and every cached array hashes as before."""
    _write_archive(tmp_path, fs=40.0, days=ARCHIVE_DAYS[:1],
                   seconds=(82800.0, 86400.0))
    _write_archive(tmp_path, fs=40.0, days=ARCHIVE_DAYS[1:2],
                   seconds=(0.0, 3600.0), seed=6)
    chain = default_config()[0]["preprocess"]["BHR"]
    paz = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
           "gain": 1.0, "sensitivity": 2.5e8}
    out = {}
    for pkg in (xcorr_tpu, xcorr_tpu_torch):
        inv = pkg.stream.Inventory([pkg.stream.Channel(
            *STATION, cha, latitude=-21.2, longitude=-159.8,
            response=pkg.stream.PAZResponse(**paz))
            for cha in ("BHR", "BH1", "BH2", "BHZ")])
        client = pkg.stream.Client(sds_root=str(tmp_path))
        out[pkg] = client.get_processed_waveforms(
            "IU.RAR.10.BHR", "2014-01-02T00:00", {"BHR": chain},
            duration=1800.0, inventory=inv, sampling_rate=50.0)
        if pkg is xcorr_tpu_torch:
            before = {k: [hashlib.sha256(a).hexdigest() for a in v]
                      for k, v in _cached_arrays().items()}
            again = client.get_processed_waveforms(
                "IU.RAR.10.BHR", "2014-01-02T00:00", {"BHR": chain},
                duration=1800.0, inventory=inv, sampling_rate=50.0)
            after = {k: [hashlib.sha256(a).hexdigest() for a in v]
                     for k, v in _cached_arrays().items()}
    assert len(before) == 6 and before == after
    want = out[xcorr_tpu]
    assert len(want) == 1 and want[0].stats.npts == 90_000
    assert_same(out[xcorr_tpu_torch].traces, want.traces)
    assert_same(again.traces, want.traces)
