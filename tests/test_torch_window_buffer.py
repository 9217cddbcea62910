"""The buffer that each fetch thread keeps for its window merge
(``xcorr_tpu_torch/stream/_steps.py`` ``window_array``, filled by
``_window.merge_window``).

Inside a chain (``Client.get_processed_waveforms``) the window's array is
the buffer the thread keeps where it fits the window exactly; the chain
hands it back when its scope closes only if nothing else reaches it. So:
two EDH windows in one thread fill one buffer, and the first window's
output is unchanged by the second; a chain whose output is the window
array itself, a chain that raises, and a window array the caller holds
never give their buffer back; ``get_waveforms`` outside a chain returns
a fresh array; eight threads keep eight buffers, give the plain path's
bytes and free their buffers when they end; the reference count that
decides a buffer's return is measured at import, and where it cannot
tell a lone array from a viewed one no buffer is reused; and an EDH-EDH
and a BHR-EDH pair-day through ``process(device="cpu")`` give the same
CCF bytes on the port's forms and on the plain path (the carried read, response, chain and steps, a fresh
array per window). All samples come from seeded numpy generators.
"""
import gc
import hashlib
import os
import sys
import threading
import warnings
import weakref

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu_torch as xt
from xcorr_tpu_torch.core.process import shutdown_fetch_pool
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import (_daycache, _live, _response, _steps,
                                    _window)
from xcorr_tpu_torch.stream import client as client_mod
from xcorr_tpu_torch.stream import sds as tsds
from xcorr_tpu_torch.stream import trace as trace_mod

CHAINS = default_config()[0]["preprocess"]
DAY = pd.Timestamp("2014-01-02")
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}
EDH_A = ("IM", "H03S1", "", "EDH")
EDH_B = ("IM", "H10N1", "", "EDH")
BH = ("IU", "RAR", "10")
RECEIVER = "IM.H03S1..EDH"
#: window centres whose 1800 s windows (and 90 s buffers) lie in the hour
#: of data
TIMES = ["2014-01-02T00:30", "2014-01-02T00:31", "2014-01-02T00:32"]


def write(root, net, sta, loc, cha, fs, seed, seconds=3600.0):
    rng = np.random.default_rng(seed)
    data = np.round(1e3 * rng.standard_normal(int(seconds * fs))) \
        .astype(np.int32)
    payload = tm.encode_mseed(xt.stream.Trace(data, xt.stream.Stats(
        network=net, station=sta, location=loc, channel=cha,
        starttime=DAY, sampling_rate=fs)))
    path = tsds.sds_path(str(root), net, sta, loc, cha, DAY)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("sds")
    write(root, *EDH_A, 250.0, 1)
    write(root, *EDH_B, 250.0, 2)
    for seed, cha in enumerate(("BH1", "BH2", "BHZ"), 3):
        write(root, *BH, cha, 40.0, seed)
    return str(root)


def inventory():
    s = xt.stream
    return s.Inventory(
        [s.Channel(*edh, latitude=-33.6, longitude=-78.8,
                   response=s.PAZResponse(sensitivity=1.5e9))
         for edh in (EDH_A, EDH_B)]
        + [s.Channel(*BH, cha, latitude=-21.2, longitude=-159.8,
                     response=s.PAZResponse(**PAZ))
           for cha in ("BHR", "BH1", "BH2", "BHZ")])


@pytest.fixture(autouse=True)
def fresh():
    """Empty caches, no buffer kept by this thread, and no fetch pool,
    whose threads would keep theirs from an earlier test."""
    def clear():
        _daycache.DAYS.clear()
        _response.RESPONSES.clear()
        _steps._local.__dict__.pop("kept", None)
        shutdown_fetch_pool()
    clear()
    yield
    clear()


def address(a):
    return a.__array_interface__["data"][0]


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@pytest.fixture
def windows(monkeypatch):
    """The threads and data addresses of the arrays ``window_array``
    hands out (the spy keeps no reference to them)."""
    seen, lock = [], threading.Lock()
    real = _steps.window_array

    def spy(npts, dtype):
        out = real(npts, dtype)
        with lock:
            seen.append((threading.get_ident(), address(out)))
        return out
    monkeypatch.setattr(_steps, "window_array", spy)
    return seen


def plain_path(monkeypatch):
    """The carried read, response, chain and steps, a fresh array per
    window."""
    monkeypatch.setattr(client_mod, "read_window",
                        _window._read_window_plain)
    monkeypatch.setattr(_response, "inverse_response",
                        _response._inverse_response_plain)
    monkeypatch.setattr(client_mod, "drop_unread", _live._drop_unread_plain)
    monkeypatch.setattr(trace_mod, "lanczos_interp",
                        trace_mod._lanczos_interp)
    for name in _steps.FORMS:
        monkeypatch.setattr(_steps, name, getattr(_steps, f"_{name}_plain"))


def fetch(root, time, ops=None, **kw):
    ops = CHAINS["EDH"] if ops is None else ops
    kw = {"sampling_rate": 50.0, "strict": True, **kw}
    return xt.stream.Client(sds_root=root).get_processed_waveforms(
        RECEIVER, time, {"EDH": ops}, duration=1800.0, inventory=inventory(),
        **kw)


def slot_buffer():
    """The largest buffer this thread keeps, or None."""
    kept = getattr(_steps._local, "kept", None) or {}
    return max(kept.values(), key=lambda a: a.nbytes, default=None)


def lone_slot_buffer():
    """Whether nothing but this thread's slot reaches the largest buffer
    it keeps (taken out of the slot to count its references)."""
    kept = _steps._local.kept
    key = max(kept, key=lambda k: kept[k].nbytes)
    [(_, refs)] = _steps._refcounts([kept.pop(key)])
    return refs == _steps._ALONE


def plain_outputs(root, monkeypatch):
    with monkeypatch.context() as m:
        plain_path(m)
        return {t: fetch(root, t)[0].data.tobytes() for t in TIMES}


def test_two_windows_in_one_thread_fill_one_buffer(archive, windows,
                                                   monkeypatch):
    want = plain_outputs(archive, monkeypatch)
    first = fetch(archive, TIMES[0])[0].data
    before = sha(first)
    second = fetch(archive, TIMES[1])[0].data
    assert len(windows) == 2 and windows[0][1] == windows[1][1]
    assert sha(first) == before
    assert first.tobytes() == want[TIMES[0]]
    assert second.tobytes() == want[TIMES[1]]
    # the buffer is back in the slot, and nothing else reaches it
    buf = slot_buffer()
    assert address(buf) == windows[0][1]
    assert not np.shares_memory(buf, first)
    assert not np.shares_memory(buf, second)
    del buf
    assert lone_slot_buffer()


def test_window_of_another_size_allocates(archive, windows):
    """A window of another length does not take the buffer, which stays
    in the slot for a window it fits."""
    fetch(archive, TIMES[0])
    out = xt.stream.Client(sds_root=archive).get_processed_waveforms(
        RECEIVER, TIMES[1], {"EDH": CHAINS["EDH"]}, duration=1200.0,
        inventory=inventory(), sampling_rate=50.0, strict=True)
    assert len(out) == 1
    assert windows[0][1] != windows[1][1]
    assert address(slot_buffer()) == windows[0][1]
    fetch(archive, TIMES[2])
    assert windows[2][1] == windows[0][1]


def test_chain_without_decimate_keeps_no_buffer(archive, windows):
    """A chain whose output is a view of the window array itself: its
    buffer never goes back, and the next window leaves it intact."""
    ops = [op for op in CHAINS["EDH"]
           if op[0] in ("merge", "detrend", "remove_sensitivity")]
    out = fetch(archive, TIMES[0], ops=ops, sampling_rate=None,
                strict=False)[0].data
    assert address(out.base) == windows[0][1]
    assert slot_buffer() is None
    before = sha(out)
    fetch(archive, TIMES[1])
    assert windows[1][1] != windows[0][1]
    assert sha(out) == before


BAD_FILTER = [op for op in CHAINS["EDH"] if op[0] in ("merge", "detrend")] \
    + [("filter", {"type": "nonsense"})]


def test_chain_that_raises_keeps_no_buffer(archive, windows, monkeypatch):
    """A chain that raises holds its window in the traceback when its
    scope closes: the buffer is dropped, and the next window allocates."""
    with pytest.raises(RuntimeError, match="nonsense") as raised:
        fetch(archive, TIMES[0], ops=BAD_FILTER, raise_error=True)
    assert slot_buffer() is None
    want = plain_outputs(archive, monkeypatch)
    # the traceback still holds the first window: the next one is another
    got = fetch(archive, TIMES[1])[0].data
    assert windows[1][1] != windows[0][1]
    assert got.tobytes() == want[TIMES[1]]
    del raised


def test_failed_step_gives_back_only_a_free_buffer(archive, windows,
                                                   monkeypatch):
    """A step that fails with a warning ends the chain with no Traces;
    the buffer goes back only if nothing reaches it, and the next window
    that fills it gives the plain path's bytes."""
    with pytest.warns(UserWarning, match="nonsense"):
        assert len(fetch(archive, TIMES[0], ops=BAD_FILTER)) == 0
    if slot_buffer() is not None:
        assert lone_slot_buffer()
    want = plain_outputs(archive, monkeypatch)
    got = fetch(archive, TIMES[1])[0].data
    assert got.tobytes() == want[TIMES[1]]


def test_window_held_by_the_caller_keeps_no_buffer(archive, windows,
                                                   monkeypatch):
    """A window array that a caller keeps (here a wrapper of the merge)
    never goes back, and the next window leaves it intact."""
    held = []
    real = _window.merge_window

    def keep(*a, **kw):
        st = real(*a, **kw)
        held.append(st[0].data)
        return st
    monkeypatch.setattr(_window, "merge_window", keep)
    fetch(archive, TIMES[0])
    assert slot_buffer() is None
    before = sha(held[0])
    fetch(archive, TIMES[1])
    assert windows[1][1] != windows[0][1]
    assert sha(held[0]) == before


def test_get_waveforms_outside_a_chain_is_fresh(archive, windows):
    """``get_waveforms`` on its own returns arrays the caller owns: fresh
    each call, never the thread's buffer, and left intact by a chain."""
    fetch(archive, TIMES[0])
    buf = address(slot_buffer())
    client = xt.stream.Client(sds_root=archive)
    a = client.get_waveforms(receiver=RECEIVER, time=TIMES[0],
                             duration=1800.0)[0].data
    b = client.get_waveforms(receiver=RECEIVER, time=TIMES[0],
                             duration=1800.0)[0].data
    assert a.flags.writeable and a.flags.owndata
    assert len({address(a), address(b), buf}) == 3
    before = sha(a)
    fetch(archive, TIMES[1])
    assert windows[-1][1] == buf
    assert sha(a) == before and a.tobytes() == b.tobytes()


def test_eight_threads_keep_eight_buffers(archive, windows, monkeypatch):
    """Eight threads at once, three windows each: each thread fills one
    buffer of its own, every output is the plain path's bytes, and each
    buffer is freed when its thread ends."""
    want = plain_outputs(archive, monkeypatch)
    del windows[:]
    arrays, spied = [], _steps.window_array

    def watch(npts, dtype):
        out = spied(npts, dtype)
        arrays.append(weakref.ref(out))
        return out
    monkeypatch.setattr(_steps, "window_array", watch)
    start, done = threading.Barrier(8), threading.Barrier(8)
    got, errors = {}, []

    def run(k):
        try:
            start.wait(30)
            got[k] = [fetch(archive, t)[0].data.tobytes() for t in TIMES]
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            done.wait(60)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(got[k] == [want[t] for t in TIMES] for k in range(8))
    by_thread = {}
    for ident, addr in windows:
        by_thread.setdefault(ident, []).append(addr)
    assert len(by_thread) == 8
    assert all(len(a) == 3 and len(set(a)) == 1 for a in by_thread.values())
    assert len({a[0] for a in by_thread.values()}) == 8
    gc.collect()
    assert len(arrays) == 24 and all(r() is None for r in arrays)


def test_probe_tells_a_lone_array_from_a_viewed_one():
    """The reference count the buffer's return rests on is measured on
    this interpreter: a lone array reads ``_ALONE``, one that a view, a
    view of that view, or an export also holds reads more."""
    assert _steps._ALONE is not None
    [(_, refs)] = _steps._refcounts([np.empty(16)])
    assert refs == _steps._ALONE
    for hold in (lambda a: a[2:], lambda a: a[2:][::2], memoryview,
                 lambda a: a.reshape(4, 4).T):
        arrays = [np.empty(16)]
        held = hold(arrays[0])
        [(_, refs)] = _steps._refcounts(arrays)
        assert refs > _steps._ALONE
        del held


def test_no_buffer_goes_back_where_the_probe_cannot_tell(archive, windows,
                                                        monkeypatch):
    """Where the probe finds no count that sets a lone array apart
    (``_ALONE`` None), no thread keeps a buffer, so every window takes a
    fresh array, and the outputs are the plain path's bytes."""
    want = plain_outputs(archive, monkeypatch)
    monkeypatch.setattr(_steps, "_ALONE", None)
    got = []
    for t in TIMES:
        got.append(fetch(archive, t)[0].data.tobytes())
        assert slot_buffer() is None
    assert len(windows) == len(TIMES)
    assert got == [want[t] for t in TIMES]


def dataset(pair, inv):
    bh = pair.endswith("BHR")
    return xt.init(pair=pair, starttime="2014-01-02T00:10",
                   endtime="2014-01-02T00:20",
                   preprocess={k: CHAINS[k]
                               for k in (("EDH", "BHR") if bh else ("EDH",))},
                   attrs={"institution": "t", "author": "t", "source": "t"},
                   sampling_rate=50.0, window_length=600.0,
                   window_overlap=0.5, clip_lag=(0.0, 120.0), inventory=inv)


def pair_day(root, pair):
    inv = inventory()
    ds = dataset(pair, inv)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xt.process(ds, xt.stream.Client(sds_root=root), inventory=inv,
                   device="cpu", verb=0)
    return ds, [str(w.message) for w in caught]


@pytest.mark.parametrize("pair", ["IM.H03S1..EDH-IM.H10N1..EDH",
                                  "IM.H03S1..EDH-IU.RAR.10.BHR"])
def test_pair_day_matches_the_plain_path(archive, pair, windows,
                                         monkeypatch):
    """The pair-day's CCFs and statuses on the port's forms are the plain
    path's bits; on the port's forms a fetch thread's second window of a
    size fills the buffer its first one filled."""
    got, got_warn = pair_day(archive, pair)
    by_thread = {}
    for ident, addr in windows:
        by_thread.setdefault(ident, []).append(addr)
    if pair.endswith("EDH"):
        assert any(len(a) >= 2 and a[0] == a[1] for a in by_thread.values())
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    with monkeypatch.context() as m:
        plain_path(m)
        want, want_warn = pair_day(archive, pair)
    assert (got["status"].values == 1).all()
    assert got["status"].values.tobytes() == want["status"].values.tobytes()
    assert got["cc"].values.tobytes() == want["cc"].values.tobytes()
    assert got_warn == want_warn
