"""A host-engine campaign runs each receiver's chain once per window
(``xcorr_tpu_torch/stream/_shared.py``, ``core/lazy.py``,
``core/process.py``'s ``pair_windows``).

Three pairs that share ``IM.H03S1..EDH``, over two days, through
``lazy_process(device="cpu")`` with the synthetic client: the shards are
bit-identical to the same campaign on the plain form (the client's pair
fetch, ``_pair_windows_plain``) and within ``ATOL`` = 1e-6 of the JAX
package's ``lazy_process`` (``tests/test_torch_process.py``'s bar for
normalized CCFs); the chains run once per distinct (receiver, window),
and on the plain form once per pair that reads it. Eight ``process``
calls at once on the fetch pool, all needing the same receivers, end
within a time limit with one chain per key; a chain that raises reaches
every waiter and is not kept; an empty result is not kept and each
consumer runs its chain and warns; the windows handed out are read-only,
and none shares memory with an array a fetch thread keeps; a planned
(receiver, day) is dropped when its last pair-day ends, a skipped
complete shard included; past ``CACHE_BYTES`` the shards are the same
bits; the scope is empty after ``lazy_process``, also after a raise;
``process`` outside a scope keeps nothing; where no key can be formed
the call goes to the client; ``results`` keep the gated list's order
while the pair-days run day by day. The chain removes a PAZ response, so
its output is a view of an array of the fetch thread
(``_steps.deconvolve``). All samples come from the seeded synthetic
client.
"""
import importlib
import os
import threading
import time as time_mod  # the chains' argument is named time
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.core.process import shutdown_fetch_pool
from xcorr_tpu_torch.stream import _shared, _steps

process_mod = importlib.import_module("xcorr_tpu_torch.core.process")
lazy_mod = importlib.import_module("xcorr_tpu_torch.core.lazy")

ATOL = 1e-6
FS = 5.0
WINDOW = 14400.0
A, B, C, D = ("IM.H03S1..EDH", "IM.H10N1..EDH", "IU.RAR.10.BHZ",
              "IM.H10N2..EDH")
PAIRS = [f"{A}-{B}", f"{A}-{C}", f"{D}-{A}"]
DELAYS = {A: 0.0, B: 4.0, C: 8.0, D: -4.0}
TIMES = pd.date_range("2014-01-01", periods=2, freq="1D")
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}
CHAIN = [
    ("detrend", {"type": "demean"}),
    ("remove_response", {"output": "VEL"}),
    ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
    ("detrend", {"type": "demean"}),
    ("taper", {"type": "cosine", "max_percentage": 0.05,
               "max_length": 30.0}),
]
PREPROCESS = {"EDH": CHAIN, "BHZ": CHAIN}
ATTRS = {"institution": "t", "author": "t", "source": "synthetic"}


def client(pkg=xt, cls=None, **kw):
    cls = cls or pkg.stream.SyntheticClient
    return cls(sampling_rate=FS, delays=DELAYS, source_period=600.0,
               source_amplitude=20.0, **kw)


def inventory(pkg=xt):
    s = pkg.stream
    return s.Inventory([
        s.Channel(*r.split("."), latitude=-30.0 + i, longitude=-78.8 + i,
                  response=s.PAZResponse(**PAZ))
        for i, r in enumerate((A, B, C, D))])


def init_args(pkg=xt):
    return dict(preprocess=PREPROCESS, attrs=ATTRS, sampling_rate=FS,
                window_length=WINDOW, window_overlap=0.5,
                clip_lag=(-100.0, 100.0), inventory=inventory(pkg))


def campaign(root, pairs=PAIRS, times=TIMES, cl=None, **kw):
    return xt.lazy_process(pairs, times, init_args(), cl or client(),
                           inventory=inventory(), root=str(root), verb=0,
                           device="cpu", **kw)


def plain(monkeypatch):
    """The plain form: the client's pair fetch, as outside a scope."""
    monkeypatch.setattr(process_mod, "pair_windows",
                        process_mod._pair_windows_plain)


def shard(root, pair, day, pkg=xt):
    return pkg.read(pkg.ncfile(pair, day, str(root)))


def same_bits(a, b):
    for name in ("cc", "status", "pair_offset", "time_offset"):
        x, y = a[name].values, b[name].values
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


@pytest.fixture(autouse=True)
def fresh():
    shutdown_fetch_pool()
    _shared.reset_counts()
    yield
    shutdown_fetch_pool()


@pytest.fixture
def chains(monkeypatch):
    """Per (receiver, window time), the chains the fetch pool's threads
    ran (``get_processed_waveforms``; the preflight runs on threads of
    its own)."""
    seen, lock = {}, threading.Lock()
    real = xt.stream.Client.get_processed_waveforms

    def spy(self, receiver, time, *a, **kw):
        if threading.current_thread().name.startswith("xcorr-fetch"):
            with lock:
                seen[receiver, time] = seen.get((receiver, time), 0) + 1
        return real(self, receiver, time, *a, **kw)
    monkeypatch.setattr(xt.stream.Client, "get_processed_waveforms", spy)
    return seen


class Recording(_shared.WindowScope):
    """The scopes ``lazy_process`` opens, and the pair-days released."""
    made = []

    def __init__(self, plan):
        super().__init__(plan)
        self.released = []
        Recording.made.append(self)

    def release(self, pair, day):
        self.released.append((pair, day))
        super().release(pair, day)


@pytest.fixture
def recording(monkeypatch):
    Recording.made = []
    monkeypatch.setattr(lazy_mod, "WindowScope", Recording)
    return Recording.made


@pytest.fixture(scope="module")
def plain_root(tmp_path_factory):
    """The campaign on the plain form."""
    root = tmp_path_factory.mktemp("plain")
    with pytest.MonkeyPatch.context() as m:
        plain(m)
        assert campaign(root) == [True] * 6
    shutdown_fetch_pool()
    return root


@pytest.mark.parametrize("form", ["port", "plain"])
def test_chains_run_once_per_distinct_receiver_window(form, tmp_path,
                                                      chains, monkeypatch,
                                                      plain_root, recording):
    """The campaign's shards are the plain form's bits; its chains run
    once per (receiver, window) on the port's form, once per pair that
    reads it on the plain one; the scope is empty at the end."""
    if form == "plain":
        plain(monkeypatch)
    assert campaign(tmp_path) == [True] * 6
    for pair in PAIRS:
        for day in TIMES:
            same_bits(shard(tmp_path, pair, day),
                      shard(plain_root, pair, day))
    readers = {r: sum(r in p.split("-") for p in PAIRS) for r in DELAYS}
    want = {k: 1 if form == "port" else readers[k[0]] for k in chains}
    assert chains == want
    assert len({t for _, t in chains}) == 2 * 12
    counts = _shared.counts()
    if form == "port":
        assert counts["chains"] == len(chains)
        assert counts["hits"] + counts["waits"] == 2 * 2 * 12
        assert counts["peak_bytes"] > 0
    else:
        assert counts["chains"] == 0 and counts["hits"] == 0
    scope, = recording
    assert scope.nbytes == 0 and scope.planned() == {}
    assert sorted(scope.released) == sorted(
        (p, t) for p in PAIRS for t in TIMES)


def test_shards_match_the_jax_package(tmp_path, plain_root):
    """The shared-window campaign against the JAX package's
    ``lazy_process`` on the same synthetic days, within ATOL."""
    assert campaign(tmp_path / "port") == [True] * 6
    ref = tmp_path / "ref"
    assert all(xcorr_tpu.lazy_process(
        PAIRS, TIMES, init_args(xcorr_tpu), client(xcorr_tpu),
        inventory=inventory(xcorr_tpu), root=str(ref), nworkers=2,
        verb=0))
    for pair in PAIRS:
        for day in TIMES:
            got = shard(tmp_path / "port", pair, day)
            want = shard(ref, pair, day, xcorr_tpu)
            assert (got["status"].values == 1).all()
            np.testing.assert_array_equal(got["status"].values,
                                          want["status"].values)
            np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                                       rtol=0, atol=ATOL)
            np.testing.assert_array_equal(got["pair_offset"].values,
                                          want["pair_offset"].values)
            np.testing.assert_array_equal(got["time_offset"].values,
                                          want["time_offset"].values)


class Slow(xt.stream.SyntheticClient):
    """A chain that takes a while, so that fetches meet in flight."""

    def get_processed_waveforms(self, receiver, time, *a, **kw):
        time_mod.sleep(0.02)
        return super().get_processed_waveforms(receiver, time, *a, **kw)



def pair_day(pair=PAIRS[0], hours=16):
    day = TIMES[0]
    return xt.init(pair=pair, starttime=day,
                   endtime=day + pd.Timedelta(hours=hours), **init_args())


@pytest.mark.parametrize("form", ["port", "plain"])
def test_single_flight_on_the_pool(form, chains, monkeypatch):
    """Eight ``process`` calls at once, all on the one fetch pool and all
    needing the same two receivers' windows: they end within the time
    limit, with one chain per key on the port's form (a chain per call
    and receiver on the plain one), the same CCFs in all."""
    if form == "plain":
        plain(monkeypatch)
    cl, inv = client(cls=Slow), inventory()
    dss = [pair_day() for _ in range(8)]
    scope = _shared.WindowScope.of([(PAIRS[0], TIMES[0])] * 8)
    errors = []

    def run(ds):
        try:
            with scope.pair_day(PAIRS[0], TIMES[0]):
                xt.process(ds, cl, inventory=inv, device="cpu", verb=0)
        except BaseException as error:
            errors.append(error)

    threads = [threading.Thread(target=run, args=(ds,)) for ds in dss]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    nwin = dss[0]["status"].shape[1]
    assert len(chains) == 2 * nwin
    assert set(chains.values()) == {1 if form == "port" else 8}
    for ds in dss:
        assert (ds["status"].values == 1).all()
        assert ds["cc"].values.tobytes() == dss[0]["cc"].values.tobytes()
    if form == "port":
        counts = _shared.counts()
        assert counts["chains"] == 2 * nwin
        assert counts["hits"] + counts["waits"] == 7 * 2 * nwin
    assert scope.nbytes == 0 and scope.planned() == {}
    scope.close()


#: the window time at which ``Failing`` fails (not the preflight's, noon)
AT = TIMES[0] + pd.Timedelta(hours=2)


class Failing(xt.stream.SyntheticClient):
    """``A``'s chain raises, or with ``empty`` warns and gives nothing,
    at the window time ``AT``; counts its runs there."""

    def __init__(self, *a, empty=False, **kw):
        super().__init__(*a, **kw)
        self.empty, self.runs = empty, 0
        self.lock = threading.Lock()

    def get_processed_waveforms(self, receiver, time, *a, **kw):
        if receiver == A and time == AT:
            with self.lock:
                self.runs += 1
            time_mod.sleep(0.2)
            if not self.empty:
                raise RuntimeError(f"{receiver} went away")
            warnings.warn(f"{receiver} has 1 samples, expected 2",
                          UserWarning)
            return xt.stream.Stream()
        return super().get_processed_waveforms(receiver, time, *a, **kw)


def consumers(scope, cl, n=4):
    """``n`` threads asking the scope for ``A``'s first window at once;
    what each got or raised."""
    out, gate, inv = [None] * n, threading.Barrier(n), inventory()

    def run(i):
        gate.wait()
        try:
            with scope.pair_day(PAIRS[0], TIMES[0]):
                out[i] = _shared.pair_windows(
                    _shared.current(), cl, PAIRS[0], AT, PREPROCESS,
                    duration=WINDOW, inventory=inv, sampling_rate=FS,
                    strict=True, verb=0)
        except RuntimeError as error:
            out[i] = error

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def test_a_raising_chain_reaches_every_waiter_and_is_not_kept():
    cl = client(cls=Failing)
    scope = _shared.WindowScope.of([(PAIRS[0], TIMES[0])] * 5)
    out = consumers(scope, cl)
    assert all(isinstance(o, RuntimeError) and "went away" in str(o)
               for o in out)
    assert cl.runs == 1 and _shared.counts()["waits"] == 3
    assert scope.planned() == {(A, TIMES[0]): 1, (B, TIMES[0]): 1}
    # not kept: the next consumer runs the chain again
    out = consumers(scope, cl, n=1)
    assert isinstance(out[0], RuntimeError) and cl.runs == 2
    assert scope.nbytes == 0 and scope.planned() == {}


def test_an_empty_result_is_not_kept_and_each_consumer_warns():
    cl = client(cls=Failing, empty=True)
    scope = _shared.WindowScope.of([(PAIRS[0], TIMES[0])] * 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = consumers(scope, cl)
    assert cl.runs == 4
    assert sum("has 1 samples" in str(w.message) for w in caught) == 4
    # each consumer: B's window alone, as the client's pair fetch gives
    assert all(len(o) == 1 and o[0].id == B for o in out)
    assert _shared.counts()["empty"] >= 1
    assert scope.nbytes == 0 and scope.planned() == {}


@pytest.mark.parametrize("empty", [False, True], ids=["raises", "empty"])
@pytest.mark.parametrize("form", ["port", "plain"])
def test_a_failing_receiver_fails_each_pair_day_as_alone(form, empty,
                                                         tmp_path,
                                                         monkeypatch,
                                                         recording):
    """``A``'s first window raises (every pair-day of the first day
    fails and is retried) or is empty (its window is flagged -1 in each
    pair that reads it): the same results, shards and runs of the chain
    on both forms."""
    if form == "plain":
        plain(monkeypatch)
    cl = client(cls=Failing, empty=empty)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        results = campaign(tmp_path, cl=cl, nworkers=1)
    assert results == [False, True] * 3
    if empty:
        # the first day's shards are written with that window flagged
        first = [shard(tmp_path, p, TIMES[0])["status"].values
                 for p in PAIRS]
        assert all((s == -1).sum() == 1 for s in first)
        assert all((shard(tmp_path, p, TIMES[1])["status"].values == 1)
                   .all() for p in PAIRS)
    else:
        # every pair-day of the first day raised and wrote no shard
        assert not any(os.path.exists(xt.ncfile(p, TIMES[0], str(tmp_path)))
                       for p in PAIRS)
    assert cl.runs == len(PAIRS)
    scope, = recording
    assert scope.nbytes == 0 and scope.planned() == {}


def test_handed_out_windows_are_read_only_and_not_kept_by_threads(
        tmp_path, monkeypatch):
    """Every window the scope hands out in a campaign is a read-only
    view that no chain owns; once the campaign ends, none shares memory
    with an array that a fetch thread keeps, though the threads keep
    arrays (the window and ``remove_response``'s)."""
    handed, real = [], _shared.WindowScope.window

    def spy(self, *a, **kw):
        st = real(self, *a, **kw)
        handed.extend(tr.data for tr in st)
        return st
    monkeypatch.setattr(_shared.WindowScope, "window", spy)
    assert campaign(tmp_path) == [True] * 6
    assert len(handed) == 2 * 3 * 2 * 12
    for x in handed:
        assert not x.flags.writeable and not _steps.owns(x)
        with pytest.raises(ValueError):
            x[0] = 0.0
    pool, gate = process_mod._fetch_pool(), threading.Barrier(8)

    def kept():
        gate.wait(timeout=30)
        return list(_steps._kept().values())

    kept_arrays = [a for f in [pool.submit(kept) for _ in range(8)]
                   for a in f.result()]
    assert kept_arrays
    assert not any(np.shares_memory(a, x) for a in kept_arrays
                   for x in handed)


def test_a_pair_day_releases_its_receivers_windows():
    """Two pair-days of one day that share ``A``: when the first ends,
    its other receiver's windows go and ``A``'s stay; when the second
    ends, having fetched nothing (a complete shard), ``A``'s go too."""
    cl, day = client(), TIMES[0]
    scope = _shared.WindowScope.of([(PAIRS[0], day), (PAIRS[1], day)])
    kw = dict(duration=WINDOW, inventory=inventory(), sampling_rate=FS,
              strict=True, verb=0)
    t0 = day + pd.Timedelta(hours=2)
    with scope.pair_day(PAIRS[0], day):
        st = _shared.pair_windows(_shared.current(), cl, PAIRS[0], t0,
                                  PREPROCESS, **kw)
        assert [tr.id for tr in st] == [A, B]
        held = scope.nbytes
        assert held == sum(tr.data.nbytes for tr in st)
    assert scope.nbytes == st[0].data.nbytes < held
    with scope.pair_day(PAIRS[1], day):
        pass
    assert scope.nbytes == 0 and scope.planned() == {}
    assert _shared.current() is None


def test_a_skipped_complete_shard_releases_its_pair_day(tmp_path,
                                                         recording,
                                                         plain_root):
    """A campaign in which one pair-day's shard is already complete:
    that pair-day is released too, the scope ends empty and the shards
    are the plain form's."""
    assert campaign(tmp_path, pairs=PAIRS[1:2], times=TIMES[:1]) == [True]
    recording.clear()
    assert campaign(tmp_path) == [True] * 6
    scope, = recording
    assert sorted(scope.released) == sorted(
        (p, t) for p in PAIRS for t in TIMES)
    assert scope.nbytes == 0 and scope.planned() == {}
    for pair in PAIRS:
        for day in TIMES:
            same_bits(shard(tmp_path, pair, day),
                      shard(plain_root, pair, day))


def test_past_the_cap_the_shards_are_the_same_bits(tmp_path, monkeypatch,
                                                   plain_root):
    """A cap of one and a half windows: most windows are not kept, and
    each consumer computes its own, the same bits."""
    monkeypatch.setattr(_shared, "CACHE_BYTES", int(1.5 * WINDOW * FS * 8))
    assert campaign(tmp_path) == [True] * 6
    counts = _shared.counts()
    assert counts["over_cap"] > 0
    assert counts["peak_bytes"] <= _shared.CACHE_BYTES
    for pair in PAIRS:
        for day in TIMES:
            same_bits(shard(tmp_path, pair, day),
                      shard(plain_root, pair, day))


class Stop(BaseException):
    pass


def test_the_scope_is_empty_after_a_raise(tmp_path, monkeypatch, recording):
    """A pair-day that raises past the task's isolation ends the
    campaign: the scope it opened is closed and empty."""
    real, calls = lazy_mod.single_threaded_process, []

    def stop(*a, **kw):
        calls.append(a[:2])
        out = real(*a, **kw)
        if len(calls) == 2:
            raise Stop()
        return out
    monkeypatch.setattr(lazy_mod, "single_threaded_process", stop)
    with pytest.raises(Stop):
        campaign(tmp_path, nworkers=1)
    scope, = recording
    assert scope.nbytes == 0 and scope.planned() == {}
    assert _shared.counts()["chains"] > 0
    assert _shared.current() is None


def test_process_outside_a_scope_keeps_nothing(monkeypatch):
    """``process`` called on its own takes the client's pair fetch for
    every window, and no scope is asked."""
    calls = []
    real = xt.stream.Client.get_pair_processed_waveforms

    def spy(self, **kw):
        calls.append(kw["time"])
        return real(self, **kw)
    monkeypatch.setattr(xt.stream.Client, "get_pair_processed_waveforms",
                        spy)
    monkeypatch.setattr(_shared.WindowScope, "get", None)
    ds = pair_day()
    xt.process(ds, client(), inventory=inventory(), device="cpu", verb=0)
    assert (ds["status"].values == 1).all()
    assert len(calls) == ds["status"].shape[1]
    assert _shared.counts() == dict.fromkeys(_shared.COUNTS, 0)


class OwnPairs(xt.stream.SyntheticClient):
    """A client with a pair fetch of its own."""

    def get_pair_processed_waveforms(self, **kw):
        return super().get_pair_processed_waveforms(**kw)


@pytest.mark.parametrize("case", ["unhashable", "own pair fetch",
                                  "unplanned"])
def test_where_no_key_can_be_formed_the_client_fetches(case, chains):
    """An argument that cannot be hashed, a client whose pair fetch is
    not ``Client``'s, or a receiver with no pair-day left in the plan:
    each call goes to the client, and nothing is kept."""
    day, t0 = TIMES[0], TIMES[0] + pd.Timedelta(hours=2)
    cl = client(cls=OwnPairs) if case == "own pair fetch" else client()
    planned = PAIRS[1] if case == "unplanned" else PAIRS[0]
    scope = _shared.WindowScope.of([(planned, day)])
    kw = dict(duration=WINDOW, inventory=inventory(), sampling_rate=FS,
              strict=True, verb=0)
    if case == "unhashable":
        kw["tag"] = ["a list"]  # reaches the chain, which ignores it
    with scope.pair_day(planned, day):
        shared = _shared.current()
        outs = [_shared.pair_windows(shared, cl, PAIRS[0], t0,
                                     PREPROCESS, **kw) for _ in range(2)]
        assert scope.nbytes == (outs[0][0].data.nbytes
                                if case == "unplanned" else 0)
    assert outs[0][0].data.tobytes() == outs[1][0].data.tobytes()
    assert all(len(o) == 2 for o in outs)
    counts = _shared.counts()
    # the pair's receivers not in the plan went to the client each time
    bypassed = {"unhashable": 4, "own pair fetch": 2, "unplanned": 2}
    assert counts["bypassed"] == bypassed[case]
    assert scope.nbytes == 0


def test_results_keep_the_slice_order_while_days_run_in_turn(tmp_path,
                                                             monkeypatch):
    """Each pair-day in the order it ran: day by day, each day's pairs
    in the order of ``pairs``; the results in the gated list's order,
    pair by pair."""
    ran = []

    def record(pair, time, *a, **kw):
        ran.append((pair, time))
        return f"{pair} {time:%F}"
    monkeypatch.setattr(lazy_mod, "single_threaded_process", record)
    results = campaign(tmp_path, nworkers=1)
    assert results == [f"{p} {t:%F}" for p in PAIRS for t in TIMES]
    assert ran == [(p, t) for t in TIMES for p in PAIRS]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_a_cuda_device_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xt.lazy_process(PAIRS, TIMES, init_args(), client(),
                        inventory=inventory(), root=str(tmp_path), verb=0)
