"""The host engine's fetch pool outlives the pair-day
(``xcorr_tpu_torch/core/process.py``: ``fetch_all`` on the process's
one pool, ``shutdown_fetch_pool``).

Two ``process(device="cpu")`` calls in a row fetch on the same pool
threads, which take no fresh window array after their first, and give
the CCFs of the pool-per-call plain form (``_fetch_all_plain``) bit for
bit; a resumed pair-day with fewer pending windows runs on the same
pool; in a campaign's window scope (``stream/_shared.py``) the second
pair takes the shared receiver's windows from the scope, and the CCFs
are every form's plain version's (``FORMS``); results keep the work's
order, also for sixteen callers at once on the one pool, none with more
fetches at once than its workers; more workers than the pool's threads
run on a pool of their own; a fetch
that raises raises from ``process`` and from ``fetch_all``, which cancel
what had not started and wait for what had; one worker fetches in the
caller's thread; the shutdown frees what the threads kept (weak
references); a process of another id (a forked child) makes its own
pool. All samples come from seeded numpy generators.
"""
import gc
import importlib
import inspect
import os
import threading
import time
import weakref

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu_torch as xt
from xcorr_tpu_torch.core.process import (_fetch_all_plain, fetch_all,
                                          shutdown_fetch_pool)
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import _daycache, _response, _shared, _steps
from xcorr_tpu_torch.stream import sds as tsds

process_mod = importlib.import_module("xcorr_tpu_torch.core.process")

CHAINS = default_config()[0]["preprocess"]
DAY = pd.Timestamp("2014-01-02")
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}
EDH_A = ("IM", "H03S1", "", "EDH")
EDH_B = ("IM", "H10N1", "", "EDH")
BH = ("IU", "RAR", "10")
EDH_PAIR = "IM.H03S1..EDH-IM.H10N1..EDH"
BHZ_PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
#: two pair-days' spans of four 600 s windows each (overlap 0.5), inside
#: the hour of data with their buffers
SPANS = [("2014-01-02T00:10", "2014-01-02T00:30"),
         ("2014-01-02T00:25", "2014-01-02T00:45")]


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
    write(root, *BH, "BHZ", 40.0, 3)
    return str(root)


def inventory():
    s = xt.stream
    return s.Inventory(
        [s.Channel(*edh, latitude=-33.6, longitude=-78.8,
                   response=s.PAZResponse(sensitivity=1.5e9))
         for edh in (EDH_A, EDH_B)]
        + [s.Channel(*BH, "BHZ", latitude=-21.2, longitude=-159.8,
                     response=s.PAZResponse(**PAZ))])


@pytest.fixture(autouse=True)
def fresh():
    """Empty caches and no fetch pool, before and after."""
    def clear():
        _daycache.DAYS.clear()
        _response.RESPONSES.clear()
        shutdown_fetch_pool()
    clear()
    yield
    clear()


def dataset(pair, span, inv):
    keys = ("EDH", "BHZ") if pair.endswith("BHZ") else ("EDH",)
    return xt.init(pair=pair, starttime=span[0], endtime=span[1],
                   preprocess={k: CHAINS[k] for k in keys},
                   attrs={"institution": "t", "author": "t", "source": "t"},
                   sampling_rate=50.0, window_length=600.0,
                   window_overlap=0.5, clip_lag=(0.0, 120.0), inventory=inv)


def pair_days(root, pair, **kw):
    inv = inventory()
    out = []
    for span in SPANS:
        ds = dataset(pair, span, inv)
        xt.process(ds, xt.stream.Client(sds_root=root), inventory=inv,
                   device="cpu", verb=0, **kw)
        out.append(ds)
    return out


@pytest.fixture
def buffers(monkeypatch):
    """Per array that ``_steps.buffer`` hands out in a chain: the thread,
    the call of ``process`` (``calls[0]``), the key, and whether it was
    one the thread kept."""
    seen, lock, calls = [], threading.Lock(), [0]
    real = _steps.buffer

    def spy(shape, dtype):
        kept = getattr(_steps._local, "kept", None) or {}
        mine = {id(a) for a in kept.values()}
        out = real(shape, dtype)
        keys = getattr(_steps._local, "keys", None)
        if keys is not None:
            with lock:
                seen.append((threading.current_thread(), calls[0], keys[-1],
                             id(out) in mine))
        return out
    monkeypatch.setattr(_steps, "buffer", spy)
    return seen, calls


@pytest.mark.parametrize("pair", [EDH_PAIR, BHZ_PAIR])
def test_two_calls_share_the_pool_threads(archive, pair, buffers,
                                          monkeypatch):
    """The second pair-day's fetches run on the first's pool threads,
    and no thread takes a second fresh array of a key; the CCFs are the
    pool-per-call form's bits."""
    seen, calls = buffers
    inv = inventory()
    got, pools = [], []
    for span in SPANS:
        ds = dataset(pair, span, inv)
        xt.process(ds, xt.stream.Client(sds_root=archive), inventory=inv,
                   device="cpu", verb=0)
        got.append(ds)
        calls[0] += 1
        pool = process_mod._POOL
        pools.append((pool, set(pool._threads)))
    assert pools[0][0] is pools[1][0] and pools[0][1] == pools[1][1]
    threads = {t for t, _, _, _ in seen}
    assert {t for t, c, _, _ in seen if c == 1} and threads <= pools[0][1]
    assert all(t.name.startswith("xcorr-fetch") for t in threads)
    fresh = {}
    for t, _, key, reused in seen:
        fresh[t, key] = fresh.get((t, key), 0) + (not reused)
    assert max(fresh.values()) == 1
    assert any(reused for _, c, _, reused in seen if c == 1)
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    shutdown_fetch_pool()
    for name in process_mod.FORMS:
        monkeypatch.setattr(process_mod, name,
                            getattr(process_mod, f"_{name}_plain"))
    assert process_mod.fetch_all is _fetch_all_plain
    want = pair_days(archive, pair)
    for g, w in zip(got, want):
        assert (g["status"].values == 1).all()
        assert g["status"].values.tobytes() == w["status"].values.tobytes()
        assert g["cc"].values.tobytes() == w["cc"].values.tobytes()


def test_results_keep_the_work_order():
    """Fetches that end out of order come back in the work's order, on
    the pool's threads, the same pool on the next call."""
    def fetch(k):
        time.sleep(0.002 * (7 - k))
        return k, threading.current_thread()

    first = fetch_all(fetch, range(8), 4)
    second = fetch_all(fetch, range(8), 4)
    assert [k for k, _ in first] == list(range(8))
    assert [k for k, _ in second] == list(range(8))
    threads = {t for _, t in first + second}
    assert threads <= set(process_mod._POOL._threads)
    assert threading.current_thread() not in threads


def test_concurrent_calls_share_one_pool():
    """Sixteen callers at once (more than the cores), on three worker
    counts, with a short switch interval: each gets its own results in
    order, never runs more fetches at once than its workers, and all
    run on the process's one pool."""
    import sys
    start = threading.Barrier(16)
    got, errors, lock = {}, [], threading.Lock()
    running = {c: 0 for c in range(16)}
    most = dict(running)
    threads_seen = set()

    def caller(c):
        def fetch(k):
            with lock:
                running[c] += 1
                most[c] = max(most[c], running[c])
                threads_seen.add(threading.current_thread())
            time.sleep(0.0005)
            with lock:
                running[c] -= 1
            return c, r, k
        try:
            start.wait(30)
            for r in range(5):
                got[c, r] = fetch_all(fetch, range(6), 2 + c % 3)
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(got[c, r] == [(c, r, k) for k in range(6)]
               for c in range(16) for r in range(5))
    assert all(most[c] <= 2 + c % 3 for c in range(16))
    pool = process_mod._POOL
    assert threads_seen <= set(pool._threads)
    assert len(pool._threads) <= process_mod.FETCH_THREADS


def test_more_workers_than_the_pool_run_on_a_pool_of_their_own():
    """A call that asks for more fetches at once than the pool's threads
    runs them all at once on a pool of its own, in order."""
    n = process_mod.FETCH_THREADS + 4
    gate = threading.Barrier(n)

    def fetch(k):
        gate.wait(10)  # all n at once, or this breaks
        return k, threading.current_thread()

    got = fetch_all(fetch, range(n), n)
    assert [k for k, _ in got] == list(range(n))
    assert process_mod._POOL is None
    assert not any(t.name.startswith("xcorr-fetch") for _, t in got)


def test_a_resumed_pair_day_runs_on_the_same_pool(archive, buffers):
    """A pair-day resumed with fewer pending windows than the first
    (the rest already done, as a partial shard re-read gives them, one
    missing and retried) fetches on the first's pool threads, no new
    pool, and no thread takes a second fresh array of a key."""
    seen, calls = buffers
    inv = inventory()
    first = dataset(EDH_PAIR, SPANS[0], inv)
    xt.process(first, xt.stream.Client(sds_root=archive), inventory=inv,
               device="cpu", verb=0)
    pool, threads = process_mod._POOL, set(process_mod._POOL._threads)
    calls[0] += 1
    resumed = dataset(EDH_PAIR, SPANS[1], inv)
    status = resumed["status"].values
    status[0, :-2], status[0, -1] = 1, -1
    xt.process(resumed, xt.stream.Client(sds_root=archive), inventory=inv,
               device="cpu", verb=0, retry_missing=True)
    assert process_mod._POOL is pool and set(pool._threads) == threads
    assert (resumed["status"].values == 1).all()
    assert {t for t, c, _, _ in seen if c == 1} <= threads
    fresh = {}
    for t, _, key, reused in seen:
        fresh[t, key] = fresh.get((t, key), 0) + (not reused)
    assert max(fresh.values()) == 1


@pytest.mark.parametrize("form", [fetch_all, _fetch_all_plain],
                         ids=["pool", "plain"])
def test_a_fetch_that_raises_ends_the_call(form):
    """The first failing fetch's exception raises; by then no fetch of
    the call runs any more, and none that had not started starts."""
    started, ended, lock = [], [], threading.Lock()
    gate = threading.Event()

    def fetch(k):
        with lock:
            started.append(k)
        try:
            if k == 1:
                raise ValueError("fetch 1 failed")
            gate.wait(0.2)
            return k
        finally:
            with lock:
                ended.append(k)

    with pytest.raises(ValueError, match="fetch 1 failed"):
        form(fetch, range(40), 4)
    gate.set()
    done = sorted(started)
    assert sorted(ended) == done and len(done) < 40
    time.sleep(0.3)
    assert sorted(started) == done


class FailingClient:
    """A client whose second window's fetch raises."""

    def __init__(self, root):
        self.client = xt.stream.Client(sds_root=root)
        self.count, self.lock = 0, threading.Lock()
        self.running = 0

    def get_pair_processed_waveforms(self, **kw):
        with self.lock:
            self.count += 1
            k = self.count
            self.running += 1
        try:
            if k == 2:
                raise RuntimeError("the archive went away")
            return self.client.get_pair_processed_waveforms(**kw)
        finally:
            with self.lock:
                self.running -= 1


def test_process_raises_what_a_fetch_raises(archive):
    inv = inventory()
    client = FailingClient(archive)
    ds = dataset(EDH_PAIR, SPANS[0], inv)
    with pytest.raises(RuntimeError, match="the archive went away"):
        xt.process(ds, client, inventory=inv, device="cpu", verb=0)
    assert client.running == 0
    # the pool serves the next call
    ds = dataset(EDH_PAIR, SPANS[1], inv)
    xt.process(ds, xt.stream.Client(sds_root=archive), inventory=inv,
               device="cpu", verb=0)
    assert (ds["status"].values == 1).all()


def test_one_worker_fetches_in_the_caller_thread(archive, buffers):
    seen, _ = buffers
    pair_days(archive, EDH_PAIR, prefetch_workers=1)
    assert {t for t, _, _, _ in seen} == {threading.current_thread()}
    assert process_mod._POOL is None


def test_shutdown_frees_what_the_threads_keep(archive, monkeypatch):
    """After a pair-day the pool's threads keep their arrays; once the
    pool is shut down, every array handed out is freed."""
    refs, real = [], _steps.buffer

    def watch(shape, dtype):
        out = real(shape, dtype)
        refs.append(weakref.ref(out))
        return out
    monkeypatch.setattr(_steps, "buffer", watch)
    inv = inventory()
    ds = dataset(EDH_PAIR, SPANS[0], inv)
    xt.process(ds, xt.stream.Client(sds_root=archive), inventory=inv,
               device="cpu", verb=0)
    del ds
    gc.collect()
    assert refs and any(r() is not None for r in refs)
    threads = list(process_mod._POOL._threads)
    shutdown_fetch_pool()
    gc.collect()
    assert process_mod._POOL is None
    assert not any(t.is_alive() for t in threads)
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("name", process_mod.FORMS)
def test_every_form_has_its_plain_version(name):
    """Each form ``process`` calls has its plain version, with the same
    parameters, that a caller can put in its place."""
    form, plain = (getattr(process_mod, n) for n in (name, f"_{name}_plain"))
    assert callable(plain) and plain is not form
    assert inspect.signature(form).parameters.keys() == \
        inspect.signature(plain).parameters.keys()


def test_a_campaign_scope_on_the_pool(archive, buffers, monkeypatch):
    """Both pairs' pair-days in one campaign scope on the pool: the
    shared receiver's windows are served from the scope to the second
    pair, no thread takes a second fresh array of a key, the scope ends
    empty, and the CCFs are the bits of every form's plain version
    (``core/process.py`` ``FORMS``: a pool per call, the client's pair
    fetch)."""
    seen, calls = buffers
    inv, cl = inventory(), xt.stream.Client(sds_root=archive)
    pairs = (EDH_PAIR, BHZ_PAIR)
    _shared.reset_counts()
    got = []
    with _shared.WindowScope.of([(p, DAY) for p in pairs
                                 for _ in SPANS]) as scope:
        for pair in pairs:
            for span in SPANS:
                ds = dataset(pair, span, inv)
                with scope.pair_day(pair, DAY):
                    xt.process(ds, cl, inventory=inv, device="cpu", verb=0)
                got.append(ds)
                calls[0] += 1
        assert scope.nbytes == 0 and scope.planned() == {}
    served = _shared.counts()
    assert served["hits"] + served["waits"] >= sum(
        d["status"].shape[1] for d in got[len(SPANS):])
    assert served["bypassed"] == 0
    fresh = {}
    for t, _, key, reused in seen:
        fresh[t, key] = fresh.get((t, key), 0) + (not reused)
    assert max(fresh.values()) == 1
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    shutdown_fetch_pool()
    for name in process_mod.FORMS:
        monkeypatch.setattr(process_mod, name,
                            getattr(process_mod, f"_{name}_plain"))
    want = pair_days(archive, EDH_PAIR) + pair_days(archive, BHZ_PAIR)
    for g, w in zip(got, want):
        assert (g["status"].values == 1).all()
        assert g["status"].values.tobytes() == w["status"].values.tobytes()
        assert g["cc"].values.tobytes() == w["cc"].values.tobytes()


def test_another_process_makes_its_own_pool(monkeypatch):
    """A process of another id than the pool's maker (a child forked
    after the pool ran, which has none of its threads) makes a pool of
    its own."""
    assert fetch_all(lambda k: k, range(4), 2) == [0, 1, 2, 3]
    parent = process_mod._POOL
    monkeypatch.setattr(process_mod.os, "getpid", lambda: -1)
    assert fetch_all(lambda k: k * 2, range(4), 2) == [0, 2, 4, 6]
    assert process_mod._POOL is not parent
    parent.shutdown(wait=True)
