"""The host chain's steps without the copies they drop
(``xcorr_tpu_torch.stream._steps``) against the JAX package's carried
steps on the CPU.

Each changed step (``detrend``, ``filter``, ``decimate``,
``remove_sensitivity``, ``Stream.merge``) gives the JAX package's bits
and dtype for float64, float32 and int32 samples, called on its own and
inside a chain on an array the chain owns (where the float64 forms work
in place). Called on its own, or inside a chain on an array the chain did
not allocate, a step leaves the caller's array and a read-only view of
the day-file cache as they were. A whole 250 Hz EDH window and a 40 Hz
BHZ window fetched from a miniSEED archive come out of the production
chains as the JAX package's client gives them, and as the port's carried
forms do. All samples come from seeded numpy generators.
"""
import hashlib
import os

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import (_daycache, _live, _response, _steps,
                                    _window)
from xcorr_tpu_torch.stream import client as client_mod
from xcorr_tpu_torch.stream import sds as tsds

DTYPES = ["float64", "float32", "int32"]
N = 5003
FS = 250.0
T0 = pd.Timestamp("2014-01-02")
CHAINS = default_config()[0]["preprocess"]
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}

#: step -> (method, kwargs), as the chains call them
STEPS = {
    "demean": ("detrend", {"type": "demean"}),
    "constant": ("detrend", {"type": "constant"}),
    "linear": ("detrend", {"type": "linear"}),
    "simple": ("detrend", {"type": "simple"}),
    "bandpass": ("filter", {"type": "bandpass", "freqmin": 3.0,
                            "freqmax": 20.0}),
    "bandstop": ("filter", {"type": "bandstop", "freqmin": 3.0,
                            "freqmax": 20.0}),
    "highpass": ("filter", {"type": "highpass", "freq": 3.0}),
    "lowpass_zerophase": ("filter", {"type": "lowpass", "freq": 20.0,
                                     "zerophase": True}),
    "decimate": ("decimate", {"factor": 5}),
    "decimate_no_filter": ("decimate", {"factor": 5, "no_filter": True}),
    "remove_sensitivity": ("remove_sensitivity", {}),
}


def samples(dtype, seed=0, n=N):
    x = 1e3 * np.random.default_rng(seed).standard_normal(n)
    return x.astype(dtype) if dtype != "int32" else \
        np.round(x).astype(np.int32)


def trace(pkg, data, channel="EDH"):
    return pkg.stream.Trace(data, pkg.stream.Stats(
        network="IM", station="H03S1", location="", channel=channel,
        starttime=T0, sampling_rate=FS))


def inventory(pkg):
    return pkg.stream.Inventory([pkg.stream.Channel(
        "IM", "H03S1", "", "EDH", latitude=0.0, longitude=0.0,
        response=pkg.stream.PAZResponse(sensitivity=1.5e9))])


def run(pkg, tr, step):
    method, kw = STEPS[step]
    if method == "remove_sensitivity":
        kw = {"inventory": inventory(pkg)}
    getattr(tr, method)(**kw)
    return tr


def bits(a):
    return a.dtype.str, a.shape, hashlib.sha256(
        np.ascontiguousarray(a)).hexdigest()


@pytest.mark.parametrize("owned", [False, True], ids=["alone", "owned"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_matches_the_carried_step(step, dtype, owned):
    """The step's samples are the JAX package's, bit for bit, in the same
    dtype; a float64 step on an array the chain owns writes over it where
    its form works in place."""
    want = run(xcorr_tpu, trace(xcorr_tpu, samples(dtype)), step).data
    with _steps.chain():
        data = samples(dtype)
        if owned:
            _steps.own(data)
        tr = run(xt, trace(xt, data), step)
    assert bits(tr.data) == bits(want)
    in_place = owned and dtype == "float64" and step in (
        "demean", "constant", "remove_sensitivity", "bandpass", "bandstop",
        "highpass")
    assert (tr.data is data) == in_place


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_leaves_the_callers_array(step, dtype):
    """Called on its own, and inside a chain on an array the chain did not
    allocate, a step leaves the caller's array as it was, and on a
    read-only array (as the day-file cache hands out) it raises
    nothing."""
    data = samples(dtype)
    before = bits(data)
    run(xt, trace(xt, data), step)
    assert bits(data) == before
    with _steps.chain():
        run(xt, trace(xt, data), step)
    assert bits(data) == before
    frozen = samples(dtype)
    frozen.flags.writeable = False
    with _steps.chain():
        _steps.own(frozen)
        got = run(xt, trace(xt, frozen), step).data
    assert bits(frozen) == before
    assert bits(got) == bits(run(xcorr_tpu, trace(xcorr_tpu,
                                                  samples(dtype)),
                                 step).data)


def merge_traces(pkg, dtype, pieces):
    return [trace(pkg, samples(dtype, seed=i, n=n)) if start == 0 else
            pkg.stream.Trace(samples(dtype, seed=i, n=n), pkg.stream.Stats(
                network="IM", station="H03S1", location="", channel="EDH",
                starttime=T0 + pd.Timedelta(seconds=start / FS),
                sampling_rate=FS))
            for i, (start, n) in enumerate(pieces)]


@pytest.mark.parametrize("owned", [False, True], ids=["alone", "owned"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pieces", [[(0, N)], [(0, 100), (150, 100)],
                                    [(0, 300), (200, 300)]],
                         ids=["one", "gap", "overlap"])
def test_merge_matches_the_carried_merge(pieces, dtype, owned):
    """``Stream.merge`` gives the JAX package's Traces; a merged window's
    one float64 trace that the chain owns goes through without a copy."""
    want = xcorr_tpu.stream.Stream(merge_traces(xcorr_tpu, dtype, pieces)) \
        .merge(method=1, fill_value="interpolate")
    with _steps.chain():
        traces = merge_traces(xt, dtype, pieces)
        if owned:
            for tr in traces:
                _steps.own(tr.data)
        got = xt.stream.Stream(traces).merge(method=1,
                                             fill_value="interpolate")
    assert len(got) == len(want) == 1
    assert bits(got[0].data) == bits(want[0].data)
    assert got[0].stats.npts == want[0].stats.npts
    assert (got[0].data is traces[0].data) == (
        owned and len(pieces) == 1 and dtype != "int32")


def test_own_is_scoped_to_the_chain_and_its_thread():
    import threading
    x = np.zeros(4)
    assert not _steps.owns(_steps.own(x))
    with _steps.chain():
        _steps.own(x)
        assert _steps.owns(x) and not _steps.owns(x[:2])
        seen = []
        t = threading.Thread(target=lambda: seen.append(_steps.owns(x)))
        t.start()
        t.join(10)
        assert seen == [False] and not t.is_alive()
        with _steps.chain():
            assert not _steps.owns(x)
        assert _steps.owns(x)
    assert not _steps.owns(x)


# --------------------------------------------------- whole windows on disk


def write_day(root, net, sta, loc, cha, fs, seed, seconds=3600.0):
    rng = np.random.default_rng(seed)
    data = np.round(1e3 * rng.standard_normal(int(seconds * fs))) \
        .astype(np.int32)
    payload = tm.encode_mseed(xt.stream.Trace(data, xt.stream.Stats(
        network=net, station=sta, location=loc, channel=cha, starttime=T0,
        sampling_rate=fs)))
    path = tsds.sds_path(str(root), net, sta, loc, cha, T0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("sds")
    write_day(root, "IM", "H03S1", "", "EDH", FS, 1)
    write_day(root, "IU", "RAR", "10", "BHZ", 40.0, 2)
    return str(root)


@pytest.fixture(autouse=True)
def fresh_caches():
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()
    yield
    _daycache.DAYS.clear()
    _response.RESPONSES.clear()


def window(pkg, root, receiver):
    cha = receiver.split(".")[3]
    s = pkg.stream
    inv = s.Inventory([
        s.Channel("IM", "H03S1", "", "EDH", latitude=0.0, longitude=0.0,
                  response=s.PAZResponse(sensitivity=1.5e9)),
        s.Channel("IU", "RAR", "10", "BHZ", latitude=0.0, longitude=0.0,
                  response=s.PAZResponse(**PAZ))])
    return s.Client(sds_root=root).get_processed_waveforms(
        receiver, "2014-01-02T00:30", {cha: CHAINS[cha]}, duration=1800.0,
        inventory=inv, sampling_rate=50.0, strict=True)


@pytest.mark.parametrize("receiver", ["IM.H03S1..EDH", "IU.RAR.10.BHZ"])
def test_window_chain_matches_the_carried_chain(archive, receiver,
                                                monkeypatch):
    """A 250 Hz EDH window and a 40 Hz BHZ one through the production
    chains: the JAX package's client's samples, and the port's carried
    forms', bit for bit; each chain's first demean works in place (on
    the window merge's array or the highpass's output)."""
    in_place = []
    real = _steps.demean

    def demean(x):
        out = real(x)
        in_place.append(out is x)
        return out
    monkeypatch.setattr(_steps, "demean", demean)
    got = window(xt, archive, receiver)
    want = window(xcorr_tpu, archive, receiver)
    assert len(got) == len(want) == 1
    assert got[0].stats.npts == want[0].stats.npts == 90_000
    assert bits(got[0].data) == bits(want[0].data)
    assert in_place[0]
    monkeypatch.setattr(client_mod, "read_window",
                        _window._read_window_plain)
    monkeypatch.setattr(client_mod, "drop_unread", _live._drop_unread_plain)
    for name in _steps.FORMS:
        monkeypatch.setattr(_steps, name, getattr(_steps, f"_{name}_plain"))
    plain = window(xt, archive, receiver)
    assert bits(plain[0].data) == bits(want[0].data)


def test_the_chain_leaves_the_cache_as_it_was(archive):
    """The day-file cache's arrays hash the same after a window's chain
    has worked in place on the window merged from them."""
    window(xt, archive, "IM.H03S1..EDH")
    before = {k: [hashlib.sha256(t.data).hexdigest() for t in v]
              for k, (v, _) in _daycache.DAYS._done.items()}
    again = window(xt, archive, "IM.H03S1..EDH")
    after = {k: [hashlib.sha256(t.data).hexdigest() for t in v]
             for k, (v, _) in _daycache.DAYS._done.items()}
    assert before and before == after
    assert bits(again[0].data) == bits(window(xcorr_tpu, archive,
                                              "IM.H03S1..EDH")[0].data)
