"""``remove_response``'s division in the fetch thread's arrays
(``xcorr_tpu_torch/stream/_steps.py`` ``deconvolve``, called by the
carried ``Trace.remove_response``).

The form casts only what is not float64, transforms into the thread's
scratch spectrum, multiplies in place and transforms back into a buffer
of the chain, whose first ``n`` samples become the trace's data. Its
samples must be the JAX package's ``Trace.remove_response`` on the CPU
and the carried expressions' (``_deconvolve_plain``) bit for bit
(tolerance 0): int32, float32 and float64 input, odd and even lengths,
with and without ``pre_filt``, for DISP, VEL and ACC, outside a chain
and in two chains of one thread (the second on the arrays the first
gave back). Then: the scratch spectrum is the same array on every call
of a thread; a caller's array is never written; an output that
something still holds is never handed out again and never overwritten
by the next window, while one that nothing holds is; where ``np.fft``
lacks ``out=`` the form is the carried one; a thread keeps one array per
key and at most ``KEEP_BYTES``; and the production BHZ and BHR chains
through ``Client.get_processed_waveforms`` give the plain path's bytes
on buffers their thread keeps. All samples come from seeded numpy
generators.
"""
import copy
import hashlib
import os

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.native import mseed as tm
from xcorr_tpu_torch.scripts.cc import default_config
from xcorr_tpu_torch.stream import _daycache, _live, _response, _steps
from xcorr_tpu_torch.stream import _window
from xcorr_tpu_torch.stream import client as client_mod
from xcorr_tpu_torch.stream import sds as tsds
from xcorr_tpu_torch.stream._fftlen import next_fast_len

FS = 40.0
SEED_ID = ("IU", "RAR", "10", "BHZ")
PRE_FILT = (0.01, 0.02, 8.0, 9.0)
PAZ = {"poles": [-0.037 + 0.037j, -0.037 - 0.037j], "zeros": [0j, 0j],
       "gain": 1.0, "sensitivity": 2.5e8}
#: an even and an odd length (nfft 8192 and 9216)
LENGTHS = [4_000, 4_501]
DTYPES = [np.int32, np.float32, np.float64]
OUTPUTS = ["DISP", "VEL", "ACC"]


@pytest.fixture(autouse=True)
def fresh():
    """Empty caches, and nothing kept by this thread."""
    def clear():
        _daycache.DAYS.clear()
        _response.RESPONSES.clear()
        _steps._local.__dict__.pop("kept", None)
    clear()
    yield
    clear()


def samples(n, dtype, seed=3):
    x = np.random.default_rng([seed, n]).normal(size=n) * 1e3
    return x.astype(dtype) if dtype != np.int32 else \
        np.round(x).astype(np.int32)


def trace(pkg, data):
    net, sta, loc, cha = SEED_ID
    return pkg.stream.Trace(data, {"network": net, "station": sta,
                                   "location": loc, "channel": cha,
                                   "sampling_rate": FS,
                                   "starttime": "2014-01-01"})


def inventory(pkg):
    return pkg.stream.Inventory([pkg.stream.Channel(
        *SEED_ID, latitude=-21.2, longitude=-159.8,
        response=pkg.stream.PAZResponse(**copy.deepcopy(PAZ)))])


def remove(pkg, data, output="VEL", pre_filt=None):
    tr = trace(pkg, data)
    tr.remove_response(inventory=inventory(pkg), output=output,
                       water_level=60.0, pre_filt=pre_filt)
    return tr.data


def kept(kind=None):
    """This thread's kept arrays by key (only scratch ones, or only
    handed-out ones, with ``kind``)."""
    out = dict(getattr(_steps._local, "kept", None) or {})
    if kind == "scratch":
        return {k: a for k, a in out.items() if k[2] == "scratch"}
    if kind == "buffer":
        return {k: a for k, a in out.items() if k[2] != "scratch"}
    return out


@pytest.mark.parametrize("n", LENGTHS, ids=["even", "odd"])
@pytest.mark.parametrize("pre_filt", [None, PRE_FILT],
                         ids=["no_pre_filt", "pre_filt"])
@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("dtype", DTYPES,
                         ids=[np.dtype(d).name for d in DTYPES])
def test_matches_reference_and_plain(dtype, output, pre_filt, n,
                                     monkeypatch):
    data = samples(n, dtype)
    want = remove(xcorr_tpu, data, output, pre_filt)
    assert want.dtype == np.float64 and want.shape == (n,)
    assert np.isfinite(want).all()
    with monkeypatch.context() as m:
        m.setattr(_steps, "deconvolve", _steps._deconvolve_plain)
        plain = remove(xt, data, output, pre_filt)
    assert plain.tobytes() == want.tobytes()
    # outside a chain, then in two chains of one thread: the second runs
    # on the spectrum and the output the first gave back
    assert remove(xt, data, output, pre_filt).tobytes() == want.tobytes()
    before = data.tobytes()
    for _ in range(2):
        with _steps.chain():
            got = remove(xt, data, output, pre_filt)
            assert got.tobytes() == want.tobytes()
            del got
    assert data.tobytes() == before
    nfft = next_fast_len(2 * n)
    assert set(kept()) == {((nfft // 2 + 1,), "<c16", "scratch"),
                           ((nfft,), "<f8", 0)}


def test_scratch_spectrum_is_reused(monkeypatch):
    """Every ``rfft`` of a thread's chains writes into one array, within
    a chain (two components) and across chains; outside a chain each
    call has a fresh one."""
    data = samples(4_000, np.float64)
    want = remove(xcorr_tpu, data)
    outs = []
    real = np.fft.rfft

    def spy(*a, out=None, **kw):
        outs.append(out)
        return real(*a, out=out, **kw)
    monkeypatch.setattr(np.fft, "rfft", spy)
    for _ in range(2):
        with _steps.chain():
            for _ in range(2):
                assert remove(xt, data).tobytes() == want.tobytes()
    assert len(outs) == 4 and outs[0] is not None
    assert all(o is outs[0] for o in outs)
    [spec] = kept("scratch").values()
    assert spec is outs[0]
    del outs[:]
    _steps._local.__dict__.pop("kept")
    remove(xt, data)
    remove(xt, data)
    assert len(outs) == 2 and outs[0] is not outs[1]
    assert kept() == {}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_caller_array_is_never_written(dtype):
    """The caller's samples (float64, read as they are; float32, cast)
    stay as they were, share no memory with the output, and the output
    shares none with what the thread keeps."""
    data = samples(4_501, dtype)
    before = data.tobytes()
    with _steps.chain():
        out = remove(xt, data)
    assert data.tobytes() == before
    assert not np.shares_memory(out, data)
    assert all(not np.shares_memory(out, a) for a in kept().values())


def address(a):
    return a.__array_interface__["data"][0]


def test_held_output_is_never_handed_out_again():
    """A window's output that something still holds after its chain (a
    view of the chain's buffer) keeps its buffer out of the thread's
    hands: the next window's output is another array, and the first is
    unchanged. Once nothing holds an output, its buffer serves the next
    window."""
    a, b, c = (samples(4_000, np.float64, seed) for seed in (3, 4, 5))
    want = {k: remove(xcorr_tpu, x).tobytes()
            for k, x in (("a", a), ("b", b), ("c", c))}
    with _steps.chain():
        held = remove(xt, a)
    assert held.base is not None and held.base.size > held.size
    assert kept("buffer") == {}
    with _steps.chain():
        second = remove(xt, b)
        assert not np.shares_memory(second, held)
        assert second.tobytes() == want["b"]
        base = address(second.base)
        del second
    assert held.tobytes() == want["a"]
    [buf] = kept("buffer").values()
    assert address(buf) == base and not np.shares_memory(buf, held)
    del buf
    with _steps.chain():
        third = remove(xt, c)
        assert address(third.base) == base
    assert third.tobytes() == want["c"]
    assert held.tobytes() == want["a"]
    assert kept("buffer") == {}


def test_steps_after_it_write_the_output_in_place():
    """The output is the chain's own: a step after it (here the BHZ
    chain's highpass) writes it in place, and its buffer goes back once
    the chain's later step has made a new array."""
    data = samples(4_000, np.float64)
    tr = trace(xcorr_tpu, data)
    tr.remove_response(inventory=inventory(xcorr_tpu))
    want = tr.filter("highpass", freq=3.0).data.tobytes()
    with _steps.chain():
        tr = trace(xt, data)
        tr.remove_response(inventory=inventory(xt))
        out = tr.data
        assert _steps.owns(out)
        tr.filter("highpass", freq=3.0)
        assert tr.data is out
        assert out.tobytes() == want
        tr.data = out[::2].copy()
        del out
    assert len(kept("buffer")) == 1


def test_without_fft_out_the_form_is_the_carried_one(monkeypatch):
    """Where ``np.fft`` takes no ``out=`` (numpy before 2.0: the form
    reads the signature at import), the carried expressions run, and
    the thread keeps nothing."""
    monkeypatch.setattr(_steps, "_FFT_OUT", False)
    data = samples(4_501, np.int32)
    want = remove(xcorr_tpu, data, "DISP", PRE_FILT)
    with _steps.chain():
        got = remove(xt, data, "DISP", PRE_FILT)
    assert got.tobytes() == want.tobytes()
    assert kept() == {}


def test_one_array_per_key():
    """Two arrays of one shape and dtype held at once in a chain take two
    keys, which the next chain takes in the same order."""
    with _steps.chain():
        one = _steps.buffer((1000,), np.float64)
        two = _steps.buffer((1000,), np.float64)
        other = _steps.buffer((10,), np.int32)
        addresses = [address(one), address(two), address(other)]
        del one, two, other
    assert set(kept()) == {((1000,), "<f8", 0), ((1000,), "<f8", 1),
                           ((10,), "<i4", 0)}
    with _steps.chain():
        again = [_steps.buffer((1000,), np.float64),
                 _steps.buffer((1000,), np.float64),
                 _steps.buffer((10,), np.int32)]
        assert [address(x) for x in again] == addresses
        del again
    assert len(kept()) == 3


def test_the_bound_drops_the_least_recently_kept(monkeypatch):
    """Past ``KEEP_BYTES`` the array kept longest ago goes first, and a
    single array over the bound is not kept."""
    monkeypatch.setattr(_steps, "KEEP_BYTES", 20_000)
    for n in (1000, 1200, 500):
        with _steps.chain():
            x = _steps.buffer((n,), np.float64)
            del x
    assert list(kept()) == [((1200,), "<f8", 0), ((500,), "<f8", 0)]
    with _steps.chain():
        huge = _steps.buffer((3000,), np.float64)
        del huge
    assert list(kept()) == [((1200,), "<f8", 0), ((500,), "<f8", 0)]


def test_nothing_is_kept_where_the_probe_cannot_tell(monkeypatch):
    """``_ALONE`` None: no handed-out array and no scratch goes back."""
    monkeypatch.setattr(_steps, "_ALONE", None)
    data = samples(4_000, np.float64)
    want = remove(xcorr_tpu, data).tobytes()
    for _ in range(2):
        with _steps.chain():
            assert remove(xt, data).tobytes() == want
    assert kept() == {}


# -- the production BH chains through the fetch -----------------------------

DAY = pd.Timestamp("2014-01-02")
CHAINS = default_config()[0]["preprocess"]
TIMES = ["2014-01-02T00:30", "2014-01-02T00:31"]


def write(root, cha, seed, seconds=3600.0):
    rng = np.random.default_rng(seed)
    data = np.round(1e3 * rng.standard_normal(int(seconds * FS))) \
        .astype(np.int32)
    net, sta, loc, _ = SEED_ID
    payload = tm.encode_mseed(xt.stream.Trace(data, xt.stream.Stats(
        network=net, station=sta, location=loc, channel=cha,
        starttime=DAY, sampling_rate=FS)))
    path = tsds.sds_path(str(root), net, sta, loc, cha, DAY)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("sds")
    for seed, cha in enumerate(("BH1", "BH2", "BHZ"), 3):
        write(root, cha, seed)
    return str(root)


def bh_inventory():
    s = xt.stream
    return s.Inventory([s.Channel("IU", "RAR", "10", cha, latitude=-21.2,
                                  longitude=-159.8,
                                  response=s.PAZResponse(**PAZ))
                        for cha in ("BHR", "BH1", "BH2", "BHZ")])


def fetch(root, cha, time):
    return xt.stream.Client(sds_root=root).get_processed_waveforms(
        f"IU.RAR.10.{cha}", time, {cha: CHAINS[cha]}, duration=1800.0,
        inventory=bh_inventory(), sampling_rate=50.0, strict=True)


def plain_path(monkeypatch):
    """The carried read, response, chain and steps."""
    monkeypatch.setattr(client_mod, "read_window",
                        _window._read_window_plain)
    monkeypatch.setattr(_response, "inverse_response",
                        _response._inverse_response_plain)
    monkeypatch.setattr(client_mod, "drop_unread", _live._drop_unread_plain)
    for name in _steps.FORMS:
        monkeypatch.setattr(_steps, name, getattr(_steps, f"_{name}_plain"))


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@pytest.mark.parametrize("cha", ["BHZ", "BHR"])
def test_bh_chain_matches_the_plain_path(archive, cha, monkeypatch):
    """Two windows of the production chain in one thread: the plain
    path's bytes; the second window's ``remove_response`` outputs (one
    for BHZ, BH1's and BH2's for BHR) are the buffers the first window's
    gave back, and the first window's output is unchanged by it."""
    with monkeypatch.context() as m:
        plain_path(m)
        want = [fetch(archive, cha, t)[0].data.tobytes() for t in TIMES]
    bases = []
    real = _steps.deconvolve

    def spy(*a):
        out = real(*a)
        bases.append(out.base.__array_interface__["data"][0])
        return out
    monkeypatch.setattr(_steps, "deconvolve", spy)
    first = fetch(archive, cha, TIMES[0])[0].data
    before = sha(first)
    second = fetch(archive, cha, TIMES[1])[0].data
    assert first.tobytes() == want[0] and second.tobytes() == want[1]
    assert sha(first) == before
    per = 1 if cha == "BHZ" else 2
    assert len(bases) == 2 * per
    assert bases[per:] == bases[:per] and len(set(bases[:per])) == per
    assert all(not np.shares_memory(first, a) for a in kept().values())
    assert sum(k[2] == "scratch" for k in kept()) == 1
