"""The port's host ``Trace.remove_response``, with its inverse response
cached per response values and grid (``stream/_response.py``), against
the JAX package's on the CPU.

Both sides run the same float64 numpy expressions in the same order on the
same seeded trace, so the samples must be equal bit for bit (tolerance
0), on the call that fills the cache and on the one that finds it. The
matrix: a two-pole and a many-pole response and ``inventory=None``;
outputs DISP, VEL and ACC; input units M, M/S and PA; ``pre_filt`` given
and not; odd and even lengths. Then: two lengths in one process, a
response changed in place between calls, and 16 threads (the host engine
fetches in 8) on one grid, which evaluate the response once.
"""
import copy
import sys
import threading
import time

import numpy as np
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu_torch.stream import _response
from xcorr_tpu_torch.stream.inventory import PAZResponse

FS = 40.0
SEED_ID = ("IU", "RAR", "10", "BHZ")
PRE_FILT = (0.01, 0.02, 8.0, 9.0)
#: response -> PAZ: the production BHZ's two poles, and a broadband
#: seismometer's many
RESPONSES = {
    "two_pole": dict(poles=[-0.037 + 0.037j, -0.037 - 0.037j],
                     zeros=[0j, 0j], gain=1.0, sensitivity=2.5e8),
    "many_pole": dict(poles=[-0.03701 + 0.03701j, -0.03701 - 0.03701j,
                             -251.3 + 0j, -131.0 + 467.3j,
                             -131.0 - 467.3j, -15.99 + 0j,
                             -10.5 + 0.2j, -10.5 - 0.2j],
                      zeros=[0j, 0j, -31.63 + 0j, -160.0 + 0j,
                             -350.0 + 0j, -3177.0 + 0j],
                      gain=6.0077e7, sensitivity=1.5e9),
}
UNITS = ["M", "M/S", "PA"]
OUTPUTS = ["DISP", "VEL", "ACC"]
#: an even and an odd length on two grids (nfft 8192 and 9216)
LENGTHS = [4_000, 4_501]


@pytest.fixture(autouse=True)
def fresh_cache():
    _response.RESPONSES.clear()
    yield
    _response.RESPONSES.clear()


@pytest.fixture
def evaluations(monkeypatch):
    """The port's ``PAZResponse.evaluate`` calls, counted."""
    calls = []
    real = PAZResponse.evaluate

    def counted(self, freqs, output="VEL"):
        calls.append(freqs.size)
        return real(self, freqs, output=output)

    monkeypatch.setattr(PAZResponse, "evaluate", counted)
    return calls


def _trace(pkg, n, seed=3):
    data = np.random.default_rng([seed, n]).normal(size=n) * 1e3
    net, sta, loc, cha = SEED_ID
    return pkg.stream.Trace(data, {"network": net, "station": sta,
                                   "location": loc, "channel": cha,
                                   "sampling_rate": FS,
                                   "starttime": "2014-01-01"})


def _inventory(pkg, paz, units):
    """An inventory of its own: its response's lists are copies."""
    return pkg.stream.Inventory([pkg.stream.Channel(
        *SEED_ID, latitude=-21.2, longitude=-159.8,
        response=pkg.stream.PAZResponse(**copy.deepcopy(paz),
                                        input_units=units))])


def _remove(pkg, n, inventory, output, pre_filt, seed=3):
    tr = _trace(pkg, n, seed)
    tr.remove_response(inventory=inventory, output=output,
                       water_level=60.0, pre_filt=pre_filt)
    return tr.data


CASES = [(resp, units) for resp in sorted(RESPONSES) for units in UNITS] \
    + [("flat", None)]


@pytest.mark.parametrize("n", LENGTHS, ids=["even", "odd"])
@pytest.mark.parametrize("pre_filt", [None, PRE_FILT],
                         ids=["no_pre_filt", "pre_filt"])
@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("resp,units", CASES,
                         ids=[f"{r}-{u}" for r, u in CASES])
def test_remove_response_matches_reference(resp, units, output, pre_filt,
                                           n, evaluations):
    def inventory(pkg):
        return None if resp == "flat" else \
            _inventory(pkg, RESPONSES[resp], units)

    want = _remove(xcorr_tpu, n, inventory(xcorr_tpu), output, pre_filt)
    assert want.shape == (n,) and np.isfinite(want).all()
    for seed in (3, 3, 4):
        got = _remove(xcorr_tpu_torch, n, inventory(xcorr_tpu_torch),
                      output, pre_filt, seed)
        if seed == 4:
            want = _remove(xcorr_tpu, n, inventory(xcorr_tpu), output,
                           pre_filt, seed)
        assert got.tobytes() == want.tobytes()
    # one evaluation, then the cache: a new inventory object of the same
    # values, and another trace, find it
    assert len(evaluations) == 1
    ((inv_r, taper),) = [v for v, _ in _response.RESPONSES._done.values()]
    assert not inv_r.flags.writeable
    assert (taper is None) == (pre_filt is None)
    assert taper is None or not taper.flags.writeable


def test_two_lengths_in_one_process(evaluations):
    """Two grids, each inverted once, each trace divided by its own."""
    inv = {pkg: _inventory(pkg, RESPONSES["many_pole"], "M/S")
           for pkg in (xcorr_tpu, xcorr_tpu_torch)}
    for n in (*LENGTHS, *LENGTHS[::-1]):
        got = _remove(xcorr_tpu_torch, n, inv[xcorr_tpu_torch], "VEL", None)
        want = _remove(xcorr_tpu, n, inv[xcorr_tpu], "VEL", None)
        assert got.tobytes() == want.tobytes()
    assert len(evaluations) == 2 and len(_response.RESPONSES._done) == 2


def test_every_key_part_in_one_process(evaluations):
    """Outputs, tapers and water levels on one response and grid, twice
    over without clearing the cache: one entry per combination, each
    trace the reference's."""
    inv = {pkg: _inventory(pkg, RESPONSES["many_pole"], "M")
           for pkg in (xcorr_tpu, xcorr_tpu_torch)}
    combos = [(output, pre_filt, level) for output in OUTPUTS
              for pre_filt in (None, PRE_FILT, (0.02, 0.04, 6.0, 8.0))
              for level in (60.0, 30.0)]
    for _ in range(2):
        for output, pre_filt, level in combos:
            data = {}
            for pkg in inv:
                tr = _trace(pkg, 4_000)
                tr.remove_response(inventory=inv[pkg], output=output,
                                   water_level=level, pre_filt=pre_filt)
                data[pkg] = tr.data
            assert data[xcorr_tpu_torch].tobytes() == \
                data[xcorr_tpu].tobytes()
    assert len(evaluations) == len(combos) == len(_response.RESPONSES._done)


def test_response_changed_in_place_gets_a_new_entry(evaluations):
    """A pole, the gain, the units, each changed in place on the same
    object: a new entry each, and the samples the reference's for the
    values at the call."""
    invs = {pkg: _inventory(pkg, RESPONSES["two_pole"], "M/S")
            for pkg in (xcorr_tpu, xcorr_tpu_torch)}
    changes = [lambda r: None,
               lambda r: r.poles.__setitem__(0, -0.05 + 0.05j),
               lambda r: setattr(r, "gain", 2.0),
               lambda r: setattr(r, "input_units", "M"),
               lambda r: r.zeros.pop()]
    for i, change in enumerate(changes):
        for pkg, inv in invs.items():
            change(inv.channels[0].response)
        got = _remove(xcorr_tpu_torch, 4_000, invs[xcorr_tpu_torch], "VEL",
                      None)
        want = _remove(xcorr_tpu, 4_000, invs[xcorr_tpu], "VEL", None)
        assert got.tobytes() == want.tobytes()
        assert len(evaluations) == i + 1
    # equal values of another type or sign are other keys
    key = _response._key
    resp = PAZResponse(**RESPONSES["two_pole"])
    base = key(resp, 8, 0.025, "VEL", 60.0, None)
    assert base == key(PAZResponse(**RESPONSES["two_pole"]), 8, 0.025,
                       "vel", 60.0, None)
    assert base != key(resp, 8, np.float32(0.025), "VEL", 60.0, None)
    assert base != key(resp, 8, 0.025, "VEL", np.float32(60.0), None)
    resp.zeros = [complex(-0.0, 0.0), 0j]
    assert base != key(resp, 8, 0.025, "VEL", 60.0, None)


def test_threads_on_one_grid_evaluate_once(evaluations, monkeypatch):
    """16 threads, more than this machine's cores, with a short switch
    interval and a slow evaluation, all on one grid: one evaluation,
    every trace the reference's."""
    real = _response._inverse_response_plain

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    monkeypatch.setattr(_response, "_inverse_response_plain", slow)
    nthreads = 16
    inv = _inventory(xcorr_tpu_torch, RESPONSES["many_pole"], "M/S")
    want = [_remove(xcorr_tpu, 4_501, _inventory(
        xcorr_tpu, RESPONSES["many_pole"], "M/S"), "VEL", PRE_FILT, seed)
        for seed in range(nthreads)]
    gate = threading.Barrier(nthreads)
    got = [None] * nthreads

    def worker(i):
        gate.wait(timeout=30)
        got[i] = _remove(xcorr_tpu_torch, 4_501, inv, "VEL", PRE_FILT, i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(evaluations) == 1
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_cache_is_bounded(evaluations, monkeypatch):
    """With room for one grid's arrays, a second grid evicts the first,
    which is then evaluated again."""
    nbytes = (9_216 // 2 + 1) * 16
    monkeypatch.setattr(_response, "MAX_BYTES", nbytes)
    inv = _inventory(xcorr_tpu_torch, RESPONSES["two_pole"], "M/S")
    for n in (4_000, 4_000, 4_501, 4_000):
        _remove(xcorr_tpu_torch, n, inv, "VEL", None)
    assert len(evaluations) == 3
    assert _response.RESPONSES.nbytes <= nbytes
