"""The port's ``sosfilt`` loop (``xcorr_tpu_torch/stream/_sosfilt.py`` over
``native/sosfilt.cpp``: four sections to a register where the CPU has
AVX2, scipy's schedule past 12 sections or without AVX2), against
``scipy.signal.sosfilt``, byte for byte
(``tobytes()``, so that -0.0 and +0.0, and NaNs of either sign, count as
different): sections from ``butter`` and ``cheby2``, 1 to 16 sections,
low-, high- and band-pass, and the EDH chain's own 4 and 5 sections at
250 Hz; lengths 0, 1, fewer samples than sections and odd lengths; inputs
with leading zeros, -0.0, all zeros, NaN, +-inf and subnormal numbers;
random lengths and seeds (where hypothesis is installed); eight threads
at once. Also the chain's
``filter`` and ``decimate`` on a window the chain owns, which run the
native loop, against the JAX package's carried steps. All samples come
from seeded numpy generators.
"""
import threading

import numpy as np
import pytest
import scipy.signal as sp_signal
from scipy.signal._sosfilt import _sosfilt as scipy_loop

import xcorr_tpu
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.stream import _sosfilt, _steps
from xcorr_tpu_torch.stream._sosfilt import sosfilt_inplace

FS = 250.0
#: the EDH chain's bandpass (``Trace.filter``, 4 sections) and the
#: anti-alias low-pass of its ``decimate`` by 5 (5 sections)
EDH_BANDPASS = sp_signal.butter(4, [3.0 / 125.0, 20.0 / 125.0],
                                btype="bandpass", output="sos")
EDH_LOWPASS = sp_signal.cheby2(10, 96, 0.98 * 25.0, btype="lowpass", fs=FS,
                               output="sos")


def design(kind, btype, sections):
    """``sections`` second-order sections of a ``kind`` filter."""
    order = sections if btype == "bandpass" else 2 * sections
    wn = [0.1, 0.3] if btype == "bandpass" else 0.2
    if kind == "butter":
        sos = sp_signal.butter(order, wn, btype=btype, output="sos")
    else:
        sos = sp_signal.cheby2(order, 60, wn, btype=btype, output="sos")
    assert sos.shape == (sections, 6)
    return sos


def held(sos, x):
    """The native loop gives ``scipy.signal.sosfilt``'s bytes, in its
    dtype and shape."""
    want = sp_signal.sosfilt(sos, x)
    got = sosfilt_inplace(sos, x.copy())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def signal(n, seed=0, kind="noise"):
    rng = np.random.default_rng(seed)
    x = 1e3 * rng.standard_normal(n)
    if kind == "leading_zeros":
        x[:n // 2] = 0.0
    elif kind == "negative_zeros":
        x[:n // 2] = -0.0
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "all_negative_zeros":
        x[:] = -0.0
    elif kind == "nan_inf" and n:
        x[rng.integers(0, n, 3)] = [np.nan, np.inf, -np.inf]
    elif kind == "subnormal":
        x *= 1e-320
    return x


KINDS = ["noise", "leading_zeros", "negative_zeros", "zeros",
         "all_negative_zeros", "nan_inf", "subnormal"]


@pytest.mark.parametrize("sections", list(range(1, 17)))
@pytest.mark.parametrize("btype", ["lowpass", "highpass", "bandpass"])
@pytest.mark.parametrize("kind", ["butter", "cheby2"])
def test_sections_match_scipy(kind, btype, sections):
    """Every cascade of 1 to 16 sections (up to 12 on the wavefront, past
    it on scipy's own schedule) at a short, a prime and an odd length."""
    sos = design(kind, btype, sections)
    for n in (1, sections - 1 or 1, sections, sections + 1, 257, 4001):
        held(sos, signal(n, seed=n))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 9, 101, 50_001])
@pytest.mark.parametrize("sos", [EDH_BANDPASS, EDH_LOWPASS],
                         ids=["bandpass4", "lowpass5"])
@pytest.mark.parametrize("kind", KINDS)
def test_edh_sections_match_scipy(kind, sos, n):
    """The EDH chain's exact sections at lengths below, at and past their
    count, on every kind of input: the signs of zeros, NaN and inf, and
    subnormal numbers come out as scipy's."""
    held(sos, signal(n, seed=n, kind=kind))


@pytest.mark.parametrize("sos", [EDH_BANDPASS, EDH_LOWPASS,
                                 design("butter", "highpass", 13)],
                         ids=["bandpass4", "lowpass5", "highpass13"])
def test_zeros_and_nans_of_either_sign(sos):
    """Inputs that make scipy's states -0.0 and NaNs of either sign meet
    in one section: the first operand's NaN wins, as in scipy's loop."""
    x = np.zeros(64)
    x[1::4] = -0.0
    x[5] = np.nan
    x[9] = -np.nan
    x[13] = np.inf
    x[20] = -np.inf
    x[30] = 5e-324
    x[31] = -5e-324
    held(sos, x)
    held(sos, -x)


def test_length_zero():
    """An empty vector comes back empty, as from scipy's loop (scipy's
    public ``sosfilt`` may refuse it; the chain's step sends it there)."""
    x = np.empty(0)
    assert sosfilt_inplace(EDH_BANDPASS, x) is x and x.size == 0
    y = np.empty(0)
    scipy_loop(EDH_BANDPASS.copy(), y.reshape(1, -1), np.zeros((1, 4, 2)))
    assert y.size == 0


def test_random_lengths_and_seeds():
    """Random stable sections (real poles) on random lengths, seeds and
    kinds of input."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None)
    @given(n=st.integers(0, 3000), seed=st.integers(0, 2**32 - 1),
           sections=st.integers(1, 14), kind=st.sampled_from(KINDS))
    def case(n, seed, sections, kind):
        rng = np.random.default_rng(seed)
        p = rng.uniform(-0.9, 0.9, (sections, 2))
        sos = np.concatenate([rng.standard_normal((sections, 3)),
                              np.ones((sections, 1)),
                              -(p[:, :1] + p[:, 1:]), p[:, :1] * p[:, 1:]],
                             axis=1)
        x = signal(n, seed=seed % 1000, kind=kind)
        want = x.copy()
        scipy_loop(sos, want.reshape(1, -1), np.zeros((1, sections, 2)))
        assert sosfilt_inplace(sos, x.copy()).tobytes() == want.tobytes()
        if n:
            assert want.tobytes() == sp_signal.sosfilt(sos, x).tobytes()

    case()


def test_eight_threads_at_once():
    """Eight threads filter eight signals at once, each getting its own
    bytes (the library's calls release the interpreter lock)."""
    xs = [signal(200_003, seed=s) for s in range(8)]
    want = [sp_signal.sosfilt(EDH_LOWPASS, x).tobytes() for x in xs]
    got = [x.copy() for x in xs]
    start = threading.Barrier(8)

    def run(x):
        start.wait(10)
        for _ in range(3):
            sosfilt_inplace(EDH_BANDPASS, x.copy())
        sosfilt_inplace(EDH_LOWPASS, x)

    threads = [threading.Thread(target=run, args=(x,)) for x in got]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert [x.tobytes() for x in got] == want


def test_lanes_where_the_cpu_has_avx2():
    """The library reports whether it runs on lanes, as the CPU's flags
    say (Linux reports them in /proc/cpuinfo)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = f.read()
    except OSError:
        pytest.skip("no /proc/cpuinfo")
    assert _sosfilt.lanes() == (" avx2" in flags)


@pytest.mark.parametrize("bad", ["float32", "strided", "readonly", "2d"])
def test_refuses_what_it_cannot_filter_in_place(bad):
    x = np.zeros(16)
    if bad == "float32":
        x = x.astype(np.float32)
    elif bad == "strided":
        x = x[::2]
    elif bad == "readonly":
        x.flags.writeable = False
    else:
        x = x.reshape(4, 4)
    with pytest.raises(ValueError):
        sosfilt_inplace(EDH_BANDPASS, x)
    sos = EDH_BANDPASS.copy()
    sos[1, 3] = 2.0
    with pytest.raises(ValueError):
        sosfilt_inplace(sos, np.zeros(16))


def trace(pkg, data):
    return pkg.stream.Trace(data, pkg.stream.Stats(
        network="IM", station="H03S1", location="", channel="EDH",
        starttime="2014-01-02", sampling_rate=FS))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 6, 20_001])
def test_chain_steps_run_the_native_loop(n, monkeypatch):
    """On a float64 window the chain owns, ``filter`` and ``decimate`` run
    the native loop over it, and give the JAX package's carried steps'
    bytes; on an array the chain does not own the bandpass goes through
    scipy, as the carried step does, and ``decimate`` then owns the
    bandpass's output."""
    calls = []
    real = _steps.sosfilt_inplace

    def spy(sos, x):
        calls.append(sos.shape[0])
        return real(sos, x)
    monkeypatch.setattr(_steps, "sosfilt_inplace", spy)
    x = signal(n, seed=n)
    want = trace(xcorr_tpu, x.copy())
    want.filter("bandpass", freqmin=3.0, freqmax=20.0)
    want.decimate(5)
    for owned in (True, False):
        with _steps.chain():
            data = x.copy()
            if owned:
                _steps.own(data)
            got = trace(xt, data)
            got.filter("bandpass", freqmin=3.0, freqmax=20.0)
            got.decimate(5)
        assert got.data.tobytes() == want.data.tobytes()
        assert calls == ([4, 5] if owned else [5])
        del calls[:]


def test_empty_window_takes_scipys_path():
    """An empty window the chain owns goes to scipy's public ``sosfilt``,
    so the step returns or raises as the carried step does."""
    def outcome(fn):
        try:
            return "value", fn().tobytes()
        except Exception as e:  # the carried step's own failure
            return "raises", type(e)

    want = outcome(lambda: sp_signal.sosfilt(EDH_BANDPASS, np.empty(0)))
    with _steps.chain():
        got = outcome(lambda: _steps.sosfilt(EDH_BANDPASS,
                                             _steps.own(np.empty(0))))
    assert got == want


def test_a_failed_build_raises(monkeypatch):
    """A library that does not build raises; nothing gives way to scipy."""
    import subprocess

    from xcorr_tpu_torch.native import _cxx

    def broken(*a, **kw):
        raise subprocess.CalledProcessError(1, "g++")
    monkeypatch.setattr(_sosfilt, "_lib", None)
    monkeypatch.setattr(_cxx, "build", broken)
    with _steps.chain():
        x = _steps.own(signal(64))
        with pytest.raises(subprocess.CalledProcessError):
            _steps.sosfilt(EDH_BANDPASS, x)
