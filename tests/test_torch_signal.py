"""The signal ops of the PyTorch port's analysis slice (``xcorr_tpu_torch/
signal/`` and ``ops/{timeshift,spectrogram}.py``) against the JAX
package's on the CPU, on the same seeded numpy inputs, labelled alike by
both packages' ``ndlabel``.

Tolerances, as in ``tests/test_torch_preprocess.py``:

* float64: the port and the JAX package run the same algorithms, so
  outputs agree to rounding: ``rtol=1e-9`` of the output's peak. The
  host-only ops (carried copies) and the triggers must be equal.
* float32: the port's float32 output is held to the JAX package's
  float64 result on the same data: within 5e-6 of its peak for
  ``filter`` (the recursive filter's rounding grows near its poles) and
  1e-6 for the other ops.
* ``timeshift`` in float32 is held to the JAX package's float32 output
  instead, within 1e-6 of the peak: both build the phase ramp
  ``2π f delay`` in float32, whose rounding (about 2e-7 of the peak at
  these sizes; measured 2.4e-7 with delays up to 3 s) is larger than the
  FFT's. Against float64 the ramp alone would take the bar.

Under x64 (as the tests run it) the JAX package's ``hilbert`` of float32
data comes back complex128 (its mask is float64); the port keeps
complex64, as the JAX package gives without x64. Values are held at the
float32 bar.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu as J
import xcorr_tpu_torch as T
from xcorr_tpu.ops import spectrogram as jspec, timeshift as jts
from xcorr_tpu.signal.spectrogram import spectrogram_mtc as jmtc
from xcorr_tpu_torch.ops import spectrogram as tspec, timeshift as tts

RTOL64 = 1e-9
TOL32 = {"filter": 5e-6, "other": 1e-6, "timeshift": 1e-6}
FS = 5.0
ATTRS = {"institution": "t", "author": "t", "source": "t"}


def make_cc(pkg, data, fs=FS, name="cc"):
    """A (pair, time, lag) CCF-like array of ``data`` in ``pkg``."""
    npair, ntime, nlag = data.shape
    times = pd.date_range("2014-01-01", periods=ntime, freq="30min").values
    da = pkg.ndlabel.DataArray(
        data.copy(), dims=("pair", "time", "lag"),
        coords={"pair": np.array([f"A.P{i}..EDH-B.Q{i}..BHZ"
                                  for i in range(npair)], dtype=object),
                "time": times, "lag": np.arange(nlag) / fs - 20.0},
        name=name, attrs={"long_name": "Cross-correlation Estimate",
                          "standard_name": "cross-correlation_estimate",
                          "units": "-", "unbiased": np.int8(0)})
    da.coords["lag"].attrs.update({"sampling_rate": fs, "delta": 1 / fs,
                                   "units": "s"})
    da.coords["time"].attrs.update({"window_length": 3600.0,
                                    "window_overlap": 0.5})
    return da


def pulses(seed, shape=(2, 3, 401), dtype=np.float64):
    """Noise with a 1 Hz wave packet at lag 8 s on every row."""
    rng = np.random.default_rng(seed)
    lag = np.arange(shape[-1]) / FS - 20.0
    packet = 3.0 * np.exp(-((lag - 8.0) / 1.5) ** 2) * np.cos(
        2 * np.pi * 1.0 * (lag - 8.0))
    return (rng.standard_normal(shape) + 2.0 + packet).astype(dtype)


def both(data, **kw):
    return make_cc(J, data, **kw), make_cc(T, data, **kw)


def hold64(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL64 * np.abs(want).max())


def hold32(got, want, kind):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL32[kind], err


def held(jfn, tfn, kind="other", seed=0, shape=(2, 3, 401), **kw):
    """Run one op of both packages in float64, and the port in float32
    against the JAX float64 result; return both float64 outputs."""
    x64 = pulses(seed, shape)
    jx, tx = both(x64, **kw)
    want = np.asarray(jfn(jx).values)
    got = tfn(tx).values
    hold64(got, want)
    got32 = tfn(make_cc(T, x64.astype(np.float32), **kw)).values
    assert got32.dtype in (np.float32, np.complex64)
    hold32(got32, want, kind)
    return got, want


# -- ops ------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
@pytest.mark.parametrize("n", [400, 401], ids=["even", "odd"])
def test_ops_timeshift(per_row, n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, n))
    delay = rng.uniform(-3.0, 3.0, (2, 3)) if per_row else 2.3
    want = np.asarray(jts.timeshift(x, delay, 1 / FS, nfft=n))
    got = tts.timeshift(torch.from_numpy(x), delay, 1 / FS, nfft=n).numpy()
    hold64(got, want)
    x32 = x.astype(np.float32)
    want32 = np.asarray(jts.timeshift(x32, delay, 1 / FS, nfft=n))
    got32 = tts.timeshift(torch.from_numpy(x32), delay, 1 / FS,
                          nfft=n).numpy()
    assert got32.dtype == want32.dtype == np.float32
    hold32(got32, want32, "timeshift")


@pytest.mark.parametrize("hop,nfft,scaling", [(1, 100, "density"),
                                              (3, 25, "spectrum")],
                         ids=["hop1-padded", "hop3-spectrum"])
def test_ops_spectrogram(hop, nfft, scaling, monkeypatch):
    """Also in blocks of a few frames: the block size does not change
    the result."""
    x = np.random.default_rng(2).standard_normal((2, 3, 301))
    fj, want = jspec.stft_psd(x, 25, hop, nfft, sampling_rate=FS,
                              scaling=scaling)
    want = np.asarray(want)
    ft, got = tspec.stft_psd(torch.from_numpy(x), 25, hop, nfft,
                             sampling_rate=FS, scaling=scaling)
    np.testing.assert_array_equal(ft, fj)
    hold64(got.numpy(), want)
    monkeypatch.setattr(tspec, "BLOCK_ELEMENTS", 6 * nfft * 7)
    _, blocked = tspec.stft_psd(torch.from_numpy(x), 25, hop, nfft,
                                sampling_rate=FS, scaling=scaling)
    np.testing.assert_array_equal(blocked.numpy(), got.numpy())
    _, got32 = tspec.stft_psd(torch.from_numpy(x.astype(np.float32)), 25,
                              hop, nfft, sampling_rate=FS, scaling=scaling)
    hold32(got32.numpy(), want, "other")


# -- the postprocess chain's ops ------------------------------------------

@pytest.mark.parametrize("type", ["constant", "demean", "linear"])
def test_detrend(type):
    held(lambda x: J.signal.detrend(x, type=type),
         lambda x: T.signal.detrend(x, type=type, device="cpu"))


def test_detrend_unknown_type():
    tx = make_cc(T, pulses(0))
    with pytest.raises(ValueError, match="unknown detrend type"):
        T.signal.detrend(tx, type="quadratic", device="cpu")


@pytest.mark.parametrize("kw", [
    {}, {"wtype": "cosine", "max_percentage": 0.1},
    {"max_length": 5.0, "side": "left"}, {"max_length": 2.0, "side": "right"},
], ids=["default", "cosine", "left", "right"])
def test_window_and_taper(kw):
    """Host-only (carried copies): equal."""
    jx, tx = both(pulses(3))
    want = J.signal.window(jx.coords["lag"], **kw)
    got = T.signal.window(tx.coords["lag"], **kw)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.attrs == want.attrs
    want = J.signal.taper(jx, **kw)
    got = T.signal.taper(tx, **kw)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.attrs["history"].split(" ", 2)[2] == \
        want.attrs["history"].split(" ", 2)[2]


@pytest.mark.parametrize("frequency,btype", [
    (1.0, "lowpass"), (0.5, "highpass"), ((0.3, 1.5), "bandpass"),
    ((0.5, 1.2), "bandstop")])
def test_filter(frequency, btype):
    held(lambda x: J.signal.filter(x, frequency=frequency, btype=btype),
         lambda x: T.signal.filter(x, frequency=frequency, btype=btype,
                                   device="cpu"), kind="filter")


@pytest.mark.parametrize("n", [10, 11, 64, 1000],
                         ids=["padlen+1", "padlen+2", "short", "long"])
def test_filter_rows_shorter_than_a_chunk(n):
    """The chunk plan of a single short chunk (padlen = 9 for the one
    section of an order-2 highpass)."""
    held(lambda x: J.signal.filter(x, frequency=0.5),
         lambda x: T.signal.filter(x, frequency=0.5, device="cpu"),
         kind="filter", shape=(2, 3, n))


@pytest.mark.parametrize("n", [2, 9], ids=["tiny", "padlen"])
def test_filter_row_no_longer_than_padlen_raises(n):
    """Both packages raise the same ``ValueError`` (the scripts skip a
    pair on it)."""
    jx, tx = both(pulses(4, (1, 2, n)))
    with pytest.raises(ValueError) as jerr:
        J.signal.filter(jx, frequency=0.5)
    with pytest.raises(ValueError) as terr:
        T.signal.filter(tx, frequency=0.5, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "padlen (9)" in str(terr.value)


@pytest.mark.parametrize("case", ["scalar", "per-pair-time", "per-pair",
                                  "odd"])
def test_timeshift(case):
    n = 401 if case == "odd" else 400
    rng = np.random.default_rng(5)
    if case == "scalar":
        delays = (-1.7, -1.7)
    else:
        dims = ("pair",) if case == "per-pair" else ("pair", "time")
        d = rng.uniform(-3.0, 3.0, (2,) if case == "per-pair" else (2, 3))
        delays = (J.ndlabel.DataArray(d, dims=dims),
                  T.ndlabel.DataArray(d, dims=dims))
    x64 = pulses(6, (2, 3, n))
    jx, tx = both(x64)
    want = J.signal.timeshift(jx, delay=delays[0], dim="lag").values
    got = T.signal.timeshift(tx, delay=delays[1], dim="lag",
                             device="cpu").values
    hold64(got, want)
    jx32, tx32 = both(x64.astype(np.float32))
    want32 = J.signal.timeshift(jx32, delay=delays[0], dim="lag").values
    got32 = T.signal.timeshift(tx32, delay=delays[1], dim="lag",
                               device="cpu").values
    assert got32.dtype == want32.dtype == np.float32
    hold32(got32, want32, "timeshift")


def test_timeshift_checks_like_reference():
    jx, tx = both(pulses(7))
    bad = T.ndlabel.DataArray(np.zeros(401), dims=("lag",))
    with pytest.raises(ValueError, match="cannot depend"):
        T.signal.timeshift(tx, delay=bad, dim="lag", device="cpu")
    with pytest.raises(TypeError, match="float or DataArray"):
        T.signal.timeshift(tx, delay="1", dim="lag", device="cpu")


# -- SNR -> triggers -> PSD -----------------------------------------------

def test_hilbert():
    got, want = held(J.signal.hilbert,
                     lambda x: T.signal.hilbert(x, device="cpu"))
    assert got.dtype == np.complex128
    got32 = T.signal.hilbert(make_cc(T, pulses(0).astype(np.float32)),
                             device="cpu")
    assert got32.dtype == np.complex64


def test_envelope():
    held(J.signal.envelope, lambda x: T.signal.envelope(x, device="cpu"))
    got32 = T.signal.envelope(make_cc(T, pulses(0).astype(np.float32)),
                              device="cpu")
    assert got32.dtype == np.float32
    assert got32.attrs["long_name"].startswith("Absolute")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
def test_absolute(dtype):
    x = pulses(8).astype(dtype)
    if np.iscomplexobj(x):
        x = x + 1j * pulses(9).astype(dtype)
    jx, tx = both(x)
    want, got = J.signal.absolute(jx), T.signal.absolute(tx)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("dim", ["lag", "time"])
def test_rms(dim):
    jx, tx = both(pulses(10).astype(np.float32))
    want, got = J.signal.rms(jx, dim=dim), T.signal.rms(tx, dim=dim)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.values, want.values)


SNR_CASES = {"plain": {}, "extend": {"extend": True},
             "envelope": {"envelope": True, "extend": True},
             "power": {"power": True}, "decibels": {"decibels": True}}


@pytest.mark.parametrize("case", sorted(SNR_CASES))
def test_snr(case):
    kw = SNR_CASES[case]

    def run(pkg, x, **dev):
        lag = x.coords["lag"]
        return pkg.signal.snr(x, (lag >= 4.0) & (lag <= 12.0), lag >= 30.0,
                              dim="lag", **kw, **dev, **ATTRS)

    for dtype in (np.float64, np.float32):
        jx, tx = both(pulses(11).astype(dtype))
        want, got = run(J, jx), run(T, tx, device="cpu")
        names = ["snr", "s", "n", "lag_s_max"] if kw.get("extend") \
            else [None]
        for name in names:
            w = (want[name] if name else want).values
            g = (got[name] if name else got).values
            if name == "lag_s_max":
                np.testing.assert_array_equal(g, w)
            elif dtype == np.float64:
                hold64(g, w)
            else:
                hold32(g, w, "other")
        w, g = (want["snr"], got["snr"]) if kw.get("extend") else \
            (want, got)
        assert g.attrs == w.attrs or \
            {k: v for k, v in g.attrs.items() if k != "history"} == \
            {k: v for k, v in w.attrs.items() if k != "history"}


def snr_series(npair=3, nt=120, seed=12):
    """SNR-like series over (pair, time), 3 h steps: two coincident events
    and one on a single pair."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(1.0, 6.0, (npair, nt))
    ramp = np.linspace(12.0, 30.0, 12)
    v[:, 20:32] = ramp * rng.uniform(1.0, 1.5, (npair, 1))
    v[0, 50:62] = 20.0
    v[:, 80:92] = ramp[::-1]
    v[1, 80:92] = ramp
    t = pd.date_range("2015-01-01", periods=nt, freq="3h").values
    out = []
    for pkg in (J, T):
        da = pkg.ndlabel.DataArray(
            v.copy(), dims=("pair", "time"),
            coords={"pair": np.array([f"P{i}-Q{i}" for i in range(npair)],
                                     dtype=object), "time": t},
            name="snr", attrs={"long_name": "snr", "standard_name": "snr"})
        da.coords["time"].attrs.update({"window_length": 86400.0,
                                        "window_overlap": 0.875})
        out.append(da)
    return out


@pytest.mark.parametrize("kw", [
    {}, {"similarity_threshold": 0.9}, {"extend": 2},
    {"thr_on": 15.0, "thr_off": 8.0, "thr_coincidence_sum": 1}],
    ids=["default", "similarity", "extend", "thresholds"])
def test_coincidence_trigger(kw):
    """Host-only (carried copy): equal triggers, periods and values."""
    jx, tx = snr_series()
    kw = {"thr_on": 10.0, **kw}
    want = J.signal.coincidence_trigger(jx, dim="time", **kw)
    got = T.signal.coincidence_trigger(tx, dim="time", **kw)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.attrs["nperiods"] == want.attrs["nperiods"] >= 1
    pd.testing.assert_frame_equal(T.signal.trigger_periods(got),
                                  J.signal.trigger_periods(want))
    pd.testing.assert_frame_equal(T.signal.trigger_values(tx, got),
                                  J.signal.trigger_values(jx, want))


@pytest.mark.parametrize("kw", [
    {"duration": 2.0, "padding_factor": 2},
    {"duration": 5.0, "padding_factor": 4, "scaling": "spectrum"}],
    ids=["density", "spectrum"])
def test_spectrogram(kw):
    got, want = held(lambda x: J.signal.spectrogram(x, **kw),
                     lambda x: T.signal.spectrogram(x, device="cpu", **kw))
    assert got.shape[-2:] == (int(kw["duration"] * FS * kw["padding_factor"]
                                  ) // 2 + 1, 401)


def test_spectrogram_mtc():
    jx, tx = both(pulses(13))
    want = jmtc(jx, duration=4.0, overlap=0.75)
    got = T.signal.spectrogram_mtc(tx, duration=4.0, overlap=0.75,
                                   device="cpu")
    assert got.dims == want.dims
    hold64(got.values, want.values)
    np.testing.assert_array_equal(got.coords["lag_seg"].values,
                                  want.coords["lag_seg"].values)


# -- the accessor ---------------------------------------------------------

def _lag_masks(x):
    lag = x.coords["lag"]
    return (lag >= 4.0) & (lag <= 12.0), lag >= 30.0


def _itself(x):
    return (x,)


def _receiver_xy(x):
    """Local x/y (m) of the receivers along ``x``'s pair dim."""
    xy = np.random.default_rng(3).uniform(-2e3, 2e3, (2, x.sizes["pair"]))
    return tuple(T.ndlabel.DataArray(v, dims=("pair",),
                                     coords={"pair": x.coords["pair"]})
                 for v in xy)


#: accessor method -> (args, kwargs) of the call; device ops add device
ACCESSOR = {
    "absolute": ((), {}), "abs": ((), {}),
    "correlate1d": (_itself, {"dim": "lag", "device": "cpu"}),
    "correlate2d": (_itself, {"device": "cpu"}),
    "cwt": ((), {"nfreqs": 6, "device": "cpu"}),
    "scaleogram": ((), {"nfreqs": 6, "device": "cpu"}),
    "fft": ((), {"device": "cpu"}),
    "ifft": ((), {"new_dim": "t", "device": "cpu"}),
    "rfft": ((), {"device": "cpu"}),
    "irfft": ((), {"new_dim": "t", "device": "cpu"}),
    "lombscargle": ((), {"nfreqs": 20, "device": "cpu"}),
    "norm1d": ((), {}),
    "norm2d": ((), {}),
    "peak_local_max": ((), {"min_distance": 2, "device": "cpu"}),
    "plane_wave_estimate": (_receiver_xy, {"dim": "lag", "device": "cpu",
                                           **ATTRS}),
    "tri_mirror": ((), {}),
    "demean": ((), {"device": "cpu"}),
    "detrend": ((), {"type": "linear", "device": "cpu"}),
    "envelope": ((), {"device": "cpu"}),
    "filter": ((), {"frequency": 0.5, "device": "cpu"}),
    "hilbert": ((), {"device": "cpu"}),
    "rms": ((), {"dim": "lag"}),
    "snr": (_lag_masks, {"dim": "lag", "extend": True, "device": "cpu",
                         **ATTRS}),
    "spectrogram": ((), {"duration": 2.0, "device": "cpu"}),
    "spectrogram_mtc": ((), {"duration": 2.0, "device": "cpu"}),
    "taper": ((), {"max_length": 5.0}),
    "timeshift": ((), {"delay": 1.3, "dim": "lag", "device": "cpu"}),
    "unbias": ((), {}),
    "window": ((), {}),
    "coincidence_trigger": ((), {"thr_on": 10.0, "dim": "time"}),
    "unbias_weights": ((), {}),
}


def _values(out):
    if hasattr(out, "data_vars"):
        return {k: out[k].values for k in out.data_vars}
    return {"": out.values}


@pytest.mark.parametrize("method", sorted(ACCESSOR))
def test_accessor_matches_function(method):
    from xcorr_tpu_torch.signal import accessor
    args, kw = ACCESSOR[method]
    if method == "coincidence_trigger":
        x = snr_series()[1]
    elif method in ("unbias", "unbias_weights", "window"):
        x = unbias_input(T)
    elif method == "plane_wave_estimate":
        x = make_cc(T, pulses(14, (3, 3, 401)))
    elif method == "tri_mirror":
        x = T.ndlabel.DataArray(pulses(14, (2, 5, 5)),
                                dims=("pair", "time1", "time2"))
    else:
        x = make_cc(T, pulses(14))
    if callable(args):
        args = args(x)
    if method == "unbias_weights":
        x = x.coords["lag"]
    elif method == "window":
        x = x.coords["lag"]
    fn = getattr(T.signal, "absolute" if method == "abs" else method)
    want = fn(x, *args, **kw)
    got = getattr(accessor.SignalAccessor(x), method)(*args, **kw)
    if method not in ("unbias_weights", "window"):
        got2 = getattr(x.signal, method)(*args, **kw)
        for k, v in _values(got2).items():
            np.testing.assert_array_equal(v, _values(want)[k])
    for k, v in _values(got).items():
        np.testing.assert_array_equal(v, _values(want)[k])


def test_accessor_binds_the_ported_ops():
    """The port's accessor binds every op the JAX package's binds, and
    each is called above."""
    from xcorr_tpu.signal.accessor import SignalAccessor as JAcc
    from xcorr_tpu_torch.signal.accessor import SignalAccessor as TAcc
    public = {k for k in vars(TAcc) if not k.startswith("_")}
    assert public == set(ACCESSOR)
    assert public == {k for k in vars(JAcc) if not k.startswith("_")}


def unbias_input(pkg):
    """A lag-clipped CCF with the lag attrs ``unbias`` reads."""
    from xcorr_tpu_torch.util import cc as cc_host
    npts, fs = 51, 50.0
    full_lag = cc_host.lag(npts, 1 / fs)
    imin, imax = 25, 90
    da = pkg.ndlabel.DataArray(
        np.random.default_rng(1).normal(size=(1, imax - imin)),
        dims=("pair", "lag"),
        coords={"pair": np.array(["A-B"], dtype=object),
                "lag": full_lag[imin:imax]},
        name="cc", attrs={"long_name": "cc", "standard_name": "cc",
                          "unbiased": 0})
    da.coords["lag"].attrs.update({
        "sampling_rate": fs, "delta": 1 / fs, "npts": npts,
        "index_min": imin, "index_max": imax, "units": "s"})
    return da


# -- no silent route to the CPU -------------------------------------------

DEVICE_OPS = {
    "detrend": lambda x: T.signal.detrend(x),
    "demean": lambda x: T.signal.demean(x),
    "filter": lambda x: T.signal.filter(x, frequency=0.5),
    "timeshift": lambda x: T.signal.timeshift(x, delay=1.0, dim="lag"),
    "hilbert": lambda x: T.signal.hilbert(x),
    "envelope": lambda x: T.signal.envelope(x),
    "spectrogram": lambda x: T.signal.spectrogram(x),
    "spectrogram_mtc": lambda x: T.signal.spectrogram_mtc(x),
    "snr": lambda x: T.signal.snr(x, *_lag_masks(x), dim="lag"),
    "snr-no-envelope": lambda x: T.signal.snr(x, *_lag_masks(x), dim="lag",
                                              envelope=False),
}


@pytest.mark.parametrize("op", sorted(DEVICE_OPS))
def test_device_op_raises_without_a_card(op, monkeypatch):
    """``device`` defaults to ``'cuda'``; with no card every device op
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEVICE_OPS[op](make_cc(T, pulses(15)))
