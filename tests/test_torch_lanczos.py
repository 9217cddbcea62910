"""The port's Lanczos interpolation (``xcorr_tpu_torch/stream/_lanczos.py``
over ``native/lanczos.cpp``) against the JAX package's carried numpy
loop, bit for bit: ``lanczos_interp`` against
``xcorr_tpu.stream.trace._lanczos_interp``, and the port's
``Trace.interpolate`` (which calls it) against the JAX package's, on
seeded inputs. Also the device chain's ``interpolate`` stage
(``stream/compile.py``), whose weight table must give what the two-pass
form gave, bit for bit.
"""
import subprocess

import numpy as np
import pytest
import torch

from xcorr_tpu.stream import trace as jtrace
from xcorr_tpu_torch.stream import _lanczos
from xcorr_tpu_torch.stream import compile as tcompile
from xcorr_tpu_torch.stream import trace as ttrace
from xcorr_tpu_torch.stream._lanczos import lanczos_interp

T0 = "2014-02-01T00:00:00"


def bits_equal(got, want):
    """Same shape and dtype, the same bits where not NaN, NaN at the same
    places."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    ints = f"i{got.itemsize}"
    assert np.array_equal(got[~nan].view(ints), want[~nan].view(ints))


def positions(npts_in, old_fs, new_fs, offset=0.0, npts=None):
    """``Trace.interpolate``'s sample positions."""
    if npts is None:
        duration = (npts_in - 1) / old_fs - offset
        npts = int(np.floor(duration * new_fs)) + 1
    return (offset + np.arange(npts) / new_fs) * old_fs


def held(x, old_fs, new_fs, a, offset=0.0, npts=None):
    """``lanczos_interp`` and ``Trace.interpolate`` of the port against
    the JAX package's, bit for bit. Returns the positions."""
    pos = positions(x.size, old_fs, new_fs, offset, npts)
    bits_equal(lanczos_interp(x, pos, a), jtrace._lanczos_interp(x, pos, a))
    out = []
    for mod in (ttrace, jtrace):
        tr = mod.Trace(x.copy(), mod.Stats(
            network="IU", station="RAR", location="10", channel="BHZ",
            starttime=T0, sampling_rate=old_fs))
        t0 = tr.stats.starttime.timestamp + offset if offset else None
        tr.interpolate(new_fs, method="lanczos", a=a, starttime=t0,
                       npts=npts)
        out.append(tr)
    got, want = out
    bits_equal(got.data, want.data)
    assert got.stats.starttime.ns == want.stats.starttime.ns
    assert got.stats.sampling_rate == want.stats.sampling_rate
    assert got.stats.npts == want.stats.npts == got.data.size
    return pos


def noise(n, seed=7, scale=1e3):
    return np.random.default_rng(seed).standard_normal(n) * scale


@pytest.mark.parametrize("old_fs,new_fs,a,seconds", [
    (40.0, 50.0, 20, 3600),      # the production BHZ/BHR step, 1 h
    (250.0, 50.0, 20, 300),
    (100.0, 40.0, 20, 300),
    (40.0, 50.0, 2, 600),
    (40.0, 50.0, 5, 600),
    (50.0, 40.0, 5, 600),
])
def test_geometries(old_fs, new_fs, a, seconds):
    held(noise(int(seconds * old_fs)), old_fs, new_fs, a)


def test_every_sample_its_own_phase(monkeypatch):
    """40 -> 49.999 Hz: no two samples share a phase; blocks of 1000
    samples bound the table."""
    monkeypatch.setattr(_lanczos, "BLOCK", 1000)
    rows, weights = [], _lanczos._weights

    def counted(t, a):
        rows.append(t.shape[0])
        return weights(t, a)

    monkeypatch.setattr(_lanczos, "_weights", counted)
    x = noise(40 * 240)
    pos = held(x, 40.0, 49.999, 20)
    frac = pos - np.floor(pos)
    assert np.unique(frac).size > 0.99 * frac.size
    assert pos.size > 5 * _lanczos.BLOCK
    assert len(rows) > 5 and max(rows) <= _lanczos.BLOCK


@pytest.mark.parametrize("offset,npts", [
    (-0.37, None),      # some positions in (-1, 0)
    (-1e-5, None),      # the first position a hair below 0
    (-2.5e-4, 3000),
    (12.345, None),
    (0.3, 9000),        # npts given, past the data's end
])
@pytest.mark.parametrize("a", [2, 20])
def test_offsets(offset, npts, a, monkeypatch):
    monkeypatch.setattr(_lanczos, "BLOCK", 4096)
    pos = held(noise(40 * 180, seed=11), 40.0, 50.0, a, offset, npts)
    if offset < 0:
        assert ((pos > -1) & (pos < 0)).any()


@pytest.mark.parametrize("n", [1, 7, 25, 39])
def test_shorter_than_2a(n):
    held(noise(n, seed=n), 40.0, 50.0, 20, offset=-0.1, npts=60)


def test_inf_and_nan_samples():
    x = noise(40 * 120, seed=3)
    x[[5, 700, 1501]] = np.inf
    x[[9, 2222]] = -np.inf
    x[[40, 1000, 4790]] = np.nan
    pos = held(x, 40.0, 50.0, 20)
    # a weight of exactly 0 on an infinite sample makes NaN, as in numpy
    assert np.isnan(lanczos_interp(x, pos, 20)).any()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_integer_and_single_precision_data(dtype):
    x = np.round(noise(40 * 300, seed=5)).astype(dtype)
    pos = held(x, 40.0, 50.0, 20)
    bits_equal(lanczos_interp(x, pos, 20), jtrace._lanczos_interp(x, pos,
                                                                  20))


def test_empty():
    bits_equal(lanczos_interp(noise(10), np.zeros(0), 20),
               jtrace._lanczos_interp(noise(10), np.zeros(0), 20))
    pos = np.arange(5.0)
    with pytest.raises(IndexError):
        jtrace._lanczos_interp(np.zeros(0), pos, 20)
    with pytest.raises(IndexError):
        lanczos_interp(np.zeros(0), pos, 20)


def test_day_scale_window():
    """A buffered 24 h window at 40 Hz, 3,801,600 -> 4,751,999 samples."""
    x = noise(3801600, seed=2014)
    pos = positions(x.size, 40.0, 50.0)
    assert pos.size == 4751999
    bits_equal(lanczos_interp(x, pos, 20), jtrace._lanczos_interp(x, pos,
                                                                  20))


def test_threads(monkeypatch):
    """16 threads with a 1 us switch interval, the library loaded by the
    first of them and one device stage shared: every result as one
    thread's."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setattr(_lanczos, "_lib", None)
    monkeypatch.setattr(_lanczos, "BLOCK", 512)
    xs = [noise(40 * 60, seed=i) for i in range(16)]
    pos = positions(xs[0].size, 40.0, 50.0, offset=-0.3)
    stage = tcompile._stage_interpolate({"sampling_rate": 50.0}, 2400, 40.0)
    want = [jtrace._lanczos_interp(x, pos, 20) for x in xs]
    want_stage = [two_pass_stage({"sampling_rate": 50.0}, 2400, 40.0)(
        torch.from_numpy(x)) for x in xs]

    def work(i):
        return lanczos_interp(xs[i], pos, 20), stage.fn(
            torch.from_numpy(xs[i]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            got = [f.result(timeout=120) for f in
                   [ex.submit(work, i) for i in range(16)]]
    finally:
        sys.setswitchinterval(interval)
    for (g, gs), w, ws in zip(got, want, want_stage):
        bits_equal(g, w)
        bits_equal(gs.numpy(), ws.numpy())


def test_a_failed_build_raises(monkeypatch):
    """No route back to numpy: a compiler that fails, or a library that
    does not load, raises from the call."""
    from xcorr_tpu_torch.native import _cxx
    x, pos = noise(100), positions(100, 40.0, 50.0)
    monkeypatch.setattr(_lanczos, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(_cxx, "FLAGS", (*_cxx.FLAGS, "-DXCL_NEVER_BUILT"))
    with pytest.raises(subprocess.CalledProcessError):
        lanczos_interp(x, pos, 20)
    monkeypatch.setattr(_cxx, "FLAGS", _cxx.FLAGS[:-1])
    monkeypatch.delenv("CXX")

    def no_load(path):
        raise OSError(f"cannot load {path}")

    monkeypatch.setattr(_lanczos.ctypes, "CDLL", no_load)
    with pytest.raises(OSError):
        lanczos_interp(x, pos, 20)


def two_pass_stage(params, npts, fs):
    """The device ``interpolate`` stage as it was before its weight table:
    each tap's weight evaluated once for the kernel mass and again for
    the output."""
    new_fs = float(params["sampling_rate"])
    a = int(params.get("a", 20))
    npts_out = int(np.floor((npts - 1) / fs * new_fs)) + 1
    pos = np.arange(npts_out) / new_fs * fs
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float64)
    ks = range(-a + 1, a + 1)

    def fn(x):
        f = torch.as_tensor(frac, dtype=x.dtype)
        idx0 = torch.as_tensor(i0)
        zero = torch.zeros((), dtype=x.dtype)

        def weight(k):
            t = f - k
            w = torch.sinc(t) * torch.sinc(t / a) * (t.abs() < a)
            idx = idx0 + k
            return torch.where((idx >= 0) & (idx < npts), w, zero), idx

        wsum = sum(weight(k)[0] for k in ks)
        ok = wsum > 0
        wsum = torch.where(ok, wsum, torch.ones_like(wsum))
        out = torch.zeros(x.shape[:-1] + (npts_out,), dtype=x.dtype)
        for k in ks:
            w, idx = weight(k)
            out += torch.index_select(x, -1, idx.clamp_(0, npts - 1)) * \
                torch.where(ok, w / wsum, zero)
        return out
    return fn


@pytest.mark.parametrize("fs,new_fs,a,npts", [
    (40.0, 50.0, 20, 40 * 900),
    (40.0, 49.999, 20, 40 * 120),
    (250.0, 50.0, 5, 250 * 60),
    (40.0, 50.0, 20, 30),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_stage_weight_table(fs, new_fs, a, npts, dtype):
    params = {"sampling_rate": new_fs, "method": "lanczos", "a": a}
    stage = tcompile._stage_interpolate(params, npts, fs)
    x = torch.from_numpy(noise(3 * npts, seed=npts).reshape(3, npts)) \
        .to(dtype)
    got = stage.fn(x)
    assert got.shape == (3, stage.npts_out)
    bits_equal(got.numpy(), two_pass_stage(params, npts, fs)(x).numpy())
    bits_equal(stage.fn(x).numpy(), got.numpy())
