"""The preprocess chains of the PyTorch port's device engine
(``xcorr_tpu_torch/stream/compile.py`` and ``ops/{detrend,taper,filter}``)
against the JAX package's (``xcorr_tpu.stream.compile``) on the CPU, on
the same seeded numpy inputs.

Tolerances:

* float64: the port and the JAX package run the same algorithms, so
  outputs agree to rounding: ``rtol=1e-9`` of the output's peak, tighter
  than every matching test of ``tests/test_compile.py`` (which holds the
  JAX chains to the host path at ``rtol`` 1e-6 to 2e-4).
* float32: the port's float32 output is held to the float64 result:
  within 5e-6 of the peak for the recursive filters (float32 rounding
  grows with a filter's gain near its poles; the port runs the closed
  form in every chunk, which keeps it a few units of roundoff) and 1e-6
  for the other ops (a few float32 roundings per sample). The JAX
  package's own float32 associative scan is not held to these bounds.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu import ops as jops
from xcorr_tpu.parallel import engine as jengine
from xcorr_tpu.stream import PAZResponse as JPAZ
from xcorr_tpu.stream.compile import compile_operations as jcompile
from xcorr_tpu_torch.ops import filter as tfilter
from xcorr_tpu_torch.parallel import engine as tengine
from xcorr_tpu_torch.stream import PAZResponse as TPAZ
from xcorr_tpu_torch.stream.compile import compile_operations as tcompile
from xcorr_tpu_torch.scripts.cc import default_config

RTOL64 = 1e-9
TOL32 = {"filter": 5e-6, "other": 1e-6}
PAZ = dict(poles=[-0.04 + 0.04j, -0.04 - 0.04j], zeros=[0j, 0j], gain=1.0,
           sensitivity=2.5e8)

#: one case per op and variant: (op list, sampling rate)
OPS = {
    "demean": ([("detrend", {"type": "demean"})], 20.0),
    "detrend_linear": ([("detrend", {"type": "linear"})], 20.0),
    "detrend_simple": ([("detrend", {"type": "simple"})], 20.0),
    "taper_cosine": ([("taper", {"type": "cosine", "max_percentage": 0.05,
                                 "max_length": 30.0})], 20.0),
    "taper_hann": ([("taper", {"type": "hann", "max_percentage": 0.1})],
                   20.0),
    "lowpass": ([("filter", {"type": "lowpass", "freq": 2.0})], 20.0),
    "highpass": ([("filter", {"type": "highpass", "freq": 0.05})], 20.0),
    "bandpass": ([("filter", {"type": "bandpass", "freqmin": 0.3,
                              "freqmax": 2.0})], 20.0),
    "bandstop": ([("filter", {"type": "bandstop", "freqmin": 1.0,
                              "freqmax": 3.0})], 20.0),
    "zerophase": ([("filter", {"type": "bandpass", "freqmin": 0.3,
                               "freqmax": 2.0, "zerophase": True})], 20.0),
    "decimate": ([("decimate", {"factor": 5})], 250.0),
    "decimate_no_filter": ([("decimate", {"factor": 4,
                                          "no_filter": True})], 20.0),
    "interpolate": ([("interpolate", {"sampling_rate": 50,
                                      "method": "lanczos", "a": 20})], 40.0),
    "remove_sensitivity": ([("remove_sensitivity", {})], 20.0),
    "remove_response": ([("remove_response", {"output": "VEL",
                                              "water_level": 60.0})], 20.0),
    "normalize": ([("normalize", {})], 20.0),
    "running_rms": ([("running_rms", {"window": 60.0})], 20.0),
}


def _chains(ops_list, n, fs, **kw):
    fj, nj, fsj = jcompile(ops_list, n, fs, response=JPAZ(**PAZ), **kw)
    ft, nt, fst = tcompile(ops_list, n, fs, response=TPAZ(**PAZ), **kw)
    assert (nt, fst) == (nj, fsj)
    return fj, ft, nt


def _hold(fj, ft, x, tol32):
    """Port vs JAX in float64; both in float32 against float64."""
    want = np.asarray(fj(x))
    scale = np.abs(want).max()
    got = ft(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL64 * scale)
    got32 = ft(torch.from_numpy(x.astype(np.float32))).numpy()
    assert got32.dtype == np.float32
    err = np.abs(got32 - want).max() / scale
    assert err <= tol32, err
    return got


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_reference(name):
    ops_list, fs = OPS[name]
    n = 6000
    x = np.random.default_rng(1).standard_normal((2, n)) + 3.0
    fj, ft, _ = _chains(ops_list, n, fs)
    kind = "filter" if ops_list[0][0] in ("filter", "decimate") \
        and not ops_list[0][1].get("no_filter") else "other"
    _hold(fj, ft, x, TOL32[kind])


@pytest.mark.parametrize("zerophase", [False, True],
                         ids=["sosfilt", "sosfiltfilt"])
def test_filter_chunked_above_2_18(zerophase):
    """n just above 2^18: the port runs two chunks with the carried
    state; the JAX package its chunked scan (B = 2)."""
    n = (1 << 18) + 1000
    x = np.random.default_rng(2).standard_normal((2, n))
    sos = jops.filter.butter_sos(4, (0.3, 2.0), "bandpass", 20.0)
    if zerophase:
        want = np.asarray(jops.filter.sosfiltfilt(sos, x))
        got = tfilter.sosfiltfilt(sos, torch.from_numpy(x)).numpy()
    else:
        want = np.asarray(jops.filter.sosfilt(sos, x))
        got = tfilter.sosfilt(sos, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL64 * np.abs(want).max())


def _cc_chain(channel):
    init_args = default_config()[0]
    return init_args["preprocess"][channel]


@pytest.mark.parametrize("channel,fs,n,trim_to,trim_offset", [
    ("EDH", 250.0, 60_000, 10_000, 500),
    ("BHZ", 40.0, 24_000, 25_000, 1_000),
], ids=["EDH", "BHZ"])
def test_production_chain_matches_reference(channel, fs, n, trim_to,
                                            trim_offset):
    """The EDH and BHZ chains of ``scripts/cc.py`` with the buffer trim
    at the DSL's position (``trim_to`` samples at the final 50 Hz)."""
    ops_list = [op for op in _cc_chain(channel) if op[0] != "merge"]
    x = np.random.default_rng(3).standard_normal((2, n)) * 1e3
    fj, ft, n_out = _chains(ops_list, n, fs, trim_to=trim_to,
                            trim_offset=trim_offset)
    assert n_out == trim_to
    _hold(fj, ft, x, TOL32["filter"])


def test_bhr_chain_is_refused_like_reference():
    """The BHR chain rotates and selects on the host: both engines
    refuse it (and send it to the host path)."""
    bhr = _cc_chain("BHR")
    assert jengine._chain_compilable(bhr) is False
    assert tengine._chain_compilable(bhr) is False
    for name in ("EDH", "BHZ"):
        assert tengine._chain_compilable(_cc_chain(name)) is True


def test_default_config_is_the_reference():
    from xcorr_tpu.scripts.cc import default_config as jconfig
    a, b = default_config("x", "y"), jconfig("x", "y")
    assert a[:3] == b[:3]
    assert list(a[3]) == list(b[3])


# -- the trim cases of tests/test_compile.py ------------------------------

def test_trim_to():
    fj, ft, n_out = _chains([("detrend", {"type": "demean"})], 1000, 10.0,
                            trim_to=800)
    assert n_out == 800
    out = ft(torch.ones((1, 1000), dtype=torch.float64)).numpy()
    assert out.shape == (1, 800)
    np.testing.assert_array_equal(out, np.asarray(fj(np.ones((1, 1000)))))


def test_trim_applies_at_dsl_position():
    """Explicit ('trim', {}) mid-chain: the slice happens THERE (with the
    host's inclusive endtime sample, dropped at the end), so the
    trailing demean + taper see the final window."""
    fs, npts, off = 10.0, 2_000, 100
    ops_list = [
        ("filter", {"type": "highpass", "freq": 0.1}),
        ("trim", {}),
        ("detrend", {"type": "demean"}),
        ("taper", {"type": "cosine", "max_percentage": 0.05}),
    ]
    x = np.random.default_rng(7).normal(size=(1, npts + 2 * off)) + 3.0
    fj, ft, n_out = _chains(ops_list, x.shape[-1], fs, trim_to=npts,
                            trim_offset=off)
    assert n_out == npts
    got = _hold(fj, ft, x, TOL32["filter"])[0]
    assert abs(got[0]) < 1e-12
    assert abs(got[-1]) < 0.01 * float(np.std(got))


def test_trim_without_marker_slices_at_end():
    fs, npts, off = 10.0, 1_000, 50
    x = np.random.default_rng(8).normal(size=(1, npts + 2 * off))
    fj, ft, n_out = _chains([("detrend", {"type": "demean"})],
                            x.shape[-1], fs, trim_to=npts, trim_offset=off)
    assert n_out == npts
    got = _hold(fj, ft, x, TOL32["other"])[0]
    np.testing.assert_allclose(got, (x[0] - x[0].mean())[off:off + npts],
                               rtol=1e-6, atol=1e-9)


def test_detrend_simple_is_endpoint_line():
    n = 500
    x = (np.random.default_rng(9).normal(size=n)
         + np.linspace(0.0, 3.0, n))[None]
    fj, ft, _ = _chains([("detrend", {"type": "simple"})], n, 10.0)
    got = _hold(fj, ft, x, TOL32["other"])[0]
    assert abs(got[0]) < 1e-6 and abs(got[-1]) < 1e-6


@pytest.mark.parametrize("ops_list,error,match", [
    ([("taper", {"type": "hann"})], ValueError, "taper"),
    ([("remove_sensitivity", {})], ValueError, "remove_sensitivity"),
    ([("remove_response", {})], ValueError, "remove_response"),
    ([("running_rms", {"window": 200.0})], ValueError, "running_rms"),
    ([("resample", {"sampling_rate": 5.0})], NotImplementedError,
     "resample"),
    ([("frobnicate", {})], NotImplementedError, "frobnicate"),
], ids=["taper", "sensitivity", "response", "running_rms", "resample",
        "unknown"])
def test_strict_stage_gates(ops_list, error, match):
    """Both packages refuse the same chains with the same errors."""
    for compile_ in (jcompile, tcompile):
        with pytest.raises(error, match=match):
            compile_(ops_list, 1_000, 10.0)


def test_explicit_sensitivity_compiles():
    fn, _, _ = tcompile([("remove_sensitivity", {"sensitivity": 2.0})],
                        1_000, 10.0)
    out = fn(torch.ones((1, 1_000), dtype=torch.float32))
    assert float(out[0, 0]) == 0.5
