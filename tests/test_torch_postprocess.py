"""The PyTorch port's ``postprocess`` and ``merge``
(``xcorr_tpu_torch/core/{postprocess,merge}.py``) against the JAX
package's on the CPU: one CCF dataset built alike by both packages'
``init`` (5 Hz, 1 h windows, 50% overlap, +-100 s lags, the geometry of
``tests/test_core.py``) and filled with the same seeded numpy data.

Tolerances, as in ``tests/test_torch_signal.py``: in float64 the port's
postprocessed ``cc`` is within ``1e-9`` of the JAX package's peak; the
port's float32 chain is within 5e-6 of the JAX float64 result's peak (the
chain's filter sets the bar). Coordinates, the selected times and the lag
window are equal. ``merge`` is a carried copy: its datasets are equal.
"""
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu as J
import xcorr_tpu_torch as T

RTOL64 = 1e-9
TOL32 = 5e-6
FS = 5.0
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("taper", {"type": "cosine", "max_percentage": 0.05,
                    "max_length": 30.0})]
ATTRS = {"institution": "t", "author": "t", "source": "t"}
FILTER = {"frequency": 0.5, "btype": "highpass", "order": 2}


def inventory(pkg):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])


def dataset(pkg, dtype, seed=0):
    """Six 1 h windows of a filled CCF dataset; window 2 is missing."""
    ds = pkg.init(pair=PAIR, starttime="2014-01-01",
                  endtime="2014-01-01T03:00", preprocess={"EDH": CHAIN,
                                                          "BHZ": CHAIN},
                  attrs=ATTRS, sampling_rate=FS, window_length=3600.0,
                  window_overlap=0.5, clip_lag=(-100.0, 100.0),
                  inventory=inventory(pkg), dtype=dtype)
    rng = np.random.default_rng(seed)
    nt, nlag = ds.dims["time"], ds.dims["lag"]
    lag = ds.coords["lag"].values
    packet = np.exp(-((lag - 40.0) / 3.0) ** 2) * np.cos(2 * np.pi * lag)
    ds["cc"].values[...] = (0.01 * rng.standard_normal((1, nt, nlag))
                            + 0.2 * packet).astype(dtype)
    status = np.ones((1, nt), dtype=np.int8)
    status[0, 2] = -1
    ds["status"].values[...] = status
    ds["pair_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    ds["time_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    return ds


CASES = {
    "clim": {"clim": (90_000.0, 2_000_000.0)},
    "lag_lim": {"lag_lim": (-60.0, 80.0)},
    "time_lim": {"time_lim": ("2014-01-01T00:30", "2014-01-01T02:00"),
                 "lag_lim": (0.0, 100.0)},
    "cmax_km": {"cmax": 2_000_000.0},
    "lag_and_clim": {"lag_min": 10.0, "cmin": 90_000.0},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_postprocess_matches_reference(case):
    kw = {**CASES[case], "filter_kwargs": FILTER}
    want = J.postprocess(dataset(J, np.float64), **kw)
    ds = dataset(T, np.float64)
    missing = ds.coords["time"].values[2]
    got = T.postprocess(ds, device="cpu", **kw)
    for name in ("lag", "time", "pair"):
        np.testing.assert_array_equal(got.coords[name].values,
                                      want.coords[name].values)
    assert missing not in got.coords["time"].values
    w = want["cc"].values
    assert got["cc"].values.dtype == np.float64
    np.testing.assert_allclose(got["cc"].values, w, rtol=0,
                               atol=RTOL64 * np.abs(w).max())
    for name in ("distance", "pair_offset", "time_offset"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    assert set(got.data_vars) == set(want.data_vars)
    assert got["cc"].attrs["unbiased"] == 1 and \
        "postprocess" in got["cc"].attrs
    for attr in ("cmin", "cmax"):
        assert got.coords["lag"].attrs[attr] == \
            want.coords["lag"].attrs[attr]
    got32 = T.postprocess(dataset(T, np.float32), device="cpu", **kw)
    assert got32["cc"].values.dtype == np.float32
    err = np.abs(got32["cc"].values - w).max() / np.abs(w).max()
    assert err <= TOL32, err


def test_single_celerity_bound_converts_km():
    """``tests/test_core.py:263`` on the port: cmax alone converts the km
    distance to metres for the lag clip."""
    ds = dataset(T, np.float32)
    dist_m = float(ds["distance"].values.ravel()[0]) * 1000.0
    post = T.postprocess(ds, cmax=2_000_000.0, filter_kwargs=FILTER,
                         device="cpu")
    lag = post.coords["lag"].values
    assert lag.min() >= dist_m / 2_000_000.0 - 0.5
    assert lag.min() > 1.0


def test_already_postprocessed_warns_and_returns_it():
    post = T.postprocess(dataset(T, np.float32), lag_lim=(0.0, 50.0),
                         filter_kwargs=FILTER, device="cpu")
    with pytest.warns(UserWarning, match="already postprocessed"):
        again = T.postprocess(post, device="cpu")
    assert again is post


@pytest.mark.parametrize("kw,match", [
    ({"time_lim": ("2015-01-01", "2015-01-02")}, "valid times"),
    ({"lag_lim": (200.0, 300.0)}, "time lag"),
], ids=["no-times", "no-lags"])
def test_empty_selection_raises_like_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        J.postprocess(dataset(J, np.float32), **kw)
    with pytest.raises(ValueError, match=match):
        T.postprocess(dataset(T, np.float32), device="cpu", **kw)


def test_postprocess_without_a_card_raises(monkeypatch):
    """``device`` defaults to ``'cuda'``: without a card postprocess
    raises up front, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.postprocess(dataset(T, np.float32))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two days of CCF shards of the pair from the port's
    ``lazy_process`` on the CPU."""
    root = str(tmp_path_factory.mktemp("cc"))
    client = T.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 0.0,
                                  "IU.RAR.10.BHZ": 4.0},
        source_period=600.0, source_amplitude=20.0)
    times = pd.date_range("2014-01-01", periods=2, freq="1D")
    init_args = dict(preprocess={"EDH": CHAIN, "BHZ": CHAIN}, attrs=ATTRS,
                     sampling_rate=FS, window_length=3600.0,
                     window_overlap=0.5, clip_lag=(-100.0, 100.0),
                     inventory=inventory(T))
    assert all(T.lazy_process([PAIR], times, init_args, client,
                              inventory=inventory(T), root=root,
                              nworkers=1, verb=0, device="cpu"))
    return [T.ncfile(PAIR, t, root) for t in times]


@pytest.mark.parametrize("extract", [False, True])
def test_merge_matches_reference(shards, extract):
    want = J.merge([J.read(f) for f in shards], extract=extract)
    got = T.merge([T.read(f) for f in shards], extract=extract)
    assert got.dims == want.dims
    for name in want.data_vars:
        np.testing.assert_array_equal(got[name].values, want[name].values)
    np.testing.assert_array_equal(got.coords["time"].values,
                                  want.coords["time"].values)
    assert got.attrs["title"] == want.attrs["title"]
    assert got.attrs["history"].startswith(
        want.attrs["history"].rsplit(", Merged @", 1)[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        post = T.postprocess(got, lag_lim=(0.0, 100.0),
                             filter_kwargs=FILTER, device="cpu")
    assert post.dims["time"] == 96
