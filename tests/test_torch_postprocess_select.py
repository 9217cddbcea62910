"""The port forms of ``postprocess``'s two host stages against their plain
versions, bit for bit, on the CPU: the selection of the valid times and
the lag window (``core/postprocess.py`` ``select`` against the carried
``_select_plain``) and ``unbias``'s weights over the clipped lags
(``signal/_unbias.py`` ``span_weights`` against the carried slice of
``util.cc.weight``).

Both forms run on the same seeded datasets, the geometry of
``tests/test_torch_postprocess.py`` (5 Hz, 1 h windows, +-100 s lags)
and one pair-day at the production geometry (``scripts/cc.py``'s
``default_config``: 50 Hz, 24 h windows every 3 h, 0-9 h lags,
float32). Equal means: the same variables and coordinates in the same
order, each with the same name, dims, dtype and bytes (so NaNs equal and
in the same places), the same attrs (all but ``cc``'s ``postprocess``
timestamp) and encoding. The input comes out of both unchanged, and the
output shares memory with it only where the plain form's does (the
``distance`` it passes through). At the production geometry the port is
also held to ``xcorr_tpu.postprocess`` at ``tests/test_torch_postprocess.py``'s
bars, and its selection and weights touch neither the whole lag range nor
the whole ``cc``.
"""
import contextlib
import importlib
import tracemalloc
import warnings

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu as J
import xcorr_tpu.scripts.cc
import xcorr_tpu_torch as T
import xcorr_tpu_torch.scripts.cc
from xcorr_tpu_torch.signal import _unbias
from xcorr_tpu_torch.util import cc as cc_util
from xcorr_tpu_torch.util.cc import weight

POST = importlib.import_module("xcorr_tpu_torch.core.postprocess")
UNBIAS = importlib.import_module("xcorr_tpu_torch.signal.unbias")

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

#: ``tests/test_torch_postprocess.py``'s cases
CASES = {
    "clim": {"clim": (90_000.0, 2_000_000.0)},
    "lag_lim": {"lag_lim": (-60.0, 80.0)},
    "time_lim": {"time_lim": ("2014-01-01T00:30", "2014-01-01T02:00"),
                 "lag_lim": (0.0, 100.0)},
    "cmax_km": {"cmax": 2_000_000.0},
    "lag_and_clim": {"lag_min": 10.0, "cmin": 90_000.0},
}
#: and more: one bound each, windows at both ends of the lags, full width
MORE = {
    "time_lim_only": {"time_lim": ("2014-01-01T01:00",
                                   "2014-01-01T02:30")},
    "cmin_km": {"cmin": 90_000.0},
    "lags_from_first": {"lag_lim": (-500.0, -80.0)},
    "lags_to_last": {"lag_lim": (70.0, 500.0)},
    "short_window": {"lag_lim": (-2.0, 2.0)},
    "full_width": {},
}


def inventory(pkg):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])


def dataset(pkg, dtype, seed=0, missing=(2,)):
    """Six 1 h windows of a filled CCF dataset, the windows ``missing``
    with status -1 (``tests/test_torch_postprocess.py``'s dataset)."""
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
    status[0, list(missing)] = -1
    ds["status"].values[...] = status
    ds["pair_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    ds["time_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    return ds


def pairs(dtype, missing):
    """One dataset of ``len(missing)`` pairs, pair ``i`` with the windows
    ``missing[i]`` invalid and its own data and distance."""
    dss = [dataset(T, dtype, seed=i, missing=m)
           for i, m in enumerate(missing)]
    ds = T.ndlabel.concat(dss, "pair")
    ds.coords["pair"].data = np.array(
        [f"{PAIR}{i}" for i in range(len(missing))], dtype=object)
    ds["distance"].values[...] *= 1.0 + 0.1 * np.arange(len(missing))
    return ds


# -- equality, bit for bit ------------------------------------------------------

def same_value(a, b):
    if isinstance(a, dict) or isinstance(b, dict):
        return (type(a) is type(b) and list(a) == list(b)
                and all(same_value(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and same_array(a, b))
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


def same_array(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:
        return a.tolist() == b.tolist()
    return (np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes()
            and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))


def assert_same_array(a, b, where, skip=()):
    """DataArrays equal: name, dims, dtype, bytes, attrs but ``skip``,
    coordinates in order."""
    assert a.name == b.name, where
    assert a.dims == b.dims, where
    assert same_array(a.data, b.data), f"{where}: data"
    ka = {k: v for k, v in a.attrs.items() if k not in skip}
    kb = {k: v for k, v in b.attrs.items() if k not in skip}
    assert same_value(ka, kb), f"{where}: attrs"
    assert list(a._coords) == list(b._coords), f"{where}: coords"
    for k in a._coords:
        assert_same_array(a._coords[k], b._coords[k], f"{where}.{k}")


def assert_same(a, b):
    """Datasets equal, ``cc``'s ``postprocess`` timestamp aside."""
    assert list(a._coords) == list(b._coords)
    assert list(a._vars) == list(b._vars)
    assert same_value(a.attrs, b.attrs)
    assert same_value(a.encoding, b.encoding)
    for k in a._coords:
        assert_same_array(a._coords[k], b._coords[k], f"coord {k}")
    for k in a._vars:
        assert_same_array(a._vars[k], b._vars[k], f"var {k}",
                          skip=("postprocess",) if k == "cc" else ())


def arrays(ds):
    out = {f"coord {k}": v.data for k, v in ds._coords.items()}
    out.update({f"var {k}": v.data for k, v in ds._vars.items()})
    for v in list(ds._coords.values()) + list(ds._vars.values()):
        out.update({f"{v.name}.{k}": c.data for k, c in v._coords.items()})
    return out


def shared(out, ds):
    """The output arrays that share memory with an input array."""
    ins = arrays(ds)
    return sorted(k for k, a in arrays(out).items()
                  if any(np.shares_memory(a, b) for b in ins.values()))


@contextlib.contextmanager
def plain_forms():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(POST, "select", POST._select_plain)
        mp.setattr(UNBIAS, "span_weights", _unbias._span_weights_plain)
        yield


def both(ds, **kw):
    """``postprocess`` of ``ds`` on the port forms and on the plain ones;
    checks that ``ds`` comes out of each unchanged and that the outputs
    are equal and share memory with it alike."""
    kw = {"filter_kwargs": FILTER, **kw}
    before = ds.copy(deep=True)
    port = T.postprocess(ds, device="cpu", **kw)
    assert_same(ds, before)
    with plain_forms():
        plain = T.postprocess(ds, device="cpu", **kw)
    assert_same(ds, before)
    assert_same(port, plain)
    assert shared(port, ds) == shared(plain, ds) == ["var distance"]
    return port, plain


def condition(ds, time_lim=None):
    t = ds.coords["time"]
    lo, hi = (t.values.min(), t.values.max()) if time_lim is None else (
        np.datetime64(pd.Timestamp(x)) for x in time_lim)
    return (ds["status"] == 1) & (t >= lo) & (t <= hi)


def both_selections(ds, lag_lim, time_lim=None):
    """``select`` and ``_select_plain`` of ``ds``: equal, the input
    unchanged, no output array in the input's memory but the coordinates
    that no selected dimension touches (the lag coordinate both forms
    pass on)."""
    src = ds.drop_vars("distance")
    m = condition(ds, time_lim)
    before = ds.copy(deep=True)
    got = POST.select(src, m, *lag_lim)
    want = POST._select_plain(src, m, *lag_lim)
    assert_same(ds, before)
    assert_same(got[0], want[0])
    assert_same_array(got[1], want[1], "cc")
    assert selection_shared(got, ds) == selection_shared(want, ds) == \
        ["coord lag"]
    return got


def selection_shared(sel, ds):
    """The arrays of a selection that share memory with an input array."""
    ins = arrays(ds)
    outs = arrays(sel[0])
    outs["cc"] = sel[1].data
    outs.update({f"cc.{k}": c.data for k, c in sel[1]._coords.items()})
    return sorted(k for k, a in outs.items()
                  if any(np.shares_memory(a, b) for b in ins.values()))


# -- the two forms on the CPU ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES) + sorted(MORE))
def test_forms_equal(case, dtype):
    port, _ = both(dataset(T, dtype), **{**CASES, **MORE}[case])
    assert port["cc"].dtype == dtype
    assert bool(np.isfinite(port["cc"].values).all())


@pytest.mark.parametrize("missing", [
    [(2,), (1, 4)],
    [(0,), (2, 3), (5,)],
    [(), (0, 1, 2)],
], ids=["two-pairs", "three-pairs", "one-pair-all-valid"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_forms_equal_on_several_pairs(missing, dtype):
    """A time kept for one pair and not another leaves NaN in the other
    pair's ``cc``, ``pair_offset`` and ``time_offset`` inside the kept
    block; both forms put it in the same places."""
    ds = pairs(dtype, missing)
    port, _ = both(ds, lag_lim=(-30.0, 60.0))
    holes = np.isnan(port["cc"].values)
    assert holes.any() and not holes.all()
    assert np.isnan(port["pair_offset"].values).sum() == \
        holes.all(axis=-1).sum()
    ds_sel, cc = both_selections(ds, (-30.0, 60.0))
    assert ds_sel["status"].dtype == np.float64
    assert np.isnan(ds_sel["status"].values).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_all_valid_block_promotes_integers(dtype):
    """A kept block where the condition holds everywhere: no NaN, but
    the integer ``status`` still comes out float64, as ``np.where``
    makes it."""
    ds = dataset(T, dtype, missing=())
    ds_sel, cc = both_selections(ds, (-20.0, 20.0))
    assert ds_sel["status"].dtype == np.float64
    assert cc.dtype == dtype
    assert not np.isnan(cc.values).any()
    both(ds, lag_lim=(-20.0, 20.0))


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float16],
                         ids=["int16", "int32", "float16"])
@pytest.mark.parametrize("missing", [(), (2,)], ids=["all-valid", "one-out"])
def test_selected_cc_takes_where_dtype(dtype, missing):
    """``cc`` of another dtype comes out of both selections in the dtype
    ``np.where(m, cc, np.nan)`` gives (float64 from integers), whether or
    not the condition is false inside the kept block."""
    ds = pairs(np.float32, [(), missing])
    cc = ds["cc"]
    ds["cc"] = cc.copy(deep=False, data=(cc.data * 1e4).astype(dtype))
    assert ds["cc"].dtype == dtype
    ds_sel, cc = both_selections(ds, (-60.0, 80.0))
    assert cc.dtype == np.where(True, ds["cc"].data[:0], np.nan).dtype
    assert np.isnan(cc.values).any() == bool(missing)


@pytest.mark.parametrize("lag_lim", [(-60.0, 80.0), (-500.0, 500.0),
                                     (-500.0, -99.0), (99.0, 500.0),
                                     (0.0, 0.0)],
                         ids=["inside", "all", "first", "last", "one"])
def test_selections_equal(lag_lim):
    """``select`` against ``_select_plain`` directly, the dataset with
    ``status`` and the dropped times included."""
    ds_sel, cc = both_selections(dataset(T, np.float32, missing=(0, 3)),
                                 lag_lim, ("2014-01-01T00:00",
                                           "2014-01-01T02:00"))
    assert ds_sel.dims["time"] == 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_forms_equal_with_nan_in_input(dtype):
    ds = dataset(T, dtype)
    ds["cc"].values[0, 1, 480:520] = np.nan
    ds["cc"].values[0, 3, ::97] = np.nan
    port, _ = both(ds, lag_lim=(-60.0, 80.0))
    assert np.isnan(port["cc"].values).any()


@pytest.mark.parametrize("kw,match", [
    ({"time_lim": ("2015-01-01", "2015-01-02")}, "valid times"),
    ({"lag_lim": (200.0, 300.0)}, "time lag"),
    ({"lag_lim": (0.1, 0.15)}, "time lag"),
], ids=["no-times", "no-lags", "between-lags"])
def test_empty_selection_raises_on_both_forms(kw, match):
    ds = dataset(T, np.float32)
    before = ds.copy(deep=True)
    with pytest.raises(ValueError, match=match):
        T.postprocess(ds, device="cpu", **kw)
    with plain_forms(), pytest.raises(ValueError, match=match):
        T.postprocess(ds, device="cpu", **kw)
    assert_same(ds, before)


def test_input_lag_attrs_untouched():
    """The clipped lag coordinate carries its own clip indices; the
    input's keep theirs."""
    ds = dataset(T, np.float32)
    attrs = dict(ds.coords["lag"].attrs)
    port, _ = both(ds, clim=(90_000.0, 2_000_000.0))
    assert same_value(ds.coords["lag"].attrs, attrs)
    lag = port.coords["lag"]
    assert lag.attrs["index_min"] > attrs["index_min"]
    assert lag.attrs["index_max"] < attrs["index_max"]
    assert lag.attrs["index_max"] - lag.attrs["index_min"] == lag.size


# -- unbias's weights ---------------------------------------------------------------

@pytest.mark.parametrize("npts", [7, 8, 1001, 1000, 18000, 4_320_000,
                                  np.int64(4_320_000), np.int32(1001)],
                         ids=lambda n: f"{type(n).__name__}-{n}")
def test_span_weights_equal_weight(npts):
    nn = 2 * int(npts) - 1
    full = weight(npts, pad=True)
    spans = [(0, 1), (0, 7), (nn - 7, nn), (nn - 1, nn), (0, nn),
             (nn // 2, nn // 2 + 1), (nn // 3, nn // 2 + 3), (-3, nn),
             (2, nn + 5), (5, 3)]
    for a, b in spans:
        got = _unbias.span_weights(npts, a, b)
        want = full[a:b]
        assert got.dtype == want.dtype == np.float64
        assert got.shape == want.shape, (a, b)
        assert got.tobytes() == want.tobytes(), (a, b)
        plain = _unbias._span_weights_plain(npts, a, b)
        assert plain.tobytes() == want.tobytes()


# -- one pair-day at the production geometry ---------------------------------------

DISTANCE_KM = 7000.0
CELERITY = (1460.0, 1500.0)
HIGHPASS = {"frequency": 3.0, "btype": "highpass", "order": 2}


def pair_day(pkg, dtype):
    """One production pair-day (``default_config``'s first pair), seeded
    noise plus an arrival at distance / 1480 m/s, window 5 invalid."""
    scripts = {J: xcorr_tpu.scripts, T: xcorr_tpu_torch.scripts}[pkg]
    init_args, _, pair_list, _ = scripts.cc.default_config()
    ds = pkg.init(pair=pair_list[0], starttime="2014-03-01",
                  endtime="2014-03-02", **{**init_args, "dtype": dtype})
    rng = np.random.default_rng(11)
    cc = ds["cc"].values
    cc[...] = 1e-3 * rng.standard_normal(cc.shape, dtype=np.float32)
    k = int(np.searchsorted(ds.coords["lag"].values,
                            DISTANCE_KM * 1e3 / 1480.0))
    cc[..., k:k + 50] += 0.05 * np.hanning(50)
    status = np.ones(ds["status"].shape, dtype=np.int8)
    status[0, 5] = -1
    ds["status"].values[...] = status
    ds["distance"].values[...] = DISTANCE_KM
    ds["time_offset"].values[...] = rng.uniform(-0.01, 0.01,
                                                ds["status"].shape)
    return ds


@pytest.fixture(scope="module")
def production_reference():
    ds = pair_day(J, np.float64)
    return J.postprocess(ds, clim=CELERITY, filter_kwargs=HIGHPASS)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_production_pair_day(dtype, production_reference):
    """Both forms equal on a production pair-day; the port held to the
    JAX package at ``tests/test_torch_postprocess.py``'s bars."""
    ds = pair_day(T, dtype)
    assert ds["cc"].shape == (1, 8, 1_620_000)
    port, _ = both(ds, clim=CELERITY, filter_kwargs=HIGHPASS)
    want = production_reference
    for name in ("lag", "time", "pair"):
        np.testing.assert_array_equal(port.coords[name].values,
                                      want.coords[name].values)
    assert 6000 < port.dims["lag"] < 7000
    w = want["cc"].values
    tol = TOL32 if dtype == np.float32 else RTOL64
    err = np.abs(port["cc"].values - w).max() / np.abs(w).max()
    assert err <= tol, err


def test_production_pair_day_touches_only_the_kept_lags(monkeypatch):
    """At a celerity window the port forms build no array over the whole
    lag range (``util.cc.weight`` raises) and allocate a small part of
    ``cc``'s bytes; the plain forms allocate more than all of them."""
    ds = pair_day(T, np.float32)
    nbytes = ds["cc"].data.nbytes

    def peak(**kw):
        tracemalloc.start()
        try:
            T.postprocess(ds, clim=CELERITY, filter_kwargs=HIGHPASS,
                          device="cpu")
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    with plain_forms():
        plain = peak()

    def whole(*a, **kw):
        raise AssertionError("weights over the whole lag range")

    monkeypatch.setattr(cc_util, "weight", whole)
    monkeypatch.setattr(_unbias, "weight", whole)
    port = peak()
    assert plain > nbytes
    assert port < nbytes / 4, (port, nbytes)


def test_already_postprocessed_passes_through_both_forms():
    post = T.postprocess(dataset(T, np.float32), lag_lim=(0.0, 50.0),
                         filter_kwargs=FILTER, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert T.postprocess(post, device="cpu") is post
        with plain_forms():
            assert T.postprocess(post, device="cpu") is post
