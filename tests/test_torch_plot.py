"""The port's plots (``xcorr_tpu_torch/core/plot.py``, a carried copy) and
``ds.xcorr`` accessor on port datasets, with the Agg backend: the calls
of ``tests/test_plot.py``, checking the same artists. The spectrogram and
scaleogram panels run the port's device ops, so the calls here pass
``spectrogram_kwargs={"device": "cpu"}``."""
import matplotlib
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.contour import QuadContourSet  # noqa: E402

import xcorr_tpu_torch as T  # noqa: E402
from xcorr_tpu_torch.core import plot as xplot  # noqa: E402
from xcorr_tpu_torch.ndlabel import DataArray, Dataset, concat  # noqa: E402

CPU = {"device": "cpu"}
SPEC = {"duration": 2.0, "padding_factor": 2, **CPU}


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def make_ds(pair="A.B..C-D.E..F"):
    fs, nlag, nt = 20.0, 400, 6
    ds = Dataset()
    ds.coords["pair"] = np.array([pair], dtype=object)
    ds.coords["time"] = pd.date_range("2014-01-01", periods=nt,
                                      freq="3h").values
    ds.coords["lag"] = np.arange(nlag) / fs
    ds.coords["lag"].attrs.update({"sampling_rate": fs, "delta": 1 / fs,
                                   "units": "s"})
    ds["cc"] = (("pair", "time", "lag"),
                np.random.default_rng(0).normal(
                    size=(1, nt, nlag)).astype(np.float32))
    return ds


def two_pairs():
    return concat([make_ds(), make_ds("E.F..G-H.I..J")], "pair")


def test_plot_is_the_facade_export():
    assert T.plot is xplot


def test_plot_ccf_and_ccfs():
    ds = make_ds()
    gs = xplot.plot_ccf(ds, spectrogram_kwargs=SPEC)
    # CCF panel, spectrogram panel, colorbar
    assert len(gs.figure.axes) == 3
    assert len(gs.figure.axes[0].lines) == ds.dims["time"]
    assert xplot.plot_ccfs(ds) is not None
    assert xplot.plot_ccfs_colored(ds) is not None


def test_plot_ccf_envelope(monkeypatch):
    """The envelope is taken on the card (``.signal.envelope`` with its
    default device); here the accessor is pointed at the CPU."""
    from xcorr_tpu_torch.signal.accessor import SignalAccessor
    monkeypatch.setattr(SignalAccessor, "envelope",
                        lambda self, **kw: T.signal.envelope(
                            self._da, device="cpu", **kw))
    gs = xplot.plot_ccf(make_ds(), envelope=True, spectrogram_kwargs=SPEC)
    # every window's CCF and its envelope
    assert len(gs.figure.axes[0].lines) == 2 * 6


def test_plot_ccfs_all_nan_scale():
    ds = make_ds()
    ds["cc"].values[:] = np.nan
    xplot.plot_ccfs(ds, normalize=True)
    for ax in plt.gcf().axes:
        assert np.isfinite(ax.get_ylim()).all()


def test_plot_snr_ct_and_trigs():
    nt = 50
    t = pd.date_range("2014-01-01", periods=nt, freq="3h").values
    snr = DataArray(np.random.default_rng(1).uniform(1, 5, (2, nt)),
                    dims=("pair", "time"),
                    coords={"pair": np.array(["P", "Q"], dtype=object),
                            "time": t}, name="snr")
    ct = DataArray(np.where(np.arange(nt) % 10 < 3, 0.0, np.nan),
                   dims=("time",), coords={"time": t}, name="ct")
    ax = xplot.plot_snr_ct(snr, ct)
    assert len(ax.lines) == 2
    from xcorr_tpu_torch.signal.trigger import plot_trigs
    assert plot_trigs(snr, ct) is not None


@pytest.mark.parametrize("cmajor", [None, 10.0])
def test_plot_ccf_celerity_axis(cmajor):
    ds = make_ds()
    ds["distance"] = (("pair",), np.array([14.6]), {"units": "km"})
    gs = xplot.plot_ccf(ds, cmin=1460.0, cmax=1500.0, cmajor=cmajor,
                        spectrogram_kwargs=SPEC)
    fig = gs.figure
    fig.canvas.draw()
    ax1 = fig.axes[0]
    labels = [t.get_text() for child in ax1.child_axes
              for t in child.get_xticklabels()]
    assert any("m/s" in txt for txt in labels)
    lo, hi = ax1.get_xlim()
    assert abs(lo - 14600.0 / 1500.0) < 0.1
    assert abs(hi - 14600.0 / 1460.0) < 0.1
    np.testing.assert_allclose(
        np.sort(ax1.child_axes[0].get_xticks()),
        np.sort(14600.0 / np.arange(1460.0, 1500.0, cmajor or 5.0)),
        rtol=1e-9)


def test_plot_ccfs_multi_pair_panels():
    assert len(xplot.plot_ccfs(two_pairs()).figure.axes) == 2


@pytest.mark.parametrize("variant", [
    {"spectrogram_kwargs": SPEC},
    {"spectrogram_cwt": True, "spectrogram_kwargs": CPU},
    {"spectrogram_contourf": True, "spectrogram_kwargs": SPEC}],
    ids=["stft", "cwt", "contourf"])
def test_plot_ccfs_spectrogram_variants(variant):
    gs = xplot.plot_ccfs(two_pairs(), spectrogram=True, **variant)
    # 2 cc axes + 2 spectrogram axes + colorbar
    assert len(gs.figure.axes) == 5
    clims = {m.get_clim() for ax in gs.figure.axes
             for m in ax.collections if hasattr(m, "get_clim")}
    clims.discard((None, None))
    assert len(clims) == 1, clims
    if variant.get("spectrogram_contourf"):
        assert any(isinstance(c, QuadContourSet)
                   for ax in gs.figure.axes for c in ax.collections)


def test_plot_ccf_cwt_and_contourf_variants():
    gs = xplot.plot_ccf(make_ds(), spectrogram_cwt=True,
                        spectrogram_kwargs={"fmin": 1.0, "fmax": 8.0,
                                            "nfreqs": 16, **CPU})
    assert len(gs.figure.axes) == 3
    plt.close("all")
    gs = xplot.plot_ccf(make_ds(), spectrogram_contourf=True,
                        spectrogram_kwargs=SPEC)
    assert any(isinstance(c, QuadContourSet)
               for c in gs.figure.axes[1].collections)


def test_plot_panel_raises_without_a_card(monkeypatch):
    """The spectrogram panel runs on the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xplot.plot_ccf(make_ds())


def test_plot_ccfs_colored_snr_filter():
    ds = make_ds()
    nt = ds.dims["time"]
    snr_vals = np.full((1, nt), 5.0)
    snr_vals[0, :2] = 50.0  # only 2 windows pass
    snr = DataArray(snr_vals, dims=("pair", "time"),
                    coords={"pair": ds.coords["pair"],
                            "time": ds.coords["time"]}, name="snr")
    _, ax = plt.subplots()
    xplot.plot_ccfs_colored(ds, sn=snr, sn_threshold=10.0, ax=ax)
    assert len(ax.lines) == 2
    _, ax = plt.subplots()
    xplot.plot_ccfs_colored(ds, ax=ax)
    assert len(ax.lines) == nt


def test_accessor_plot_passthroughs():
    ds = make_ds()
    assert ds.xcorr.plot_ccfs_colored() is not None
    assert ds.xcorr.plot_ccf(spectrogram_kwargs=SPEC) is not None
    assert ds.xcorr.plot_ccfs() is not None
    nt = 30
    sds = Dataset()
    sds.coords["pair"] = np.array(["P-Q"], dtype=object)
    sds.coords["time"] = pd.date_range("2014-01-01", periods=nt,
                                       freq="3h").values
    sds["snr"] = (("pair", "time"),
                  np.random.default_rng(2).uniform(1, 5, (1, nt)))
    assert len(sds.xcorr.plot_snr_ct().lines) == 1


def test_set_year_labels():
    _, ax = plt.subplots()
    xplot.set_year_labels(ax, start="2015-01-01", end="2018-01-01")
    assert [t.get_text() for t in ax.get_xticklabels(minor=True)] == \
        ["2015", "2016", "2017"]


def test_accessor_other_methods():
    """``ds.xcorr``'s non-plot methods reach the port's functions."""
    ds = make_ds()
    assert ds.xcorr.version == "n/a"
    assert ds.xcorr.hash() == T.util.hash_Dataset(ds, metadata_only=False)
    assert ds.xcorr.hash_metadata() == T.util.hash_Dataset(
        ds, metadata_only=True)
