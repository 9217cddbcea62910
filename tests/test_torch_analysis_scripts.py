"""The port's analysis CLIs, ``xcorr-torch-snr`` -> ``xcorr-torch-ct`` ->
``xcorr-torch-psd`` (``xcorr_tpu_torch/scripts/{snr,ct,psd}.py``), against
the JAX package's ``xcorr-snr`` -> ``xcorr-ct`` -> ``xcorr-psd`` on the
CPU: both chains read one module-scoped shard archive made by the port's
``lazy_process(device="cpu")`` (3 pairs, 2 days, 5 Hz, 1 h windows, the
archive of ``tests/test_scripts.py``) with the arguments of
``tests/test_scripts.py:70-133``.

Tolerances: both packages postprocess in float32 (the shards' dtype) with
different FFTs and filter recursions, so the SNR files agree within 1e-4
relative on ``snr``, ``s`` and ``n``; ``lag_s_max`` is equal; the
coincidence triggers are identical; the PSD period files have the same
names and their ``psd`` agrees within 1e-4 of its max. Also the CLIs' own
options: ``--plot`` draws as the JAX scripts do, the multi-host options
raise, and without a card each script raises unless given ``--platform
cpu``.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu
import xcorr_tpu_torch as T
from xcorr_tpu.scripts import ct as jct, psd as jpsd, snr as jsnr
from xcorr_tpu_torch.scripts import ct as tct, psd as tpsd, snr as tsnr

FS = 5.0
RTOL = 1e-4
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("taper", {"type": "cosine", "max_percentage": 0.05,
                    "max_length": 30.0})]
PAIRS = ["IM.H03S1..EDH-IU.RAR.10.BHZ", "IM.H03S2..EDH-IU.RAR.10.BHZ",
         "IM.H03S3..EDH-IU.RAR.10.BHZ"]
CELERITY = ["--celerity", "1400", "90000000", "--filter-freq", "0.5"]


def _inventory():
    ch = T.stream.Channel
    return T.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.60, longitude=-78.80),
        ch("IM", "H03S2", "", "EDH", latitude=-33.62, longitude=-78.82),
        ch("IM", "H03S3", "", "EDH", latitude=-33.61, longitude=-78.78),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """2 days of CCF shards for 3 pairs from the port's host engine."""
    root = str(tmp_path_factory.mktemp("cc"))
    client = T.stream.SyntheticClient(
        sampling_rate=FS,
        delays={"IM.H03S1..EDH": 0.0, "IM.H03S2..EDH": 0.3,
                "IM.H03S3..EDH": 0.6, "IU.RAR.10.BHZ": 4.0},
        source_period=600.0, source_amplitude=20.0)
    times = pd.date_range("2014-01-01", periods=2, freq="1D")
    init_args = dict(preprocess={"EDH": CHAIN, "BHZ": CHAIN},
                     attrs={"institution": "t", "author": "t",
                            "source": "t"},
                     sampling_rate=FS, window_length=3600.0,
                     window_overlap=0.5, clip_lag=(-100.0, 100.0),
                     inventory=_inventory())
    assert all(T.lazy_process(PAIRS, times, init_args, client,
                              inventory=_inventory(), root=root,
                              nworkers=2, verb=0, device="cpu"))
    return root


@pytest.fixture(scope="module")
def runs(archive, tmp_path_factory):
    """Each package's snr -> ct -> psd chain on the archive."""
    out = {}
    for name, (snr, ct, psd), extra in [
            ("jax", (jsnr, jct, jpsd), []),
            ("port", (tsnr, tct, tpsd), ["--platform", "cpu"])]:
        d = tmp_path_factory.mktemp(name)
        f_snr, f_ct = str(d / "snr.nc"), str(d / "ct.nc")
        assert snr.main(["2014-01-01", "2014-01-02", "--root", archive,
                         *CELERITY, "--out", f_snr, "--institution", "t",
                         "--author", "t", "--source", "t", "-n", "2",
                         *extra]) == 0
        assert ct.main([f_snr, "--threshold", "0.0001", "--out", f_ct,
                        "--csv", str(d / "ct.csv"), *extra]) == 0
        assert psd.main([f_ct, "--root", archive, "--outdir",
                         str(d / "out"), *CELERITY, "--duration", "10.0",
                         "--padding-factor", "2", "--fmax", "2.0", "-n",
                         "2", *extra]) == 0
        out[name] = (f_snr, f_ct, str(d / "out"), str(d / "ct.csv"))
    return out


def test_snr_files_agree(runs):
    want = xcorr_tpu.io.from_netcdf(runs["jax"][0])
    got = xcorr_tpu.io.from_netcdf(runs["port"][0])
    assert got.dims == want.dims and got.dims["pair"] == 3
    np.testing.assert_array_equal(got.coords["pair"].values,
                                  want.coords["pair"].values)
    np.testing.assert_array_equal(got.coords["time"].values,
                                  want.coords["time"].values)
    for name in ("snr", "s", "n"):
        np.testing.assert_allclose(got[name].values, want[name].values,
                                   rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got["lag_s_max"].values,
                                  want["lag_s_max"].values)


def test_ct_files_agree(runs):
    want = xcorr_tpu.io.from_netcdf(runs["jax"][1])
    got = xcorr_tpu.io.from_netcdf(runs["port"][1])
    np.testing.assert_array_equal(got["ct"].values, want["ct"].values)
    assert got["ct"].attrs["nperiods"] == want["ct"].attrs["nperiods"] >= 1
    with open(runs["jax"][3]) as fj, open(runs["port"][3]) as ft:
        assert ft.read() == fj.read()


def test_psd_period_files_agree(runs):
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    jroot, troot = runs["jax"][2], runs["port"][2]
    names = files(jroot)
    assert names and files(troot) == names
    for name in names:
        want = xcorr_tpu.io.from_netcdf(os.path.join(jroot, name))
        got = xcorr_tpu.io.from_netcdf(os.path.join(troot, name))
        w = want["psd"].values
        assert got["psd"].values.shape == w.shape
        err = np.nanmax(np.abs(got["psd"].values - w)) / np.nanmax(np.abs(w))
        assert err <= RTOL, (name, err)
        np.testing.assert_array_equal(got.coords["freq"].values,
                                      want.coords["freq"].values)
        assert float(got.coords["freq"].values.max()) <= 2.0
        np.testing.assert_allclose(got["snr"].values, want["snr"].values,
                                   rtol=RTOL)


def _argv(script, path, platform=True):
    """Minimal arguments of each script; ``path`` is a file or root."""
    argv = {"snr": ["2014-01-01", "2014-01-01", "--root", path],
            "ct": [path], "psd": [path, "--root", path]}[script]
    return argv + (["--platform", "cpu"] if platform else [])


SCRIPTS = {"snr": tsnr, "ct": tct, "psd": tpsd}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_plot_stops_the_run(script, archive, runs, tmp_path):
    """``--plot`` lets the run finish and draws what the JAX script draws
    (Agg backend): ``snr`` one line per pair, ``ct`` those lines and one
    shaded span per triggered period, ``psd`` nothing."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    f_snr, f_ct = runs["port"][:2]
    argv = {"snr": ["2014-01-01", "2014-01-02", "--root", archive,
                    *CELERITY, "--out", str(tmp_path / "snr.nc"),
                    "--institution", "t", "--author", "t", "--source",
                    "t"],
            "ct": [f_snr, "--threshold", "0.0001", "--out",
                   str(tmp_path / "ct.nc")],
            "psd": [f_ct, "--root", archive, "--outdir",
                    str(tmp_path / "out"), *CELERITY, "--duration",
                    "10.0", "--padding-factor", "2", "--fmax", "2.0"]}
    plt.close("all")
    try:
        assert SCRIPTS[script].main(argv[script] + ["--platform", "cpu",
                                                    "--plot"]) == 0
        axes = [ax for n in plt.get_fignums()
                for ax in plt.figure(n).axes]
        if script == "psd":
            assert not axes
            return
        assert len(axes) == 1 and len(axes[0].lines) == len(PAIRS)
        nperiods = int(xcorr_tpu.io.from_netcdf(f_ct)["ct"]
                       .attrs["nperiods"])
        assert len(axes[0].collections) == (nperiods if script == "ct"
                                            else 0)
    finally:
        plt.close("all")


@pytest.mark.parametrize("option", [["--coordinator", "localhost:1234"],
                                    ["--num-processes", "2"],
                                    ["--process-id", "0"]],
                         ids=["coordinator", "num-processes", "process-id"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_multi_host_options_raise(script, option, tmp_path):
    with pytest.raises(SystemExit, match="multi-host"):
        SCRIPTS[script].main(_argv(script, str(tmp_path)) + option)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripts_raise_without_a_card(script, tmp_path, monkeypatch):
    """No ``--platform``: the scripts run on ``cuda``, which raises when
    torch sees no card, before reading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[script].main(_argv(script, str(tmp_path), platform=False))


def test_pair_snr_is_the_day_estimate(archive):
    """``pair_snr`` on an in-memory dataset gives what
    ``estimate_snr_for_day`` gives from the shard."""
    day = pd.Timestamp("2014-01-01")
    want = tsnr.estimate_snr_for_day(PAIRS[:1], day, archive,
                                     celerity=(1400.0, 9e7),
                                     filter_kwargs={"frequency": 0.5},
                                     device="cpu")
    got = tsnr.pair_snr(T.read(T.ncfile(PAIRS[0], day, archive)),
                        celerity=(1400.0, 9e7),
                        filter_kwargs={"frequency": 0.5}, device="cpu")
    for name in ("snr", "s", "n", "lag_s_max"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
