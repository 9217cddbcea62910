"""The rest of the port's analysis tier, the beamform, plmax, swresp and
timelapse paths (``xcorr_tpu_torch/scripts/{beamform,plmax,swresp,
timelapse}.py``), against the JAX package's on the CPU. Both read one
module-scoped shard archive made by the port's ``lazy_process(device=
"cpu")`` (3 pairs, 2 days, 5 Hz, 1 h windows: the archive of
``tests/test_scripts.py``), with the arguments of
``tests/test_scripts.py:136-278``.

Tolerances: both packages postprocess the float32 shards with different
FFTs and filter recursions, so float results agree within 1e-4 relative
(swresp ratio, timelapse peaks; plmax values within 1e-4 of their
largest) and discrete ones are equal
(beamform lags, hence every beamform output; plmax peak positions;
timelapse shifts). ``correlate_spectrograms`` on one stack is held within
1e-6 with equal shifts, tail batch included. Also: each function on
datasets in memory gives what its shard-reading form gives, the CLIs
write what the JAX CLIs write, ``mesh=`` gives what no mesh gives, the
multi-host options join a group or raise as the JAX CLIs' do, and
without a card each CLI raises unless given ``--platform cpu``.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu
import xcorr_tpu_torch as T
from xcorr_tpu.scripts import (beamform as jbf, plmax as jplm,
                               swresp as jsw, timelapse as jtl)
from xcorr_tpu_torch.scripts import (beamform as tbf, plmax as tplm,
                                     swresp as tsw, timelapse as ttl)

FS = 5.0
RTOL = 1e-4
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("taper", {"type": "cosine", "max_percentage": 0.05,
                    "max_length": 30.0})]
PAIRS = ["IM.H03S1..EDH-IU.RAR.10.BHZ", "IM.H03S2..EDH-IU.RAR.10.BHZ",
         "IM.H03S3..EDH-IU.RAR.10.BHZ"]
ATTRS = {"institution": "t", "author": "t", "source": "t"}
CLIM = (1400.0, 90_000_000.0)
HIGHPASS = {"frequency": 0.5, "btype": "highpass", "order": 2}
DAY = pd.Timestamp("2014-01-01")
BANDS = ((0.4, 1.0), (1.0, 2.0))
CLI_COMMON = ["--filter-freq", "0.5", "--celerity", "1400", "90000000"]
CLI_ATTRS = ["--institution", "t", "--author", "t", "--source", "t"]


def _inventory(pkg=T):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
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
    init_args = dict(preprocess={"EDH": CHAIN, "BHZ": CHAIN}, attrs=ATTRS,
                     sampling_rate=FS, window_length=3600.0,
                     window_overlap=0.5, clip_lag=(-100.0, 100.0),
                     inventory=_inventory())
    assert all(T.lazy_process(PAIRS, times, init_args, client,
                              inventory=_inventory(), root=root,
                              nworkers=2, verb=0, device="cpu"))
    return root


def shard(archive, pair, day=DAY):
    return T.read(T.ncfile(pair, day, archive))


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# -- beamform ---------------------------------------------------------------

@pytest.mark.parametrize("envelope", [False, True])
def test_beamform_day(archive, envelope):
    kw = dict(clim=CLIM, envelope=envelope, attrs=ATTRS,
              filter_kwargs=HIGHPASS)
    want = jbf.beamform_day(PAIRS, DAY, archive, _inventory(xcorr_tpu),
                            **kw)
    got = tbf.beamform_day(PAIRS, DAY, archive, _inventory(), device="cpu",
                           **kw)
    for name in ("s_x", "s_y", "doa", "vel", "err", "x", "y"):
        np.testing.assert_allclose(got[name].values, want[name].values,
                                   rtol=1e-9, atol=0, err_msg=name)
    np.testing.assert_array_equal(got.coords["time"].values,
                                  want.coords["time"].values)
    mem = tbf.beamform_datasets([shard(archive, p) for p in PAIRS],
                                _inventory(), device="cpu", **kw)
    for name in ("s_x", "s_y", "doa", "vel", "err"):
        np.testing.assert_array_equal(mem[name].values, got[name].values)


def test_beamform_needs_three_pairs(archive):
    assert tbf.beamform_datasets([shard(archive, p) for p in PAIRS[:2]],
                                 _inventory(), clim=CLIM, attrs=ATTRS,
                                 filter_kwargs=HIGHPASS,
                                 device="cpu") is None


# -- plmax ------------------------------------------------------------------

def hold_peaks(got, want):
    """Same peaks (positions), values within RTOL."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    key = [c for c in want.columns if c not in ("value", "day")]
    g = got.sort_values(key).reset_index(drop=True)
    w = want.sort_values(key).reset_index(drop=True)
    for c in key + ["day"] * ("day" in want.columns):
        np.testing.assert_array_equal(g[c].values, w[c].values)
    np.testing.assert_allclose(g["value"].values, w["value"].values,
                               rtol=0, atol=RTOL * w["value"].abs().max())


@pytest.mark.parametrize("wavelet", [False, True], ids=["stft", "cwt"])
def test_plmax_day(archive, wavelet):
    kw = dict(clim=CLIM, min_distance=5, duration=10.0, wavelet=wavelet,
              filter_kwargs=HIGHPASS)
    want = jplm.plmax_day(PAIRS[0], DAY, archive, **kw)
    got = tplm.plmax_day(PAIRS[0], DAY, archive, device="cpu", **kw)
    hold_peaks(got, want)
    mem = tplm.pair_plmax(shard(archive, PAIRS[0]), device="cpu", **kw)
    pd.testing.assert_frame_equal(mem, got.drop(columns="day"))


# -- swresp -----------------------------------------------------------------

def well_conditioned(archive, nfreq, days=(DAY,), level=3e-2):
    """(time, freq) bins of swresp's Z and R pairs (``PAIRS[:2]``) where
    the JAX package's |Y_Z| and |Y_R| both exceed ``level`` of their max:
    elsewhere the ratio and phase of two float32 spectra are rounding
    noise over rounding noise."""
    keep = True
    for pair in PAIRS[:2]:
        cc = [xcorr_tpu.postprocess(xcorr_tpu.read(xcorr_tpu.ncfile(
            pair, day, archive)), clim=CLIM,
            filter_kwargs=HIGHPASS)["cc"].values[0] for day in days]
        Y = np.abs(np.fft.rfft(np.concatenate(cc), axis=-1))[:, :nfreq]
        keep = keep & (Y > level * Y.max(axis=-1, keepdims=True))
    return keep


def hold_swresp(got, want, keep):
    assert keep.mean() > 0.5
    assert_close(got["ratio"].values[keep], want["ratio"].values[keep])
    dphase = np.angle(np.exp(1j * (got["phase"].values
                                   - want["phase"].values)))
    assert np.abs(dphase[keep]).max() <= RTOL


def test_swresp_day(archive):
    """Ratio within 1e-4 relative and phase within 1e-4 rad on the
    well-conditioned bins (about 70% here)."""
    kw = dict(clim=CLIM, attrs=ATTRS, filter_kwargs=HIGHPASS)
    want = jsw.swresp_day(PAIRS[0], PAIRS[1], DAY, archive, **kw)
    got = tsw.swresp_day(PAIRS[0], PAIRS[1], DAY, archive, device="cpu",
                         **kw)
    assert got["ratio"].dims == want["ratio"].dims == ("time", "freq")
    np.testing.assert_array_equal(got.coords["freq"].values,
                                  want.coords["freq"].values)
    np.testing.assert_array_equal(got.coords["time"].values,
                                  want.coords["time"].values)
    hold_swresp(got, want, well_conditioned(archive, want.sizes["freq"]))
    mem = tsw.swresp_datasets(shard(archive, PAIRS[0]),
                              shard(archive, PAIRS[1]), device="cpu", **kw)
    for name in ("ratio", "phase"):
        np.testing.assert_array_equal(mem[name].values, got[name].values)


# -- timelapse --------------------------------------------------------------

def test_timelapse(archive):
    kw = dict(freq_bands=BANDS, clim=CLIM, duration=10.0,
              filter_kwargs=HIGHPASS, verb=0)
    times = pd.DatetimeIndex([DAY, DAY + pd.Timedelta(days=1)])
    want = jtl.timelapse(PAIRS[:2], times, archive, **kw)
    got = ttl.timelapse(PAIRS[:2], times, archive, device="cpu", **kw)
    assert got["cc2"].dims == want["cc2"].dims
    np.testing.assert_array_equal(got["status"].values,
                                  want["status"].values)
    assert (got["status"].values == 1).all()
    assert_close(got["cc2"].values, want["cc2"].values)
    for name in ("delta_freq", "delta_lag"):
        np.testing.assert_array_equal(got[name].values, want[name].values)


def spectrogram_stack(seed=21, shape=(6, 9, 40)):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("batch", [64, 4, 1], ids=["one", "tail", "single"])
def test_correlate_spectrograms(batch):
    specs = spectrogram_stack()
    ii, jj = np.triu_indices(specs.shape[0])
    pk, df, dl = jtl.correlate_spectrograms(specs, ii, jj)
    got = ttl.correlate_spectrograms(specs, ii, jj, batch=batch,
                                     device="cpu")
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    np.testing.assert_allclose(got[0], pk, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], df)
    np.testing.assert_array_equal(got[2], dl)
    np.testing.assert_allclose(got[0][ii == jj], 1.0, atol=1e-6)


def test_pair_spectrograms_skip_missing_days(archive):
    """A missing day and a day that postprocess empties give None; the
    others are the spectrograms the timelapse correlates."""
    times = pd.DatetimeIndex([DAY, DAY + pd.Timedelta(days=1), DAY])
    empty = shard(archive, PAIRS[0])
    empty["status"].values[...] = 0
    specs, freq = ttl.pair_spectrograms(
        [shard(archive, PAIRS[0]), None, empty], times, clim=CLIM,
        duration=10.0, filter_kwargs=HIGHPASS, device="cpu")
    assert specs[1] is None and specs[2] is None
    assert specs[0].dtype == np.float32
    assert specs[0].shape[0] == freq.size
    assert specs[0].shape[1] == T.postprocess(
        shard(archive, PAIRS[0]), clim=CLIM, filter_kwargs=HIGHPASS,
        device="cpu").sizes["lag"]


def test_mesh_equals_no_mesh(archive):
    """``mesh=`` splits the cells over a logical CPU mesh: the port's
    result without a mesh exactly, and the JAX package's with its 8-device
    CPU mesh within this file's bars."""
    from xcorr_tpu.parallel import make_mesh as jmake_mesh
    from xcorr_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=["cpu"] * 3)
    kw = dict(freq_bands=BANDS, clim=CLIM, duration=10.0,
              filter_kwargs=HIGHPASS, verb=0)
    times = pd.DatetimeIndex([DAY, DAY + pd.Timedelta(days=1)])
    plain = ttl.timelapse(PAIRS[:2], times, archive, device="cpu", **kw)
    got = ttl.timelapse(PAIRS[:2], times, archive, device="cpu",
                        mesh=mesh, batch=4, **kw)
    want = jtl.timelapse(PAIRS[:2], times, archive, mesh=jmake_mesh(8),
                         batch=4, **kw)
    for name in ("cc2", "delta_freq", "delta_lag", "status"):
        np.testing.assert_array_equal(got[name].values, plain[name].values)
    assert (got["status"].values == 1).all()
    assert_close(got["cc2"].values, want["cc2"].values)
    for name in ("delta_freq", "delta_lag"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    specs = spectrogram_stack()
    ii, jj = np.triu_indices(specs.shape[0])
    for g, p in zip(ttl.correlate_spectrograms(specs, ii, jj, batch=4,
                                               mesh=mesh),
                    ttl.correlate_spectrograms(specs, ii, jj, batch=4,
                                               device="cpu")):
        np.testing.assert_array_equal(g, p)


# -- the CLIs ---------------------------------------------------------------

def _cli_argv(script, archive, tmp_path, out):
    if script == "beamform":
        inv = str(tmp_path / "inv.json")
        _inventory().to_json(inv)
        return ["2014-01-01", "2014-01-02", "--root", archive,
                *sum((["--pair", p] for p in PAIRS), []), "--inventory",
                inv, *CLI_COMMON, "--out", out, *CLI_ATTRS]
    if script == "plmax":
        return ["2014-01-01", "2014-01-02", "--root", archive, "--pair",
                PAIRS[0], *CLI_COMMON, "--min-distance", "5", "--out", out]
    if script == "swresp":
        return ["2014-01-01", "2014-01-02", "--root", archive, "--pair-z",
                PAIRS[0], "--pair-r", PAIRS[1], *CLI_COMMON, "--out", out,
                *CLI_ATTRS]
    return ["all", "--start", "2014-01-01", "--end", "2014-01-02",
            "--root", archive, "--pair", PAIRS[0], "--freq", "0.4", "1.0",
            "--duration", "10.0", *CLI_COMMON, "--out", out, *CLI_ATTRS]


SCRIPTS = {"beamform": (jbf, tbf), "plmax": (jplm, tplm),
           "swresp": (jsw, tsw), "timelapse": (jtl, ttl)}
#: variables each netCDF product is held on, and whether exactly
PRODUCTS = {"beamform": {"s_x": True, "s_y": True, "doa": True,
                         "vel": True, "err": True},
            "timelapse": {"cc2": False, "delta_freq": True,
                          "delta_lag": True, "status": True}}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_cli_matches_jax(script, archive, tmp_path):
    ext = ".csv" if script == "plmax" else ".nc"
    outs = {}
    for name, mod, extra in [("jax", SCRIPTS[script][0], []),
                             ("port", SCRIPTS[script][1],
                              ["--platform", "cpu"])]:
        out = str(tmp_path / f"{name}{ext}")
        assert mod.main(_cli_argv(script, archive, tmp_path, out)
                        + extra) == 0
        outs[name] = out
    if script == "plmax":
        hold_peaks(pd.read_csv(outs["port"]), pd.read_csv(outs["jax"]))
        return
    want = xcorr_tpu.io.from_netcdf(outs["jax"])
    got = xcorr_tpu.io.from_netcdf(outs["port"])
    assert got.dims == want.dims
    if script == "swresp":
        hold_swresp(got, want, well_conditioned(
            archive, want.sizes["freq"],
            days=pd.date_range(DAY, periods=2, freq="1D")))
    for name, exact in PRODUCTS.get(script, {}).items():
        if exact:
            np.testing.assert_array_equal(got[name].values,
                                          want[name].values)
        else:
            assert_close(got[name].values, want[name].values)


def _minimal_argv(script, path, platform=True):
    argv = {"beamform": ["2014-01-01", "2014-01-01", "--root", path,
                         "--pair", "A-B", "--inventory", path],
            "plmax": ["2014-01-01", "2014-01-01", "--root", path,
                      "--pair", "A-B"],
            "swresp": ["2014-01-01", "2014-01-01", "--root", path,
                       "--pair-z", "A-B", "--pair-r", "A-C"],
            "timelapse": ["all", "--start", "2014-01-01", "--end",
                          "2014-01-01", "--root", path, "--pair",
                          "A-B"]}[script]
    return argv + (["--platform", "cpu"] if platform else [])


@pytest.mark.parametrize("option", ["coordinator", ["--num-processes", "2"],
                                    ["--process-id", "0"]],
                         ids=["coordinator", "num-processes", "process-id"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_multi_host_options(script, option, archive, tmp_path):
    """``--num-processes`` or ``--process-id`` without a coordinator
    raises ``SystemExit``, as the JAX CLIs do; with ``--coordinator`` the
    script joins a one-process group and runs to its end."""
    import socket
    from xcorr_tpu_torch.parallel import distributed
    if option != "coordinator":
        for mod in SCRIPTS[script]:
            with pytest.raises(SystemExit, match="require --coordinator"):
                mod.main(_minimal_argv(script, str(tmp_path)) + option)
        return
    ext = ".csv" if script == "plmax" else ".nc"
    out = str(tmp_path / f"port{ext}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        assert SCRIPTS[script][1].main(
            _cli_argv(script, archive, tmp_path, out)
            + ["--platform", "cpu", "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", "1", "--process-id", "0"]) == 0
        assert torch.distributed.get_world_size() == 1
    finally:
        distributed.shutdown()
    assert os.path.exists(out)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripts_raise_without_a_card(script, tmp_path, monkeypatch):
    """No ``--platform``: the scripts run on ``cuda``, which raises when
    torch sees no card, before reading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[script][1].main(_minimal_argv(script, str(tmp_path),
                                              platform=False))


@pytest.mark.parametrize("fn", ["beamform_datasets", "pair_plmax",
                                "swresp_datasets", "pair_spectrograms",
                                "correlate_spectrograms"])
def test_functions_raise_without_a_card(fn, archive, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = shard(archive, PAIRS[0])
    calls = {
        "beamform_datasets": lambda: tbf.beamform_datasets(
            [ds] * 3, _inventory()),
        "pair_plmax": lambda: tplm.pair_plmax(ds),
        "swresp_datasets": lambda: tsw.swresp_datasets(ds, ds),
        "pair_spectrograms": lambda: ttl.pair_spectrograms([ds], [DAY]),
        "correlate_spectrograms": lambda: ttl.correlate_spectrograms(
            spectrogram_stack(), [0], [1]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[fn]()
