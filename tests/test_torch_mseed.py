"""The miniSEED path of the PyTorch port against the JAX package on the
CPU: the carried codec (``xcorr_tpu_torch/native``) reads what the JAX
package writes and the reverse, bit for bit; the header scan agrees; the
C++ source is a byte copy; and a host-engine campaign on a miniSEED SDS
archive writes the JAX package's shards (CCFs within 1e-6 abs, the
repository's bar; status and offsets exact). No network: the archive is
written by the codec itself.
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu.stream import sds as jsds
from xcorr_tpu_torch.stream import sds as tsds

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6
FS = 5.0
WINDOW = 3600.0
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
CHAIN = [
    ("detrend", {"type": "demean"}),
    ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
    ("detrend", {"type": "demean"}),
    ("taper", {"type": "cosine", "max_percentage": 0.05,
               "max_length": 30.0}),
]


def _trace(pkg, n=120_000, seed=0):
    rng = np.random.default_rng(seed)
    data = np.round(1000 * rng.standard_normal(n)).astype(np.int32)
    data[::97] += 1_000_000        # 32-bit Steim differences too
    return pkg.stream.Trace(data, pkg.stream.Stats(
        network="IU", station="RAR", location="10", channel="BHZ",
        starttime="2014-01-02T03:04:05.120000", sampling_rate=50.0))


def test_mseed_source_is_a_byte_copy():
    assert (ROOT / "xcorr_tpu_torch/native/mseed.cpp").read_bytes() == \
        (ROOT / "xcorr_tpu/native/mseed.cpp").read_bytes()


@pytest.mark.parametrize("writer", ["jax_writes", "port_writes"])
def test_sds_day_reads_across_packages(tmp_path, writer):
    """A day file one package writes, the other's SDSArchive reads back
    bit-equal, with the same stats."""
    wpkg, rpkg = ((xcorr_tpu, xcorr_tpu_torch) if writer == "jax_writes"
                  else (xcorr_tpu_torch, xcorr_tpu))
    tr = _trace(wpkg)
    wmod = jsds if wpkg is xcorr_tpu else tsds
    rmod = tsds if wpkg is xcorr_tpu else jsds
    wmod.SDSArchive(str(tmp_path), format="mseed").write(
        wpkg.stream.Stream([tr]))
    back = rmod.SDSArchive(str(tmp_path)).read(tr.id, "2014-01-02T12:00")
    assert len(back) == 1
    assert type(back[0]).__module__.startswith(rpkg.__name__ + ".")
    assert back[0].data.dtype == tr.data.dtype
    np.testing.assert_array_equal(back[0].data, tr.data)
    assert back[0].id == tr.id
    assert back[0].stats.sampling_rate == tr.stats.sampling_rate
    assert back[0].stats.starttime.ns == tr.stats.starttime.ns


def test_scan_dayfile_agrees(tmp_path):
    tr = _trace(xcorr_tpu)
    jsds.SDSArchive(str(tmp_path), format="mseed").write(
        xcorr_tpu.stream.Stream([tr]))
    s = tr.stats
    path = jsds.sds_path(str(tmp_path), s.network, s.station, s.location,
                         s.channel, s.starttime)
    want = jsds.scan_dayfile(path)
    assert len(want) > 1
    assert tsds.scan_dayfile(path) == want
    assert sum(seg[2] for seg in want) == s.npts


def _archive(root):
    """Three days of the synthetic pair as miniSEED day files written by
    the JAX package (int32 counts: the synthesizer's float samples
    scaled by 1000)."""
    synth = xcorr_tpu.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 0.0,
                                  "IU.RAR.10.BHZ": 4.0},
        source_period=600.0, source_amplitude=20.0)
    archive = jsds.SDSArchive(root, format="mseed")
    for receiver in ("IM.H03S1..EDH", "IU.RAR.10.BHZ"):
        for day in ("2013-12-31", "2014-01-01", "2014-01-02"):
            tr = synth._synthesize_day(receiver, day)[0]
            tr.data = np.round(1000 * tr.data).astype(np.int32)
            archive.write(xcorr_tpu.stream.Stream([tr]))


def _init_args(pkg):
    ch = pkg.stream.Channel
    inv = pkg.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])
    return inv, dict(preprocess={"EDH": CHAIN, "BHZ": CHAIN},
                     attrs={"institution": "t", "author": "t",
                            "source": "mseed"},
                     sampling_rate=FS, window_length=WINDOW,
                     window_overlap=0.5, clip_lag=(-100.0, 100.0),
                     inventory=inv)


def test_host_campaign_on_mseed_archive_matches_reference(tmp_path):
    """Both packages run ``lazy_process`` (host engine) on the same
    miniSEED archive; the port's shard equals the JAX package's."""
    sds = str(tmp_path / "sds")
    _archive(sds)
    times = pd.date_range("2014-01-01", periods=1, freq="1D")
    out = {}
    for pkg, kw in ((xcorr_tpu, {}), (xcorr_tpu_torch, {"device": "cpu"})):
        inv, args = _init_args(pkg)
        root = str(tmp_path / pkg.__name__)
        results = pkg.lazy_process([PAIR], times, args, {"sds_root": sds},
                                   inventory=inv, root=root, nworkers=1,
                                   verb=0, **kw)
        assert results == [True]
        out[pkg] = xcorr_tpu.read(pkg.ncfile(PAIR, times[0], root))
    got, want = out[xcorr_tpu_torch], out[xcorr_tpu]
    assert (got["status"].values == 1).all()
    for name in ("status", "pair_offset", "time_offset", "distance"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                               rtol=0, atol=ATOL)
    lag = got.coords["lag"].values
    peaks = lag[np.argmax(got["cc"].values[0], axis=-1)]
    np.testing.assert_allclose(peaks, -4.0, atol=1.0 / FS)
