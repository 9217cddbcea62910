"""The pair-day slice of the PyTorch port against the JAX reference on
the CPU: ``init`` -> ``process`` -> ``write`` / ``read`` and the host
``lazy_process``, at ``tests/test_core.py``'s configuration (5 Hz, 1 h
windows).

Tolerance: CCFs within 1e-6 abs (the repository's bar for normalized
CCFs); status and offsets exact; the shard schema equal apart from the
fields that differ by construction (the metadata hash, history
timestamps and dependency versions, and the data hash of a shard, since
the CCFs agree to the tolerance and not bit for bit).
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu import stream as jstream
from xcorr_tpu_torch import stream as tstream

ATOL = 1e-6
FS = 5.0
WINDOW = 3600.0
PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"
DELAY = 4.0
CHAIN = [
    ("detrend", {"type": "demean"}),
    ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
    ("detrend", {"type": "demean"}),
    ("taper", {"type": "cosine", "max_percentage": 0.05,
               "max_length": 30.0}),
]
PREPROCESS = {"EDH": CHAIN, "BHZ": CHAIN}
ATTRS = {"institution": "Test, dept", "author": "pytest - t@t",
         "source": "synthetic"}
#: attributes that differ between two runs by construction
VOLATILE = {"sha256_hash_metadata", "sha256_hash", "history",
            "dependencies_version"}


def _client(pkg, **kw):
    return pkg.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 0.0,
                                  "IU.RAR.10.BHZ": DELAY},
        source_period=600.0, source_amplitude=20.0, **kw)


def _inventory(pkg):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8),
    ])


def _init_args(pkg, **kw):
    args = dict(preprocess=PREPROCESS, attrs=ATTRS, sampling_rate=FS,
                window_length=WINDOW, window_overlap=0.5,
                clip_lag=(-100.0, 100.0), inventory=_inventory(pkg))
    args.update(kw)
    return args


def _init(pkg, endtime="2014-01-01T04:00", **kw):
    return pkg.init(pair=PAIR, starttime=pd.Timestamp("2014-01-01"),
                    endtime=pd.Timestamp(endtime), **_init_args(pkg, **kw))


def _plain(v):
    """Attribute value in a form ``==`` compares."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items() if k not in VOLATILE}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _schema(ds):
    """Variables, dims, coords and attrs of a dataset, volatile fields
    removed."""
    out = {"attrs": _plain(dict(ds.attrs)), "dims": dict(ds.dims)}
    for name in ds.coords:
        c = ds.coords[name]
        out[f"coord:{name}"] = (tuple(c.dims), str(c.dtype),
                                _plain(dict(c.attrs)))
    for name in ds.data_vars:
        v = ds[name]
        out[f"var:{name}"] = (tuple(v.dims), str(v.dtype),
                              _plain(dict(v.attrs)))
    return out


def _assert_same(got, want, atol=ATOL):
    assert _schema(got) == _schema(want)
    for name in ("status", "pair_offset", "time_offset", "distance"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
    for name in want.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[name].values),
                                      np.asarray(want.coords[name].values))
    np.testing.assert_allclose(got["cc"].values, want["cc"].values,
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def processed():
    """The same pair-day processed by both packages (biased and unbiased
    CC)."""
    out = {}
    for unbiased in (False, True):
        want = _init(xcorr_tpu, unbiased_cc=unbiased)
        xcorr_tpu.process(want, client=_client(xcorr_tpu), verb=0)
        got = _init(xcorr_tpu_torch, unbiased_cc=unbiased)
        xcorr_tpu_torch.process(got, client=_client(xcorr_tpu_torch),
                                device="cpu", verb=0)
        out[unbiased] = got, want
    return out


@pytest.mark.parametrize("unbiased", [False, True],
                         ids=["biased", "unbiased"])
def test_process_matches_reference(processed, unbiased):
    got, want = processed[unbiased]
    assert (got["status"].values == 1).all()
    _assert_same(got, want)
    lag = got.coords["lag"].values
    peaks = lag[np.argmax(got["cc"].values[0], axis=-1)]
    np.testing.assert_allclose(peaks, -DELAY, atol=1.0 / FS)


@pytest.mark.parametrize("direction", ["port_reads_reference",
                                       "reference_reads_port"])
def test_shards_cross_read(processed, tmp_path, direction):
    got, want = processed[False]
    if direction == "port_reads_reference":
        writer, reader = xcorr_tpu, xcorr_tpu_torch
    else:
        writer, reader = xcorr_tpu_torch, xcorr_tpu
    src = want if writer is xcorr_tpu else got
    path = writer.write(src, str(tmp_path / "shard.nc"), verb=0)
    back = reader.read(path)
    assert back is not None
    _assert_same(back, src, atol=0)


def test_written_shards_have_the_same_schema(processed, tmp_path):
    got, want = processed[False]
    a = xcorr_tpu.read(xcorr_tpu.write(want, str(tmp_path / "j.nc"),
                                       verb=0))
    b = xcorr_tpu_torch.read(xcorr_tpu_torch.write(
        got, str(tmp_path / "t.nc"), verb=0))
    _assert_same(b, a)
    assert "torch" in b.attrs["dependencies_version"]
    assert "jax" not in b.attrs["dependencies_version"]


class _NoFetch(tstream.SyntheticClient):
    def get_pair_processed_waveforms(self, *a, **k):
        raise AssertionError("a complete shard was processed again")


def test_lazy_process_resumes_reference_shards(tmp_path):
    """A port-side campaign skips the complete shards the reference
    wrote, and completes a fresh one like the reference does."""
    root = str(tmp_path / "cc")
    times = pd.date_range("2014-01-01", periods=2, freq="1D")
    args = _init_args(xcorr_tpu)
    assert all(xcorr_tpu.lazy_process(
        [PAIR], times[:1], args, _client(xcorr_tpu),
        inventory=_inventory(xcorr_tpu), root=root, nworkers=1, verb=0))
    first = xcorr_tpu_torch.ncfile(PAIR, times[0], root)
    mtime = os.path.getmtime(first)
    results = xcorr_tpu_torch.lazy_process(
        [PAIR], times[:1], _init_args(xcorr_tpu_torch),
        _NoFetch(sampling_rate=FS), inventory=_inventory(xcorr_tpu_torch),
        root=root, nworkers=1, verb=0, device="cpu")
    assert results == [True]
    assert os.path.getmtime(first) == mtime
    # the second day: fresh through the port, then resumed
    results = xcorr_tpu_torch.lazy_process(
        [PAIR], times, _init_args(xcorr_tpu_torch),
        _client(xcorr_tpu_torch), inventory=_inventory(xcorr_tpu_torch),
        root=root, nworkers=2, verb=0, device="cpu")
    assert results == [True, True]
    second = xcorr_tpu.read(xcorr_tpu_torch.ncfile(PAIR, times[1], root))
    assert (second["status"].values == 1).all()
    ref_root = str(tmp_path / "ref")
    assert all(xcorr_tpu.lazy_process(
        [PAIR], times[1:], args, _client(xcorr_tpu),
        inventory=_inventory(xcorr_tpu), root=ref_root, nworkers=1,
        verb=0))
    _assert_same(second, xcorr_tpu.read(
        xcorr_tpu.ncfile(PAIR, times[1], ref_root)))


def test_process_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = _init(xcorr_tpu_torch, endtime="2014-01-01T01:00")
    with pytest.raises(RuntimeError, match="CUDA"):
        xcorr_tpu_torch.process(ds, client=_client(xcorr_tpu_torch), verb=0)
    assert (ds["status"].values == 0).all()


def test_device_engine_not_ported(tmp_path):
    from xcorr_tpu_torch.core import lazy
    with pytest.raises(NotImplementedError, match="device engine"):
        lazy.single_threaded_process(
            PAIR, "2014-01-01", _init_args(xcorr_tpu_torch),
            _client(xcorr_tpu_torch), None, str(tmp_path), engine="device")
    with pytest.raises(NotImplementedError, match="device engine"):
        xcorr_tpu_torch.lazy_process(
            [PAIR], ["2014-01-01"], _init_args(xcorr_tpu_torch),
            _client(xcorr_tpu_torch), root=str(tmp_path), engine="device")


def test_missing_data_flags_like_reference():
    got = _init(xcorr_tpu_torch, endtime="2014-01-01T02:00")
    xcorr_tpu_torch.process(
        got, client=_client(xcorr_tpu_torch, missing={"IU.RAR.10.BHZ"}),
        device="cpu", verb=0)
    assert (got["status"].values == -1).all()
    xcorr_tpu_torch.process(got, client=_client(xcorr_tpu_torch),
                            retry_missing=True, device="cpu", verb=0)
    want = _init(xcorr_tpu, endtime="2014-01-01T02:00")
    xcorr_tpu.process(want, client=_client(xcorr_tpu), verb=0)
    _assert_same(got, want)


def test_stream_classes_are_the_ports_own():
    assert tstream.Trace is not jstream.Trace
    assert tstream.Trace.__module__ == "xcorr_tpu_torch.stream.trace"


def test_slice_runs_without_h5py(tmp_path):
    """The card's machine has no h5py: ``init`` -> ``process`` must work
    without it (the shard I/O is imported on first use). Checked in a
    subprocess where ``import h5py`` fails."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = f"""
import sys
sys.modules["h5py"] = None  # make `import h5py` fail
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
inv = Inventory([
    Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
    Channel("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])
ds = xt.init(pair={PAIR!r}, starttime="2014-01-01",
             endtime="2014-01-01T01:00", preprocess={PREPROCESS!r},
             attrs={ATTRS!r}, sampling_rate={FS}, window_length={WINDOW},
             window_overlap=0.5, clip_lag=(-100.0, 100.0), inventory=inv)
client = SyntheticClient(sampling_rate={FS},
                         delays={{"IU.RAR.10.BHZ": {DELAY}}})
xt.process(ds, client, device="cpu", verb=0)
assert (ds["status"].values == 1).all()
assert "h5py-not installed" in ds.attrs["dependencies_version"]
assert "h5py" not in sys.modules or sys.modules["h5py"] is None
"""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
