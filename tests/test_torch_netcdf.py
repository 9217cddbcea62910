"""The port's shard store against the JAX package's, on the CPU.

``xcorr_tpu_torch/io/netcdf.py`` sits on the port's own HDF5 codec
(``io/hdf5.py``: numpy and zlib, no HDF5 library); ``xcorr_tpu/io/
netcdf.py`` on h5py, which this machine has and the card's does not, so
h5py is the witness here:

- each package reads the files of both to the same Dataset (data, dims,
  coords, attrs and recovered encoding, exactly: the same bytes are
  stored and decoded);
- h5py sees a port-written file as it sees the reference-written file of
  the same Dataset (names, dtypes, shapes, chunks, filters and their
  options, dimension scales, attributes and data);
- the slice writes, reads and validates shards with ``import h5py``
  failing;
- files in the newer HDF5 format (superblocks 2 and 3, version-2 object
  headers, fletcher32, lzf) read alike; ``test_torch_hdf5_v2.py`` holds
  the rest of that format and the structures still refused.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from xcorr_tpu.io import netcdf as jnc
from xcorr_tpu_torch.io import hdf5
from xcorr_tpu_torch.io import netcdf as tnc

ROOT = Path(__file__).resolve().parents[1]
PAIR = "IM.H10N1..EDH-IM.H03S1..EDH"
FS = 5.0
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("taper", {"type": "cosine", "max_percentage": 0.05})]
ATTRS = {"institution": "Test, dept", "author": "pytest - t@t",
         "source": "synthetic"}


def _inventory(pkg):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
        ch("IM", "H10N1", "", "EDH", latitude=-7.6, longitude=72.5),
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8)])


def _init(pkg, **kw):
    return pkg.init(pair=PAIR, starttime=pd.Timestamp("2014-01-01"),
                    endtime=pd.Timestamp("2014-01-01T04:00"),
                    preprocess={"EDH": CHAIN}, attrs=ATTRS,
                    sampling_rate=FS, window_length=3600.0,
                    window_overlap=0.5, clip_lag=(-100.0, 100.0),
                    inventory=_inventory(pkg), **kw)


def _client(pkg):
    return pkg.stream.SyntheticClient(
        sampling_rate=FS, delays={"IM.H03S1..EDH": 4.0},
        source_period=600.0, source_amplitude=20.0)


@pytest.fixture(scope="module")
def shard():
    """A small production-shaped shard: ``init`` + ``process`` on the
    CPU, with the pair's preprocess dict in its stored (JSON) form, as
    ``io.write`` hands it to ``to_netcdf``."""
    from xcorr_tpu_torch.io.utils import preprocess_operations_to_json
    ds = _init(xcorr_tpu_torch)
    xcorr_tpu_torch.process(ds, _client(xcorr_tpu_torch), device="cpu",
                            verb=0)
    assert (ds["status"].values == 1).all()
    preprocess_operations_to_json(ds.coords["pair"])
    return ds


def _dataset(vars_, coords=None, attrs=None, encoding=None):
    from xcorr_tpu_torch.ndlabel import DataArray, Dataset
    ds = Dataset()
    for name, (dims, data, a) in (coords or {}).items():
        ds._coords[name] = DataArray(np.asarray(data), dims=dims, name=name,
                                     attrs=a)
    for name, (dims, data, a) in vars_.items():
        ds._vars[name] = DataArray(np.asarray(data), dims=dims, name=name,
                                   attrs=a)
    ds.attrs = dict(attrs or {})
    ds.encoding = dict(encoding or {})
    return ds


def _case_shard(shard):
    return shard


def _case_packed(shard):
    """``--pack-cc``: cc CF-packed as int16 (NaN windows included)."""
    ds = shard.copy()
    ds.attrs = dict(shard.attrs)
    ds["cc"].values[0, 1, :5] = np.nan
    ds.encoding = {**shard.encoding,
                   "cc": {**shard.encoding["cc"], "dtype": "int16"}}
    return ds


def _case_types(shard):
    """datetime, timedelta, bool, str (unicode) data; attributes of every
    kind ``_encode_attr`` stores; more members than one symbol table
    node holds."""
    t = pd.date_range("2014-01-01", periods=4, freq="3h").values
    vars_ = {
        "flag": (("time",), np.array([True, False, True, True]), {}),
        "dt": (("time",), np.array([1, 2, 3, 4], dtype="timedelta64[s]"),
               {"long_name": "offset"}),
        "label": (("time",), np.array(["a", "ü-ñ", "", "long " * 9]),
                  {"note": "strings, one empty"}),
        "i8": (("time",), np.arange(4, dtype=np.int8), {}),
        "u16": (("time",), np.arange(4, dtype=np.uint16), {}),
        "f16": (("time",), np.arange(4, dtype=np.float16), {}),
        "f64": (("time", "lag"), np.arange(12.0).reshape(4, 3),
                {"units": "1", "scale": 2.5, "count": 7,
                 "window": [1.0, 2.0], "flags": np.arange(3, dtype="i2"),
                 "when": np.datetime64("2014-01-01T00:00"),
                 "span": np.timedelta64(5, "s"), "missing": None,
                 "meta": {"a": 1, "b": [1, "x"]}, "names": ["x", "yy"],
                 "np_f32": np.float32(1.5), "unicode": "Σ ü",
                 "yes": True, "raw": b"bytes"}),
        "scalar": ((), np.float32(3.0), {}),
    }
    vars_.update({f"v{i:02d}": (("lag",), np.full(3, i, "i4"), {})
                  for i in range(12)})
    coords = {"time": (("time",), t, {"standard_name": "time"}),
              "lag": (("lag",), np.array([-1.0, 0.0, 1.0]), {"units": "s"})}
    return _dataset(vars_, coords, {"title": "types", "n": 3},
                    {"label": {"zlib": True, "complevel": 4,
                               "shuffle": True},
                     "f64": {"zlib": True, "complevel": 9}})


def _case_empty(shard):
    return _dataset({
        "e1": (("n",), np.zeros(0, "f4"), {}),
        "e2": (("n", "m"), np.zeros((0, 3)), {"units": "m"}),
        "es": (("n",), np.array([], dtype=object), {}),
        "ez": (("n",), np.zeros(0, "f8"), {}),
    }, attrs={"title": "empty"}, encoding={
        "ez": {"zlib": True, "complevel": 1, "shuffle": True}})


def _case_phony(shard):
    """Dims without a coordinate variable, beside one with."""
    return _dataset({
        "a": (("x", "y"), np.arange(6.0).reshape(2, 3), {}),
        "b": (("y",), np.arange(3, dtype="i8"), {}),
    }, coords={"x": (("x",), np.array([10, 20]), {})})


def _case_threaded(shard):
    """At least 4 MiB each: the threaded chunk compressor, nd (one chunk
    per row) and 1-D (eight-way split), and explicit chunk sizes giving
    more chunks than one B-tree node holds."""
    rng = np.random.default_rng(1)
    enc = {"zlib": True, "complevel": 1, "shuffle": True}
    return _dataset({
        "cc": (("pair", "time", "lag"),
               rng.normal(size=(1, 3, 400_001)).astype(np.float32), {}),
        "trace": (("sample",), rng.normal(size=1_200_003), {}),
        "small": (("k",), np.arange(1000, dtype="i4"), {}),
    }, attrs={"title": "threaded"}, encoding={
        "cc": enc, "trace": {**enc, "complevel": 3},
        "small": {"zlib": True, "complevel": 2, "chunksizes": (7,)}})


CASES = {"shard": _case_shard, "packed": _case_packed,
         "types": _case_types, "empty": _case_empty,
         "phony": _case_phony, "threaded": _case_threaded}


def _plain(v):
    """A value in a form ``==`` compares exactly, type included."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [type(v).__name__, [_plain(x) for x in v]]
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ["object", v.shape, [_plain(x) for x in v.reshape(-1)]]
        return [str(v.dtype), v.shape, v.tobytes()]
    if isinstance(v, np.generic):
        return [type(v).__name__, _plain(np.asarray(v))]
    return [type(v).__name__, v]


def _view(ds):
    """Everything a Dataset carries, for an exact comparison (the
    source path aside)."""
    out = {"attrs": _plain(dict(ds.attrs)), "dims": dict(ds.dims),
           "encoding": _plain({k: v for k, v in ds.encoding.items()
                               if k != "source"}),
           "coords": list(ds._coords), "vars": list(ds._vars)}
    for group in (ds._coords, ds._vars):
        for name, da in group.items():
            out[name] = (tuple(da.dims), _plain(np.asarray(da.data)),
                         _plain(dict(da.attrs)))
    return out


def _write_both(ds, tmp_path):
    ref, port = str(tmp_path / "ref.nc"), str(tmp_path / "port.nc")
    jnc.to_netcdf(ds, ref)
    tnc.to_netcdf(ds, port)
    return ref, port


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_reads_both_writers_alike(case, shard, tmp_path):
    ds = CASES[case](shard)
    ref, port = _write_both(ds, tmp_path)
    want = _view(jnc.from_netcdf(ref))
    assert want["vars"], case
    for reader in (jnc, tnc):
        for path in (ref, port):
            got = reader.from_netcdf(path)
            assert got.encoding["source"] == path
            assert _view(got) == want, (reader.__name__, path)


def _h5attrs(f, obj):
    out = {}
    for k in obj.attrs:
        v = obj.attrs[k]
        if k == "DIMENSION_LIST":
            v = [[f[r].name for r in refs] for refs in v]
        elif k == "REFERENCE_LIST":
            v = [(f[r].name, int(i)) for r, i in v]
        out[k] = _plain(v)
    return out


def _h5view(path):
    with h5py.File(path, "r") as f:
        out = {"/": _h5attrs(f, f), "keys": list(f.keys()),
               "superblock": f.id.get_create_plist().get_version()}
        for name in f:
            d = f[name]
            out[name] = dict(
                dtype=str(d.dtype), string=h5py.check_string_dtype(d.dtype),
                shape=d.shape, chunks=d.chunks, compression=d.compression,
                opts=d.compression_opts, shuffle=d.shuffle,
                fletcher32=d.fletcher32, scale=d.is_scale,
                dims=[d.dims[i].keys() for i in range(d.ndim)],
                attrs=_h5attrs(f, d), data=_plain(d[...]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_h5py_sees_the_ports_file_as_the_references(case, shard, tmp_path):
    ref, port = _write_both(CASES[case](shard), tmp_path)
    want = _h5view(ref)
    assert want["superblock"][0] == 0
    assert _h5view(port) == want


def test_production_shard_structure(shard, tmp_path):
    """The small shard's cc (under the threaded writer's 4 MiB) is
    chunked as h5py guesses, with zlib level 1 and shuffle, and its dims
    are the coordinate scales, as h5py reports them for the port's
    file."""
    from h5py._hl.filters import guess_chunk
    _, port = _write_both(shard, tmp_path)
    with h5py.File(port, "r") as f:
        cc = f["cc"]
        assert cc.chunks == guess_chunk(cc.shape, None, 4) == \
            hdf5.guess_chunk(cc.shape, 4)
        assert (cc.compression, cc.compression_opts, cc.shuffle) == \
            ("gzip", 1, True)
        assert [cc.dims[i].keys() for i in range(3)] == [
            ["pair"], ["time"], ["lag"]]
        assert f["lag"].is_scale and not cc.is_scale


@pytest.mark.parametrize("case", ["shard", "threaded"])
def test_header_only_reads_alike(case, shard, tmp_path):
    ref, port = _write_both(CASES[case](shard), tmp_path)
    want = _view(jnc.from_netcdf(ref, header_only=True))
    for reader in (jnc, tnc):
        for path in (ref, port):
            got = reader.from_netcdf(path, header_only=True)
            assert got.encoding["header_only"] is True
            assert _view(got) == want
    with pytest.raises(ValueError, match="header-only"):
        tnc.to_netcdf(tnc.from_netcdf(port, header_only=True),
                      str(tmp_path / "again.nc"))


def test_foreign_file_read_through_dimension_scales(tmp_path):
    """A netCDF-4 file written by h5py alone (no ``_xcorr_*`` attrs):
    dims come from the attached scales' names, unattached dims are
    phony, and a large coordinate scale decodes under header_only."""
    path = str(tmp_path / "foreign.nc")
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "CF-1.8"
        f.attrs["version"] = np.int32(2)
        t = f.create_dataset("t", data=np.arange(70_000, dtype="f8"))
        t.make_scale("t")
        s = f.create_dataset("station", data=np.array([b"A", b"BB"]))
        s.make_scale("station")
        v = f.create_dataset("v", data=rng.normal(size=(2, 70_000)),
                             compression="gzip", shuffle=True)
        v.attrs["units"] = "Pa"
        v.dims[0].attach_scale(s)
        v.dims[1].attach_scale(t)
        w = f.create_dataset("w", data=np.arange(6.0).reshape(2, 3))
        w.dims[0].attach_scale(s)
        f.create_dataset("names", data=np.array(["x", "ü"], dtype=object),
                         dtype=h5py.string_dtype())
    for header_only in (False, True):
        want = _view(jnc.from_netcdf(path, header_only=header_only))
        got = _view(tnc.from_netcdf(path, header_only=header_only))
        assert got == want
    ds = tnc.from_netcdf(path)
    assert ds["v"].dims == ("station", "t")
    assert ds["w"].dims == ("station", "phony_dim_1")


def test_resume_round_trip_through_write(shard, tmp_path):
    """``io.write`` -> ``io.read`` -> modify -> ``io.write`` in the port
    keeps the encoding and the hashes; the reference reads and validates
    every file, and the port reads the reference's rewrite alike."""
    ds = shard.copy()
    ds.attrs = dict(shard.attrs)
    from xcorr_tpu_torch.io.utils import preprocess_operations_to_dict
    preprocess_operations_to_dict(ds.coords["pair"])
    first = xcorr_tpu_torch.write(ds, str(tmp_path / "a.nc"), verb=0)
    back = xcorr_tpu_torch.read(first)
    assert back is not None
    assert back.encoding["cc"] == {"zlib": True, "complevel": 1,
                                   "shuffle": True}
    back["status"].values[0, -1] = -1
    second = xcorr_tpu_torch.write(back, str(tmp_path / "b.nc"), verb=0)
    got = xcorr_tpu_torch.read(second)
    want = xcorr_tpu.read(second)
    assert got is not None and want is not None
    assert got["status"].values[0, -1] == -1
    assert _view(got) == _view(want)
    third = xcorr_tpu.write(want, str(tmp_path / "c.nc"), verb=0)
    assert _view(xcorr_tpu_torch.read(third)) == _view(xcorr_tpu.read(third))
    with h5py.File(second, "r") as f:
        assert (f["cc"].compression_opts, f["cc"].shuffle) == (1, True)


def test_not_hdf5_reads_as_unavailable(tmp_path):
    """A file that is not HDF5 (or is cut short) is an OSError, so
    ``io.read`` reports it unreadable as the reference does."""
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"not a netcdf file at all" * 10)
    empty = tmp_path / "empty.nc"
    empty.write_bytes(b"")
    for path in (bad, empty):
        with pytest.raises(OSError):
            tnc.from_netcdf(str(path))
        assert xcorr_tpu_torch.read(str(path)) is None
        assert xcorr_tpu.read(str(path)) is None
    good = str(tmp_path / "good.nc")
    tnc.to_netcdf(_case_phony(None), good)
    cut = tmp_path / "cut.nc"
    cut.write_bytes(Path(good).read_bytes()[:400])
    with pytest.raises(OSError):
        tnc.from_netcdf(str(cut))


#: files in the newer format, once outside the codec's subset
NEWER = {
    "superblock_v3": ({"libver": "latest"}, {}),
    "superblock_v2": ({"libver": ("v108", "v108")}, {}),
    "object_header_v2": ({"track_order": True}, {}),
    "fletcher32": ({}, {"fletcher32": True}),
    "lzf": ({}, {"compression": "lzf"}),
}


@pytest.mark.parametrize("case", list(NEWER))
def test_structures_outside_the_subset_are_refused(case, tmp_path):
    """Files outside the shards' own subset, which the codec refused
    until it read the newer file format (``io/hdf5_v2.py``), now read to
    the JAX package's Dataset, with and without ``header_only``. The
    name is the one these five cases had when they checked the refusal;
    the structures still refused are held in ``test_torch_hdf5_v2.py``."""
    file_kw, dset_kw = NEWER[case]
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", **file_kw) as f:
        f.create_dataset("x", data=np.arange(100.0), **dset_kw)
        f.attrs["title"] = case
    for header_only in (False, True):
        want = _view(jnc.from_netcdf(path, header_only=header_only))
        assert _view(tnc.from_netcdf(path, header_only=header_only)) == want
    assert want["x"][0] == ("phony_dim_0",)


def test_codec_refuses_what_h5py_refuses(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        hdf5.File(str(tmp_path / "x.h5"), "r+")
    with hdf5.File(str(tmp_path / "y.h5"), "w") as f:
        with pytest.raises(TypeError, match="Scalar"):
            f.create_dataset("s", data=np.float32(1), compression="gzip")
        with pytest.raises(ValueError, match="Chunk shape"):
            f.create_dataset("c", data=np.zeros(4), chunks=(8,))
        with pytest.raises(TypeError, match="conversion"):
            f.attrs["u"] = np.str_("text")
        f.create_dataset("ok", data=np.zeros(4))
    with h5py.File(str(tmp_path / "y.h5"), "r") as f:
        assert list(f) == ["ok"]


def test_port_imports_no_h5py():
    """No module of the port names h5py but the metadata's version
    probe, which records ``not installed`` without it."""
    hits = []
    for p in (ROOT / "xcorr_tpu_torch").rglob("*.py"):
        for i, line in enumerate(p.read_text().splitlines()):
            if "import h5py" in line:
                hits.append(f"{p.relative_to(ROOT)}:{i + 1}")
    assert hits == ["xcorr_tpu_torch/util/metadata.py:38"]


def test_slice_writes_and_reads_shards_without_h5py(tmp_path):
    """init -> process -> write -> read -> validate with ``import h5py``
    failing, in a subprocess; h5py and the reference then read the
    shard."""
    path = str(tmp_path / "shard.nc")
    code = f"""
import sys
sys.modules["h5py"] = None  # make `import h5py` fail
import pandas as pd
import xcorr_tpu_torch as xt
from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
inv = Inventory([
    Channel("IM", "H10N1", "", "EDH", latitude=-7.6, longitude=72.5),
    Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8)])
ds = xt.init(pair={PAIR!r}, starttime=pd.Timestamp("2014-01-01"),
             endtime=pd.Timestamp("2014-01-01T02:00"),
             preprocess={{"EDH": {CHAIN!r}}}, attrs={ATTRS!r},
             sampling_rate={FS}, window_length=3600.0, window_overlap=0.5,
             clip_lag=(-100.0, 100.0), inventory=inv)
xt.process(ds, SyntheticClient(sampling_rate={FS},
                               delays={{"IM.H03S1..EDH": 4.0}}),
           device="cpu", verb=0)
out = xt.write(ds, {path!r}, verb=0)
back = xt.read(out)
assert back is not None and (back["status"].values == 1).all()
assert xt.validate(xt.read(out, header_only=True)) is not None
assert "h5py-not installed" in back.attrs["dependencies_version"]
assert sys.modules["h5py"] is None
print(len(back["cc"].values.reshape(-1)))
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = xcorr_tpu.read(path)
    assert want is not None and (want["status"].values == 1).all()
    with h5py.File(path, "r") as f:
        assert f["cc"].dims[2].keys() == ["lag"]
        assert json.loads(f.attrs["_xcorr_coordinates"])


def _day_traces(pkg):
    """Two segments of one day: the second write adds to the file."""
    rng = np.random.default_rng(3)
    out = []
    for start, n in (("2014-01-02T00:00:00", 3000),
                     ("2014-01-02T06:00:00.020000", 2000)):
        out.append(pkg.stream.Trace(
            rng.normal(size=n).astype(np.float32), pkg.stream.Stats(
                network="IM", station="H10N1", location="", channel="EDH",
                starttime=start, sampling_rate=250.0)))
    return out


@pytest.mark.parametrize("writers", ["jax_jax", "port_port", "jax_port"])
def test_sds_hdf5_day_files_across_packages(tmp_path, writers):
    """HDF5 SDS day files (``SDSArchive``'s default format): the port
    writes them through the codec, a second segment rewriting the file
    with both (one h5py wrote, too), and each package reads the other's
    segments, stats and coverage alike."""
    from xcorr_tpu.stream import sds as jsds
    from xcorr_tpu_torch.stream import sds as tsds
    pkgs = {"jax": (xcorr_tpu, jsds), "port": (xcorr_tpu_torch, tsds)}
    traces = []
    for i, who in enumerate(writers.split("_")):
        pkg, mod = pkgs[who]
        tr = _day_traces(pkg)[i]
        mod.SDSArchive(str(tmp_path)).write(pkg.stream.Stream([tr]))
        traces.append(tr)
    seed_id, day = traces[0].id, "2014-01-02T12:00"
    for rmod in (jsds, tsds):
        back = rmod.SDSArchive(str(tmp_path)).read(seed_id, day)
        assert len(back) == 2
        _same_traces(back, traces)
    assert tsds.SDSArchive(str(tmp_path)).coverage(seed_id, day) == \
        jsds.SDSArchive(str(tmp_path)).coverage(seed_id, day)
    path = tsds.SDSArchive(str(tmp_path)).path("IM", "H10N1", "", "EDH",
                                               day)
    with h5py.File(path, "r") as f:
        assert len(f) == 2
        assert all((f[k].compression, f[k].compression_opts, f[k].shuffle)
                   == ("gzip", 4, True) for k in f)


def _same_traces(back, traces):
    for got, want in zip(sorted(back, key=lambda t: t.stats.starttime.ns),
                         traces):
        np.testing.assert_array_equal(got.data, want.data)
        assert got.data.dtype == want.data.dtype
        assert got.id == want.id
        assert got.stats.starttime.ns == want.stats.starttime.ns
        assert got.stats.sampling_rate == want.stats.sampling_rate
