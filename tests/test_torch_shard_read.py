"""The analysis tier's shard read (``xcorr_tpu_torch/io/hdf5_chunks.py``),
bit for bit against the plain versions and h5py:

(a) the codec's chunked read into one array against
    ``_read_chunked_plain`` on the foreign fixtures, shards of both
    packages, partly written datasets with a fill value, edge chunks and
    every chunk index and filter h5py writes here; it refuses every
    damaged chunk the plain read refuses;
(b) h5py's basic slice reads of a chunked dataset against h5py's own
    slice of the same file, for a few hundred seeded keys (empty
    selections, byte-plane boundaries, the last lag, negative bounds,
    dropped axes, each filter chain, fletcher32, damaged chunks);
(c) the analysis tier on the codec's read forms against their plain
    versions (``plain_codec``): every analysis entry point and CLI gives
    the same bits over shards with a status gap, ``to_netcdf`` writes
    the same bytes, no file stays open, the JAX package reads the same
    shard to the same values, and a shard with a damaged ``cc`` chunk
    reads as None and is skipped by every CLI, as a missing one is.
"""
import contextlib
import importlib
import json
import os
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest

import xcorr_tpu
import xcorr_tpu_torch as T
from xcorr_tpu_torch.io import hdf5, hdf5_chunks
from xcorr_tpu_torch.scripts import (beamform as tbf, plmax as tplm,
                                     psd as tpsd, snr as tsnr,
                                     swresp as tsw, timelapse as ttl)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_torch", "hdf5")


# -- equality, bit for bit ------------------------------------------------------

def same(a, b):
    """Two read results equal: type, dtype, shape and bytes (object
    arrays element by element)."""
    if isinstance(a, hdf5.Empty) or isinstance(b, hdf5.Empty):
        return type(a).__name__ == type(b).__name__ and a.dtype == b.dtype
    if type(a) is not type(b):
        return False
    if not isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object:
            return a.tolist() == b.tolist()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:
        return [same_element(x, y) for x, y in zip(a.reshape(-1),
                                                   b.reshape(-1))] \
            == [True] * a.size
    return np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes()


def same_element(x, y):
    if isinstance(x, np.ndarray):
        return isinstance(y, np.ndarray) and same(x, y)
    return type(x) is type(y) and x == y


def outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the raise is the outcome
        return e


def same_outcome(a, b):
    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b)
    return same(a, b)


# -- (a) the whole read into one array -------------------------------------------

def _chunked(f):
    for name in f.keys():
        try:
            d = f[name]
        except (NotImplementedError, OSError):
            continue
        if getattr(d, "_layout", ("",))[0] == "chunked":
            yield name, d


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(FIXTURES) if n.endswith((".h5", ".nc"))))
def test_whole_read_equals_plain_on_fixtures(name):
    with contextlib.chdir(FIXTURES):
        try:
            f = hdf5.File(name)
        except (NotImplementedError, OSError):
            pytest.skip(f"{name} does not open (its view is a raise)")
        with f:
            for var, d in _chunked(f):
                got = outcome(d.__getitem__, ...)
                want = outcome(d._getitem_plain, ...)
                assert same_outcome(got, want), f"{name}/{var}"


def h5py_matrix(path, libver="earliest"):
    """Chunked datasets of every filter chain and chunk index h5py
    writes here, with edge chunks, a partly written one with a fill
    value, and a fletcher32 one."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 7, 1003)) * 100).astype("<f4")
    with h5py.File(path, "w", libver=libver) as f:
        kw = dict(chunks=(2, 3, 300))
        f.create_dataset("shuffle_deflate", data=x, shuffle=True,
                         compression="gzip", **kw)
        f.create_dataset("deflate", data=x, compression="gzip", **kw)
        f.create_dataset("shuffle", data=x.astype("<i8"), shuffle=True, **kw)
        f.create_dataset("plain", data=x.astype(">f8"), **kw)
        f.create_dataset("fletcher32", data=x.astype("<f8"), shuffle=True,
                         compression="gzip", fletcher32=True, **kw)
        f.create_dataset("lzf", data=x, shuffle=True, compression="lzf",
                         **kw)
        f.create_dataset("int16", data=x.astype("<i2"), shuffle=True,
                         compression="gzip", **kw)
        f.create_dataset("uint8", data=x.astype("u1"), shuffle=True,
                         compression="gzip", **kw)
        f.create_dataset("rows", data=x, shuffle=True, compression="gzip",
                         chunks=(1, 1, 1003))
        f.create_dataset("unlimited", data=x, shuffle=True,
                         compression="gzip", maxshape=(None, 7, 1003),
                         **kw)
        f.create_dataset("unlimited2", data=x, shuffle=True,
                         compression="gzip", maxshape=(None, None, 1003),
                         **kw)
        part = f.create_dataset("partial", shape=(7, 1003), dtype="<f4",
                                chunks=(2, 300), fillvalue=-3.5,
                                shuffle=True, compression="gzip")
        part[0:2, 0:300] = 1.0
        part[6, 900:] = 2.0
        part[3, 301] = 5.0
        f.create_dataset("empty_chunks", shape=(5, 40), dtype="<i4",
                         chunks=(2, 8), fillvalue=9, compression="gzip")
        f.create_dataset("strings", data=np.array(
            [b"ab", b"cde", b""] * 20, dtype=object),
            dtype=h5py.string_dtype(), chunks=(7,), compression="gzip")
        f.create_dataset("contiguous", data=x[0])
        f.create_dataset("compact", data=x[0, 0, :20],
                         dcpl=_compact_dcpl())
    return sorted(k for k in h5py.File(path, "r"))


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


@pytest.fixture(scope="module", params=["earliest", "latest"])
def matrix(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / f"{request.param}.h5")
    return path, h5py_matrix(path, request.param)


def test_whole_read_equals_plain_on_the_matrix(matrix):
    path, names = matrix
    with hdf5.File(path) as f, h5py.File(path, "r") as g:
        for name in names:
            got, want = f[name][...], f[name]._getitem_plain(...)
            assert same(got, want), name
            assert same(got, g[name][...]), name


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A CCF shard from each package's writer (the port's in rows
    compressed on threads, 4.8 MB of cc), each with a status gap."""
    d = tmp_path_factory.mktemp("pkg")
    out = {}
    rng = np.random.default_rng(3)
    cc = rng.standard_normal((1, 3, 400_000)).astype(np.float32)
    for name, pkg in (("port", T), ("jax", xcorr_tpu)):
        ds = pkg.ndlabel.Dataset()
        ds["cc"] = (("pair", "time", "lag"), cc)
        ds["status"] = (("pair", "time"), np.array([[1, -1, 1]], np.int8))
        ds.encoding["cc"] = {"zlib": True, "complevel": 1, "shuffle": True}
        out[name] = str(d / f"{name}.nc")
        pkg.io.to_netcdf(ds, out[name])
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_whole_read_equals_plain_on_shards(shards, writer):
    with hdf5.File(shards[writer]) as f:
        for name in f.keys():
            assert same(f[name][...], f[name]._getitem_plain(...)), name


def test_threads_and_serial_give_the_same_bits(shards, monkeypatch):
    with hdf5.File(shards["port"]) as f:
        d = f["cc"]
        pooled = d[...]
        monkeypatch.setattr(hdf5_chunks, "THREADS", 1)
        assert same(d[...], pooled)
        assert same(d[0, 1:, 1000:5000], pooled[0, 1:, 1000:5000])


def test_the_plain_forms_are_named():
    assert hdf5.FORMS == ("read_chunked", "getitem")
    for name in hdf5.FORMS:
        assert callable(getattr(hdf5._ReadDataset, f"_{name}_plain"))


# -- (b) slices --------------------------------------------------------------------

def seeded_keys(shape, rng, n):
    """``n`` basic keys on ``shape``: ints (negative too), slices with
    ``None``, negative and out-of-range bounds (empty ones too), and an
    ``Ellipsis`` now and then."""
    keys = []
    for _ in range(n):
        key = []
        for s in shape:
            r = rng.random()
            if r < 0.2:
                key.append(int(rng.integers(-s, s)))
            elif r < 0.3:
                key.append(slice(None))
            else:
                a = int(rng.integers(-s - 2, s + 2))
                b = int(rng.integers(-s - 2, s + 2))
                key.append(slice(rng.choice([a, None]), rng.choice([b, None])))
        cut = int(rng.integers(0, len(shape) + 1))
        if rng.random() < 0.25:
            key = key[:cut] + [Ellipsis] + key[cut + 1:]
        else:
            key = key[:max(cut, 1)]
        keys.append(tuple(key) if len(key) != 1 or rng.random() < 0.5
                    else key[0])
    return keys


def edge_keys(shape, chunk):
    """Selections that end on a chunk's last element (the last byte of
    its last plane), at the dataset's last element, and empty ones."""
    last = tuple(s - 1 for s in shape)
    keys = [(Ellipsis, -1), tuple(slice(-1, None) for _ in shape),
            (..., slice(0, 0)), last, (slice(5, 5),), (..., slice(7, 3))]
    if chunk:
        keys.append(tuple(slice(0, c) for c in chunk))
        keys.append(tuple(slice(c - 1, c) for c in chunk))
        keys.append(tuple(slice(c // 2, min(2 * c, s))
                          for c, s in zip(chunk, shape)))
    return [k[:len(shape)] if isinstance(k, tuple) and Ellipsis not in k
            else k for k in keys]


def test_slices_equal_h5py(matrix):
    path, names = matrix
    rng = np.random.default_rng(11)
    tested = 0
    with hdf5.File(path) as f, h5py.File(path, "r") as g:
        for name in names:
            d, h = f[name], g[name]
            keys = seeded_keys(h.shape, rng, 25) + edge_keys(h.shape,
                                                             h.chunks)
            for key in keys:
                want = outcome(h.__getitem__, key)
                if isinstance(want, Exception):
                    continue
                got = d[key]
                assert same(got, want), f"{name}[{key!r}]"
                # numpy gives a 0-d array where h5py gives a scalar (all
                # ints and an Ellipsis): its element
                plain = d._getitem_plain(key)
                if isinstance(plain, np.ndarray) and not plain.ndim:
                    plain = plain[()]
                assert same(got, plain), f"{name}[{key!r}]"
                tested += 1
    assert tested >= 300


def test_slice_reads_only_the_chunks_it_meets(matrix):
    path, _ = matrix
    with hdf5.File(path) as f:
        d = f["rows"]
        hdf5_chunks.reset_counts()
        got = d[1, 2:4, 100:200]
        c = hdf5_chunks.counts()
        assert c["chunks"] == 2 and c["written"] == got.nbytes
        # a shuffled float32 row inflated up to the last plane's byte
        # of the last element it needs: 3 planes and 200 bytes
        assert c["inflated"] == 2 * (3 * 1003 + 200)


@pytest.mark.parametrize("key", [
    slice(None, None, 2), [0, 1], np.array([0, 2]), None, (0, None),
    np.s_[..., ...], 1.5, True],
    ids=["step", "list", "array", "none", "newaxis", "two_ellipses",
         "float", "bool"])
def test_keys_outside_basic_selection_raise_naming_them(matrix, key):
    path, _ = matrix
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="not "):
            f["shuffle_deflate"][key]


def damaged(tmp_path, how):
    """A shuffled deflated float32 file whose chunk (0, 1) is damaged:
    ``cut`` stores only the first 90% of its stream (past the start of
    its last byte plane), ``file`` cuts the file inside it, ``checksum``
    flips a byte under fletcher32."""
    path = str(tmp_path / f"{how}.h5")
    x = np.random.default_rng(5).standard_normal((2, 4000)).astype("<f4")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=x, chunks=(1, 2000), shuffle=True,
                             compression="gzip",
                             fletcher32=how == "checksum")
        if how == "cut":
            filt, raw = d.id.read_direct_chunk((0, 2000))
            d.id.write_direct_chunk((0, 2000), raw[:len(raw) * 9 // 10],
                                    filt)
        off = d.id.get_chunk_info_by_coord((0, 2000)).byte_offset
        size = d.id.get_chunk_info_by_coord((0, 2000)).size
    if how == "file":
        with open(path, "r+b") as fh:
            fh.truncate(off + size // 2)
    elif how == "checksum":
        with open(path, "r+b") as fh:
            fh.seek(off + size // 2)
            b = fh.read(1)
            fh.seek(off + size // 2)
            fh.write(bytes([b[0] ^ 0xFF]))
    return path, x


@pytest.mark.parametrize("how", ["cut", "file", "checksum"])
def test_a_damaged_chunk_raises(tmp_path, how):
    """Every key that needs bytes of the damaged chunk past the damage
    raises ``OSError``, as h5py's read and the plain whole read do."""
    path, x = damaged(tmp_path, how)
    keys = [..., (0, slice(2000, 4000)), (0, -1), (slice(None), 3999),
            (0, slice(3990, None))]
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(hdf5.File(path)) if how != "file" else None
        if f is None:   # a file cut short may not open at all
            f = outcome(hdf5.File, path)
            if isinstance(f, OSError):
                return
            stack.enter_context(f)
        d = f["x"]
        for key in keys:
            with pytest.raises(OSError):
                d[key]
            with pytest.raises(OSError):
                d._getitem_plain(key)
        if how != "file":   # chunk (1, 0) is intact
            assert same(d[1, 10:20], x[1, 10:20])
    if how == "file":   # h5py opens no file cut short
        with pytest.raises(OSError):
            h5py.File(path, "r")
        return
    with h5py.File(path, "r") as g:
        for key in keys[1:]:
            with pytest.raises(OSError):
                g["x"][key]


def test_a_cut_stream_reads_only_what_it_needs(tmp_path):
    """A partial inflate reads no byte past what the selection needs: a
    stream cut after them gives the intact elements (h5py, which inflates
    whole chunks, raises there)."""
    path, x = damaged(tmp_path, "cut")
    with hdf5.File(path) as f:
        # the first elements' last-plane bytes lie in the intact half
        assert same(f["x"][0, 2000:2010], x[0, 2000:2010])


def test_fill_value_where_no_chunk_is_written(matrix):
    path, _ = matrix
    with hdf5.File(path) as f, h5py.File(path, "r") as g:
        for key in [(slice(2, 6), slice(250, 700)), (4,), (..., 1002),
                    (slice(None), slice(300, 600))]:
            assert same(f["partial"][key], g["partial"][key]), key
        assert same(f["empty_chunks"][1:4, 3:30],
                    np.full((3, 27), 9, "<i4"))


def test_the_whole_read_refuses_a_chunk_damaged_past_the_edge(tmp_path):
    """An edge chunk whose stream is damaged only past the dataset's
    edge: the whole read inflates it to its end and raises, as the plain
    read and h5py do; a slice inside the edge reads."""
    path = str(tmp_path / "edge.h5")
    x = np.random.default_rng(6).standard_normal((2, 3000)).astype("<f4")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=x, chunks=(1, 2000), shuffle=True,
                             compression="gzip")
        info = d.id.get_chunk_info_by_coord((1, 2000))
    with open(path, "r+b") as fh:   # the stream's check value
        fh.seek(info.byte_offset + info.size - 1)
        b = fh.read(1)
        fh.seek(info.byte_offset + info.size - 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    with hdf5.File(path) as f:
        d = f["x"]
        for read in (d.__getitem__, d._getitem_plain):
            with pytest.raises(OSError):
                read(...)
        assert same(d[1, 2000:2100], x[1, 2000:2100])
        assert same(d[0], x[0])
    with h5py.File(path, "r") as g, pytest.raises(OSError):
        g["x"][...]


def test_a_read_on_a_pool_thread_decodes_there(shards, monkeypatch):
    """A read made by a task of the read pool decodes its chunks on that
    thread: no task of the pool waits on the pool."""
    import threading
    monkeypatch.setattr(hdf5_chunks, "PARALLEL_MIN", 0)
    names = []
    decode = hdf5_chunks.Chunks._decode

    def traced(self, *a):
        names.append(threading.current_thread().name)
        return decode(self, *a)

    monkeypatch.setattr(hdf5_chunks.Chunks, "_decode", traced)
    with hdf5.File(shards["port"]) as f:
        d = f["cc"]
        want = d._getitem_plain(...)

        def task():
            return threading.current_thread().name, d[...]

        name, got = hdf5_chunks._read_pool().submit(task).result(timeout=60)
    assert name.startswith("xcorr-h5read") and same(got, want)
    assert len(names) == 3 and set(names) == {name}


# -- (c) the analysis tier on both read forms ----------------------------------------

FS = 5.0
CHAIN = [("detrend", {"type": "demean"}),
         ("filter", {"type": "bandpass", "freqmin": 0.3, "freqmax": 2.0}),
         ("taper", {"type": "cosine", "max_percentage": 0.05,
                    "max_length": 30.0})]
PAIRS = ["IM.H03S1..EDH-IU.RAR.10.BHZ", "IM.H03S2..EDH-IU.RAR.10.BHZ",
         "IM.H03S3..EDH-IU.RAR.10.BHZ"]
ATTRS = {"institution": "t", "author": "t", "source": "t"}
CLIM = (1400.0, 90_000_000.0)
HIGHPASS = {"frequency": 0.5, "btype": "highpass", "order": 2}
DAYS = pd.date_range("2014-01-01", periods=2, freq="1D")
#: each pair's cc layout on disk: the writer's guess, one row per chunk
#: (the production layout), chunks cut by the edges
LAYOUTS = [None, "rows", (1, 5, 700)]
#: windows whose status is -1, so the kept times are not contiguous
GAP = (4, 5, 17)


@contextlib.contextmanager
def plain_codec():
    """The codec's read forms swapped for their plain versions
    (``hdf5.FORMS``) while it runs."""
    cls = hdf5._ReadDataset
    names = {n: "__getitem__" if n == "getitem" else f"_{n}"
             for n in hdf5.FORMS}
    real = {attr: cls.__dict__[attr] for attr in names.values()}
    for n, attr in names.items():
        setattr(cls, attr, getattr(cls, f"_{n}_plain"))
    try:
        yield
    finally:
        for attr, form in real.items():
            setattr(cls, attr, form)


def form(name):
    return plain_codec() if name == "plain" else contextlib.nullcontext()


def _inventory(pkg=T):
    ch = pkg.stream.Channel
    return pkg.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.60, longitude=-78.80),
        ch("IM", "H03S2", "", "EDH", latitude=-33.62, longitude=-78.82),
        ch("IM", "H03S3", "", "EDH", latitude=-33.61, longitude=-78.78),
        ch("IU", "RAR", "10", "BHZ", latitude=-21.2, longitude=-159.8)])


def make_shard(pair, day, seed, layout):
    """One pair-day at 5 Hz, 1 h windows every 30 min, lags of +-200 s
    (97,000 values of cc), a wave packet in noise, status -1 at
    ``GAP``."""
    ds = T.init(pair=pair, starttime=day, endtime=day + pd.Timedelta("1D"),
                preprocess={"EDH": CHAIN, "BHZ": CHAIN}, attrs=ATTRS,
                sampling_rate=FS, window_length=3600.0, window_overlap=0.5,
                clip_lag=(-200.0, 200.0), inventory=_inventory())
    rng = np.random.default_rng(seed)
    nt, nlag = ds.dims["time"], ds.dims["lag"]
    lag = ds.coords["lag"].values
    packet = np.exp(-((lag - 60.0 - seed) / 5.0) ** 2) * np.cos(
        2 * np.pi * 0.7 * lag)
    ds["cc"].values[...] = (0.01 * rng.standard_normal((1, nt, nlag))
                            + 0.3 * packet).astype(np.float32)
    status = np.ones((1, nt), dtype=np.int8)
    status[0, list(GAP)] = -1
    ds["status"].values[...] = status
    ds["pair_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    ds["time_offset"].values[...] = rng.uniform(-0.5, 0.5, (1, nt))
    if layout is not None:
        ds.encoding.setdefault("cc", {})["chunksizes"] = \
            (1, 1, nlag) if layout == "rows" else layout
    return ds


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cc"))
    for i, (pair, layout) in enumerate(zip(PAIRS, LAYOUTS)):
        for j, day in enumerate(DAYS):
            path = T.ncfile(pair, day, root)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            T.io.write(make_shard(pair, day, 10 * i + j, layout), path,
                       verb=0)
    return root


def shard(archive, pair, day=DAYS[0], plain=False):
    with form("plain" if plain else "port"):
        return T.read(T.ncfile(pair, day, archive), fast=True)


def both(archive, pair, day=DAYS[0]):
    return shard(archive, pair, day), shard(archive, pair, day, plain=True)


def assert_same_dataset(a, b, skip=("postprocess",), source=True):
    """Datasets equal bit for bit: variables, coordinates, attributes
    (``skip`` aside: the postprocess time stamp) and encoding (the file
    read aside where ``source`` is false)."""
    assert list(a._coords) == list(b._coords)
    assert list(a._vars) == list(b._vars)

    def encoding(ds):
        return json.dumps({k: v for k, v in ds.encoding.items()
                           if source or k != "source"},
                          sort_keys=True, default=str)

    assert encoding(a) == encoding(b)
    for k in list(a._coords) + list(a._vars):
        x, y = a.variables[k], b.variables[k]
        assert x.dims == y.dims, k
        assert same(np.asarray(x.values), np.asarray(y.values)), k
        ax = {n: v for n, v in x.attrs.items() if n not in skip}
        ay = {n: v for n, v in y.attrs.items() if n not in skip}
        assert repr(ax) == repr(ay), k


@pytest.mark.parametrize("pair", PAIRS)
def test_read_gives_the_plain_forms_dataset(archive, pair):
    hdf5_chunks.reset_counts()
    ds = shard(archive, pair)
    assert hdf5_chunks.counts()["chunks"] > 0
    hdf5_chunks.reset_counts()
    eager = shard(archive, pair, plain=True)
    assert hdf5_chunks.counts()["chunks"] == 0
    assert isinstance(ds["cc"].values, np.ndarray)
    assert_same_dataset(ds, eager)


@pytest.mark.parametrize("pair", PAIRS)
def test_pair_snr_bit_identical(archive, pair):
    got, want = (tsnr.pair_snr(ds, celerity=CLIM, noise_lag=(150.0, 200.0),
                               filter_kwargs=HIGHPASS, device="cpu")
                 for ds in both(archive, pair))
    assert_same_dataset(got, want)


def test_estimate_snr_for_day_bit_identical(archive):
    kw = dict(celerity=CLIM, noise_lag=(150.0, 200.0),
              filter_kwargs=HIGHPASS, device="cpu")
    got = tsnr.estimate_snr_for_day(PAIRS, DAYS[0], archive, **kw)
    with plain_codec():
        want = tsnr.estimate_snr_for_day(PAIRS, DAYS[0], archive, **kw)
    assert_same_dataset(got, want)


def test_pair_psd_bit_identical(archive):
    got, want = (tpsd.pair_psd(ds, PAIRS[1], DAYS[0],
                               DAYS[0] + pd.Timedelta("12h"), clim=CLIM,
                               filter_kwargs=HIGHPASS, duration=10.0,
                               padding_factor=2, fmax=2.0, device="cpu")
                 for ds in both(archive, PAIRS[1]))
    assert_same_dataset(got, want)


def test_beamform_datasets_bit_identical(archive):
    kw = dict(clim=CLIM, attrs=ATTRS, filter_kwargs=HIGHPASS, device="cpu")
    got = tbf.beamform_datasets([shard(archive, p) for p in PAIRS],
                                _inventory(), **kw)
    want = tbf.beamform_datasets(
        [shard(archive, p, plain=True) for p in PAIRS], _inventory(), **kw)
    assert_same_dataset(got, want)


def test_pair_plmax_bit_identical(archive):
    got, want = (tplm.pair_plmax(ds, clim=CLIM, min_distance=5,
                                 filter_kwargs=HIGHPASS, device="cpu")
                 for ds in both(archive, PAIRS[2]))
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_swresp_datasets_bit_identical(archive):
    kw = dict(clim=CLIM, attrs=ATTRS, filter_kwargs=HIGHPASS, device="cpu")
    got = tsw.swresp_datasets(shard(archive, PAIRS[0]),
                              shard(archive, PAIRS[1]), **kw)
    want = tsw.swresp_datasets(shard(archive, PAIRS[0], plain=True),
                               shard(archive, PAIRS[1], plain=True), **kw)
    assert_same_dataset(got, want)


def test_pair_spectrograms_bit_identical(archive):
    kw = dict(clim=CLIM, duration=10.0, filter_kwargs=HIGHPASS,
              device="cpu")
    got = ttl.pair_spectrograms([shard(archive, PAIRS[0], d) for d in DAYS],
                                DAYS, **kw)
    want = ttl.pair_spectrograms(
        [shard(archive, PAIRS[0], d, plain=True) for d in DAYS], DAYS, **kw)
    assert same(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        assert same(g, w)


CLI_COMMON = ["--filter-freq", "0.5", "--celerity", "1400", "90000000",
              "--platform", "cpu"]
CLI_ATTRS = ["--institution", "t", "--author", "t", "--source", "t"]


def cli_argv(script, archive, tmp, out):
    days = ["2014-01-01", "2014-01-02"]
    if script == "snr":
        return [*days, "--root", archive, *sum((["--pair", p] for p in
                                                PAIRS), []),
                *CLI_COMMON, "--out", out, *CLI_ATTRS]
    if script == "beamform":
        inv = os.path.join(tmp, "inv.json")
        _inventory().to_json(inv)
        return [*days, "--root", archive, *sum((["--pair", p] for p in
                                                PAIRS), []),
                "--inventory", inv, *CLI_COMMON, "--out", out, *CLI_ATTRS]
    if script == "plmax":
        return [*days, "--root", archive, "--pair", PAIRS[0], *CLI_COMMON,
                "--min-distance", "5", "--out", out]
    if script == "swresp":
        return [*days, "--root", archive, "--pair-z", PAIRS[0], "--pair-r",
                PAIRS[1], *CLI_COMMON, "--out", out, *CLI_ATTRS]
    return ["all", "--start", days[0], "--end", days[1], "--root", archive,
            "--pair", PAIRS[0], "--freq", "0.4", "1.0", "--duration",
            "10.0", *CLI_COMMON, "--out", out, *CLI_ATTRS]


CLIS = {"snr": tsnr, "beamform": tbf, "plmax": tplm, "swresp": tsw,
        "timelapse": ttl}


def run_cli(script, archive, tmp, out, name):
    """The CLI's return code on the read form ``name``, or the type of
    what it raised."""
    with form(name):
        try:
            return CLIS[script].main(cli_argv(script, archive, tmp, out))
        except Exception as e:  # noqa: BLE001 - the raise is the outcome
            return type(e).__name__


def assert_same_product(script, a, b):
    """Two products of ``script`` equal (the history's and postprocess's
    time stamps and the file read aside)."""
    if script == "plmax":
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
        return
    assert_same_dataset(T.io.from_netcdf(a), T.io.from_netcdf(b),
                        skip=("history", "postprocess"), source=False)


@pytest.mark.parametrize("script", sorted(CLIS))
def test_cli_files_bit_identical(script, archive, tmp_path):
    """Each analysis CLI writes the same product on the codec's read
    forms and on their plain versions."""
    ext = ".csv" if script == "plmax" else ".nc"
    outs = {}
    for name in ("port", "plain"):
        outs[name] = str(tmp_path / f"{name}{ext}")
        assert run_cli(script, archive, str(tmp_path), outs[name],
                       name) == 0
    assert_same_product(script, outs["port"], outs["plain"])


def test_psd_cli_file_bit_identical(archive, tmp_path):
    """psd reads its shards through ``mfread``, and its ct file through
    ``read``: the same files on both read forms."""
    snr = str(tmp_path / "snr.nc")
    ct = str(tmp_path / "ct.nc")
    assert tsnr.main(cli_argv("snr", archive, str(tmp_path), snr)) == 0
    from xcorr_tpu_torch.scripts import ct as tct
    assert tct.main([snr, "--threshold", "0.0001", "--out", ct, "--csv",
                     str(tmp_path / "ct.csv"), "--platform", "cpu"]) == 0
    outs = {}
    for name in ("port", "plain"):
        outs[name] = str(tmp_path / name)
        with form(name):
            assert tpsd.main([ct, "--root", archive, "--outdir", outs[name],
                              *CLI_COMMON, "--duration", "10.0",
                              "--padding-factor", "2", "--fmax",
                              "2.0"]) == 0
    names = sorted(os.path.relpath(os.path.join(d, n), outs["port"])
                   for d, _, ns in os.walk(outs["port"]) for n in ns)
    assert names and names == sorted(
        os.path.relpath(os.path.join(d, n), outs["plain"])
        for d, _, ns in os.walk(outs["plain"]) for n in ns)
    for name in names:
        got, want = (T.io.from_netcdf(os.path.join(outs[f], name))
                     for f in ("port", "plain"))
        assert_same_dataset(got, want, skip=("history", "postprocess"),
                            source=False)


def test_extract_reads_the_same(archive):
    path = T.ncfile(PAIRS[2], DAYS[0], archive)
    got = T.read(path, fast=True, extract=True)
    with plain_codec():
        want = T.read(path, fast=True, extract=True)
    assert_same_dataset(got, want)


def test_to_netcdf_writes_the_same_bytes(archive, tmp_path):
    ds, eager = both(archive, PAIRS[1])
    a, b = str(tmp_path / "port.nc"), str(tmp_path / "plain.nc")
    T.io.to_netcdf(ds, a)
    T.io.to_netcdf(eager, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def open_fds():
    return len(os.listdir("/proc/self/fd"))


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"),
                    reason="no /proc/self/fd to count")
def test_no_file_stays_open(archive):
    before = open_fds()
    dss = [shard(archive, p, d) for p in PAIRS for d in DAYS]
    assert open_fds() == before
    assert all(ds is not None for ds in dss)


def test_jax_read_equals_the_port_read(archive):
    path = T.ncfile(PAIRS[0], DAYS[1], archive)
    want = xcorr_tpu.io.read(path, fast=True)
    got = T.read(path, fast=True)
    assert list(got._vars) == list(want._vars)
    assert list(got._coords) == list(want._coords)
    for k in list(want._coords) + list(want._vars):
        x, y = got.variables[k], want.variables[k]
        assert x.dims == y.dims, k
        assert same(np.asarray(x.values), np.asarray(y.values)), k
        assert repr(x.attrs) == repr(y.attrs), k


def damage_cc(path, how):
    """``cc``'s last chunk in the shard at ``path`` damaged only near the
    end of its stream, past every byte a kept block of early lags needs:
    ``check`` flips the last byte of the stream's check value, ``tail``
    zeroes its last tenth."""
    with h5py.File(path, "r") as f:
        d = f["cc"]
        info = max((d.id.get_chunk_info(i)
                    for i in range(d.id.get_num_chunks())),
                   key=lambda c: c.chunk_offset)
    with open(path, "r+b") as fh:
        if how == "check":
            fh.seek(info.byte_offset + info.size - 1)
            b = fh.read(1)
            fh.seek(info.byte_offset + info.size - 1)
            fh.write(bytes([b[0] ^ 0xFF]))
        else:
            n = max(16, info.size // 10)
            fh.seek(info.byte_offset + info.size - n)
            fh.write(bytes(n))


@pytest.fixture(scope="module", params=["check", "tail"])
def damaged_archive(request, archive, tmp_path_factory):
    """Copies of the archive: one where PAIRS[0]'s second day has a
    damaged ``cc`` chunk, one where that shard is missing."""
    root = tmp_path_factory.mktemp(f"damaged-{request.param}")
    bad, gone = str(root / "bad"), str(root / "gone")
    shutil.copytree(archive, bad)
    shutil.copytree(archive, gone)
    damage_cc(T.ncfile(PAIRS[0], DAYS[1], bad), request.param)
    os.remove(T.ncfile(PAIRS[0], DAYS[1], gone))
    return bad, gone


def test_a_damaged_cc_chunk_fails_the_read(damaged_archive):
    """``read`` gives None for the shard, on both read forms, as the JAX
    package's read does: the whole read inflates every chunk to its
    end."""
    bad, _ = damaged_archive
    path = T.ncfile(PAIRS[0], DAYS[1], bad)
    assert xcorr_tpu.io.read(path, fast=True) is None
    for name in ("port", "plain"):
        with form(name):
            assert T.read(path, fast=True) is None, name
            with hdf5.File(path) as f, pytest.raises(OSError):
                f["cc"][...]


@pytest.mark.parametrize("script", sorted(CLIS))
def test_a_damaged_shard_is_skipped_by_every_cli(script, damaged_archive,
                                                 tmp_path):
    """Each analysis CLI skips the pair-day whose ``cc`` does not decode,
    as it skips a missing shard, on both read forms: the same outcome
    and the same product."""
    bad, gone = damaged_archive
    ext = ".csv" if script == "plmax" else ".nc"
    runs = {}
    for root, name in ((gone, "port"), (bad, "port"), (bad, "plain")):
        out = str(tmp_path / f"{os.path.basename(root)}-{name}{ext}")
        runs[out] = run_cli(script, root, str(tmp_path), out, name)
    outs = list(runs)
    assert len(set(runs.values())) == 1, runs
    if runs[outs[0]] == 0:
        for out in outs[1:]:
            assert_same_product(script, outs[0], out)
