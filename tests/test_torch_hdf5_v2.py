"""The port's HDF5 reader on files in the newer file format, on the CPU.

``xcorr_tpu_torch/io/hdf5_v2.py`` reads what HDF5 1.8 and later write
(superblocks 2 and 3, version-2 object headers, new-style groups, dense
attributes, the version-4 chunk indexes, fletcher32 and lzf); h5py
writes each file here, and the JAX package (on h5py) is the reference:

- every file of the matrix reads to the same view through both
  packages' ``from_netcdf``, with and without ``header_only``: data,
  dims, coords, attributes, encoding, and the order of variables and
  attributes;
- a real xcorr shard, written by the JAX package's ``to_netcdf`` under
  each foreign file setting, reads, and validates with its hashes;
- a corrupt file raises ``OSError`` in both packages;
- each structure the codec still refuses raises a
  ``NotImplementedError`` naming it;
- the committed fixtures (``tests/fixtures_torch/hdf5``, made by
  ``tools/make_hdf5_fixtures.py``) hold to ``expected.json`` and to a
  fresh run of their generator.
"""
import json
import shutil
import struct
import zlib

import h5py
import numpy as np
import pytest

import xcorr_tpu
import xcorr_tpu_torch
from tools import make_hdf5_fixtures as mf
from tools.hdf5_view import digest, view
from xcorr_tpu.io import netcdf as jnc
from xcorr_tpu_torch.io import hdf5, hdf5_filters, hdf5_v2
from xcorr_tpu_torch.io import netcdf as tnc


def _same(path):
    """Both packages read ``path`` to one view, with and without
    ``header_only``."""
    for header_only in (False, True):
        want = view(jnc.from_netcdf(path, header_only=header_only))
        got = view(tnc.from_netcdf(path, header_only=header_only))
        assert got == want, header_only
    return want


def _one(path, file_kw, dset_kw, data=np.arange(100.0)):
    with h5py.File(path, "w", **file_kw) as f:
        f.create_dataset("x", data=data, **dset_kw)


def _many_links(path):
    """~1000 links: the group's fractal heap needs an indirect block;
    most are hard links to a few datasets, one is a soft link."""
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(4):
            f.create_dataset(f"d{i}", data=np.arange(i + 3, dtype="i4"))
        for i in range(996):
            f[f"link_{(i * 7919) % 996:04d}"] = f[f"d{i % 4}"]
        f["soft"] = h5py.SoftLink("/d1")


def _big_attribute(path):
    """A 100 KB attribute: dense storage, a huge heap object."""
    rng = np.random.default_rng(4)
    with h5py.File(path, "w", libver="latest", track_order=True) as f:
        f.attrs["big"] = rng.normal(size=12_800)
        f.attrs["after"] = "small"
        d = f.create_dataset("x", data=np.arange(4.0))
        d.attrs["big_text"] = "ü" * 60_000
        d.attrs["n"] = 3


def _userblock(path, libver="latest"):
    """Addresses count from the superblock, 512 bytes into the file."""
    with h5py.File(path, "w", libver=libver, userblock_size=512) as f:
        f.create_dataset("x", data=np.arange(10.0), compression="gzip")
        f.attrs["title"] = "after a user block"


def _extension(path):
    """Paged file space: a superblock extension with a file space info
    message."""
    with h5py.File(path, "w", libver="latest", fs_strategy="page",
                   fs_page_size=4096) as f:
        f.create_dataset("x", data=np.arange(50.0), chunks=(7,),
                         compression="gzip")


def _compact(path):
    with h5py.File(path, "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"c", h5py.h5t.STD_I32LE,
                        h5py.h5s.create_simple((6,)), dcpl=dcpl)
        f["c"][...] = np.arange(6, dtype="i4")
        f.create_dataset("contiguous", data=np.arange(5.0))
        f.create_dataset("unwritten", shape=(3,), dtype="f8", fillvalue=2.5)
        f.create_dataset("scalar", data=np.float32(7.0))


def _types(path):
    """Datatype version 3 (compound offsets in the fewest bytes, enum
    names unpadded), attribute message version 3, strings."""
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("z", data=np.arange(4) * (1 + 2j))
        f.create_dataset("flag", data=np.array([True, False, True]))
        f.create_dataset("fixed", data=np.array([b"ab", b"cde"]))
        f.create_dataset("names", data=np.array(["x", "ü"], dtype=object),
                         dtype=h5py.string_dtype())
        f.attrs["complex"] = np.complex64(1 - 2j)
        f.attrs["yes"] = True
        f.attrs["list"] = ["a", "bc"]


def _partial_edge_unfiltered(path):
    """The layout flag "don't filter partial edge chunks" (h5py cannot
    set it): edge chunks stored as they are, interior ones shuffled and
    deflated; the flag then set in the layout message, the header's
    checksum made anew."""
    rng = np.random.default_rng(9)
    data = rng.normal(size=(10, 7)).astype("f4")
    chunks = (4, 3)
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=data.shape, dtype="f4",
                             chunks=chunks, compression="gzip", shuffle=True)
        for i in range(0, 10, 4):
            for j in range(0, 7, 3):
                block = np.zeros(chunks, "f4")
                part = data[i:i + 4, j:j + 3]
                block[:part.shape[0], :part.shape[1]] = part
                raw = block.tobytes()
                if part.shape == chunks:
                    raw = zlib.compress(hdf5._shuffle(raw, 4), 4)
                d.id.write_direct_chunk((i, j), raw)
    buf = bytearray(open(path, "rb").read())
    with hdf5.File(path) as r:
        addr = r._entries["x"]
        q = next(q for t, q, _ in r._messages(addr) if t == 0x08)
        a = r._addr(addr)
    assert buf[q] == 4 and buf[q + 1] == 2
    buf[q + 2] |= 0x01
    _rechecksum(buf, a)
    open(path, "wb").write(bytes(buf))
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["x"][...], data)


def _rechecksum(buf, a):
    """Store the checksum of the version-2 object header at ``a``."""
    flags = buf[a + 5]
    p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    w = 1 << (flags & 0x03)
    end = p + w + int.from_bytes(buf[p:p + w], "little")
    struct.pack_into("<I", buf, end, hdf5_v2.lookup3(bytes(buf[a:end])))


MATRIX = {
    # netCDF-C's layout, big groups and attributes, file-level structures
    "netcdf_c": mf.write_netcdf_c,
    "many_links": _many_links,
    "big_attribute": _big_attribute,
    "userblock": _userblock,
    "userblock_earliest": lambda p: _userblock(p, "earliest"),
    "superblock_extension": _extension,
    "compact_contiguous": _compact,
    "types_v3": _types,
    # every version-4 chunk index, with unwritten and partial edge chunks
    **{f"index_{kind}": (lambda p, k=kind: mf.write_index(p, k))
       for kind in mf.INDEXES},
    **{f"index_{kind}_gzip": (lambda p, k=kind: mf.write_index(p, k, True))
       for kind in ("single", "fixed", "extensible", "btree2")},
    "index_fixed_track_order": lambda p: mf.write_index(
        p, "fixed", True, "netcdf_c"),
    "partial_edge_unfiltered": _partial_edge_unfiltered,
    # the filters, in the oldest and the newest format
    "fletcher32_gzip": lambda p: mf.write_filter(p, "fletcher32"),
    "fletcher32_latest": lambda p: mf.write_filter(p, "fletcher32",
                                                   "latest"),
    "lzf_shuffle": lambda p: mf.write_filter(p, "lzf"),
    "lzf_latest": lambda p: mf.write_filter(p, "lzf", "latest"),
}


@pytest.mark.parametrize("case", list(MATRIX))
def test_newer_format_reads_as_the_jax_package_reads_it(case, tmp_path):
    path = str(tmp_path / f"{case}.h5")
    MATRIX[case](path)
    want = _same(path)
    assert want["vars"] or want["coords"], case


def test_rewrite_of_a_newer_format_file(tmp_path):
    """Mode ``"a"`` (SDS day files) takes over a file in the newer format
    (fletcher32 chunks copied as stored) and writes it anew in the
    codec's own format, which h5py reads with the added dataset."""
    path = str(tmp_path / "day.h5")
    mf.write_filter(path, "fletcher32", "latest")
    with h5py.File(path, "r") as f:
        want = {k: f[k][...] for k in f}
    with hdf5.File(path, "a") as f:
        f.create_dataset("added", data=np.arange(3.0))
    with h5py.File(path, "r") as f:
        assert f.id.get_create_plist().get_version()[0] == 0
        assert sorted(f) == ["added", "i", "x"]
        assert f["x"].fletcher32 and f["x"].compression == "gzip"
        for k, v in want.items():
            np.testing.assert_array_equal(f[k][...], v)


@pytest.mark.parametrize("name", ["lzf", "fletcher32"])
def test_rewrite_refuses_to_filter_anew(tmp_path, name):
    """A taken-over dataset whose chunks must be filtered anew through a
    filter the writer lacks is refused by name, and the file stays as it
    was: chunked strings (re-encoded, their heap laid out again) under
    lzf, and a fletcher32 dataset with no chunk written that is then
    assigned."""
    path = tmp_path / "day.h5"
    with h5py.File(path, "w", libver="latest") as f:
        if name == "lzf":
            f.create_dataset("s", data=np.array(["ab", "cde", "f"], object),
                             dtype=h5py.string_dtype(), chunks=(2,),
                             compression="lzf")
        else:
            f.create_dataset("s", shape=(3,), dtype="f4", chunks=(2,),
                             fletcher32=True)
    before = path.read_bytes()
    with pytest.raises(NotImplementedError, match=name):
        with hdf5.File(str(path), "a") as f:
            if name == "fletcher32":
                f["s"][...] = np.arange(3.0)
            f.create_dataset("added", data=np.arange(3.0))
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["day.h5"]


def test_order_of_links_and_attributes(tmp_path):
    """h5py's order: creation order where the group or the object header
    tracks it, by name otherwise; the names map back from addresses
    (``DIMENSION_LIST``)."""
    path = str(tmp_path / "nc.nc")
    mf.write_netcdf_c(path)
    with hdf5.File(path) as f, h5py.File(path, "r") as g:
        assert f.keys() == list(g.keys())
        assert f.keys()[:4] == ["time", "nv", "lag", "cc"]
        for name in [None, *g.keys()]:
            assert list((f if name is None else f[name]).attrs) == list(
                (g if name is None else g[name]).attrs), name
        assert list(f["cc"].attrs)[-10:] == [f"a{9 - i}" for i in range(10)]
        assert list(f["x" if "x" in f.keys() else "v0"].attrs)[0] == \
            "DIMENSION_LIST"
        assert [f["cc"].dims[i].keys() for i in range(2)] == \
            [["time"], ["lag"]]
        assert f["time_bnds"].dims[1].keys() == [f"{mf.NC_DIM}         2"]
        assert len(f._names) == len(f.keys())
    ds = tnc.from_netcdf(path)
    assert ds["time_bnds"].dims == ("time", f"{mf.NC_DIM}         2")


@pytest.fixture(scope="module")
def jax_shard():
    return mf.shard_dataset()


@pytest.mark.parametrize("settings", list(mf.FILE_SETTINGS))
def test_jax_written_shard_in_foreign_layout(settings, jax_shard, tmp_path):
    """``xcorr_tpu.write`` through h5py opened with a foreign writer's
    file settings: the port reads the shard as the JAX package does and
    validates it with its metadata and full-data hashes."""
    path = str(tmp_path / "shard.nc")
    mf.write_shard(path, settings, ds=jax_shard)
    with h5py.File(path, "r") as f:
        sb = f.id.get_create_plist().get_version()[0]
    assert sb == {"netcdf_c": 2, "latest": 3, "track_order": 0}[settings]
    _same(path)
    got, want = xcorr_tpu_torch.read(path), xcorr_tpu.read(path)
    assert got is not None and want is not None
    assert view(got) == view(want)
    assert (got["status"].values == 1).all()


@pytest.mark.parametrize("which", ["superblock", "root", "dataset"])
def test_corrupt_metadata_is_an_oserror(which, tmp_path):
    """A flipped byte fails a checksum and the port raises ``OSError``:
    h5py does as well for the superblock, and raises ``KeyError`` for an
    object header (the root group's or a dataset's); ``read`` reports
    the file unreadable in both packages."""
    path = str(tmp_path / "ohdr.h5")
    _one(path, {"libver": "latest"}, {}, np.arange(10.0))
    with hdf5.File(path) as r:
        a = {"superblock": r._base + 4, "root": r._addr(r._root),
             "dataset": r._addr(r._entries["x"])}[which]
    buf = bytearray(open(path, "rb").read())
    buf[a + 12] ^= 0x40
    open(path, "wb").write(bytes(buf))
    with pytest.raises(OSError, match="checksum"):
        tnc.from_netcdf(path)
    with pytest.raises(OSError if which == "superblock" else KeyError,
                       match="checksum"):
        jnc.from_netcdf(path)
    assert xcorr_tpu_torch.read(path) is None
    assert xcorr_tpu.read(path) is None


def test_corrupt_fletcher32_chunk_is_an_oserror(tmp_path):
    path = str(tmp_path / "f32.h5")
    _one(path, {}, {"fletcher32": True, "chunks": (30,)})
    with hdf5.File(path) as r:
        _, _, _, addr = r["x"]._chunks()[1]
        at = r._addr(addr)
    buf = bytearray(open(path, "rb").read())
    buf[at + 5] ^= 0x01
    open(path, "wb").write(bytes(buf))
    for pkg in (jnc, tnc):
        with pytest.raises(OSError):
            pkg.from_netcdf(path)
    with pytest.raises(OSError, match="fletcher32"):
        tnc.from_netcdf(path)


def _shared(path):
    """A datatype message flagged shared (h5py writes no shared-message
    table): the header's checksum made anew."""
    _one(path, {"libver": "latest"}, {})
    with hdf5.File(path) as r:
        addr = r._entries["x"]
        q = next(q for t, q, _ in r._messages(addr) if t == 0x03)
        a = r._addr(addr)
    buf = bytearray(open(path, "rb").read())
    buf[q - 1] |= 0x02
    _rechecksum(buf, a)
    open(path, "wb").write(bytes(buf))


def _low_type(path, tid):
    with h5py.File(path, "w") as f:
        h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,)))


#: what the codec still refuses, as both packages do (their both-fail
#: tests are in ``test_torch_hdf5_foreign.py``, with the cases that moved
#: there once the codec read them)
REFUSED = {
    "shared_messages": (_shared, "shared object header messages"),
    "time_datatype": ((lambda p: _low_type(p, h5py.h5t.UNIX_D32LE)),
                      "time datatypes"),
    "array_datatype": ((lambda p: _low_type(p, h5py.h5t.array_create(
        h5py.h5t.IEEE_F32LE, (3,)))), "array datatypes"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_structures_still_refused_are_named(case, tmp_path):
    write, match = REFUSED[case]
    path = str(tmp_path / f"{case}.h5")
    write(path)
    with pytest.raises(NotImplementedError, match=match):
        tnc.from_netcdf(path)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_groups_below_the_root_are_refused_by_both(libver, tmp_path):
    """The JAX package cannot read a group as a variable either (a
    ``Group`` has no ``ndim``)."""
    path = str(tmp_path / "group.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_group("g").create_dataset("y", data=np.arange(3))
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(AttributeError, match="ndim"):
        jnc.from_netcdf(path)
    with pytest.raises(NotImplementedError, match="groups below the root"):
        tnc.from_netcdf(path)


def test_lookup3_and_fletcher32():
    """``hashlittle``'s own test vectors (from lookup3.c), and
    fletcher32 against a plain loop of the library's."""
    assert hdf5_v2.lookup3(b"") == 0xDEADBEEF
    assert hdf5_v2.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    four = b"Four score and seven years ago"
    assert hdf5_v2.lookup3(four) == 0x17770551
    assert hdf5_v2.lookup3(four, 1) == 0xCD628161

    def plain(data):
        s1 = s2 = 0
        n, i = len(data) // 2, 0
        while n:
            t = min(n, 360)
            n -= t
            for _ in range(t):
                s1 += (data[i] << 8) | data[i + 1]
                i += 2
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return (s2 << 16) | s1

    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 719, 720, 721, 5001):
        for data in (rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                     b"\xff" * n):
            assert hdf5_filters.fletcher32(data) == plain(data), n


def test_lzf_round_trip_through_h5py(tmp_path):
    """Chunks that lzf cannot shrink are stored with the filter masked
    (h5py registers it optional); repeated runs overlap their source."""
    rng = np.random.default_rng(5)
    data = np.concatenate([np.tile(np.arange(3, dtype="u1"), 5000),
                           rng.integers(0, 256, 20_000).astype("u1")])
    path = str(tmp_path / "lzf.h5")
    _one(path, {}, {"compression": "lzf", "chunks": (10_000,)}, data)
    with hdf5.File(path) as f:
        masks = [m for _, m, _, _ in f["x"]._chunks()]
        np.testing.assert_array_equal(f["x"][...], data)
    assert 0 in masks and 1 in masks
    with pytest.raises(OSError, match="lzf"):
        hdf5_filters.unlzf(b"\xe0\x00\x00", 100)


FIXTURES = mf.OUT


def test_committed_fixtures_hold_to_expected_and_a_fresh_run(tmp_path):
    """``expected.json`` holds each committed file's view as the JAX
    package reads it (``"raises <type>"`` where that read raises); the
    port reads every file to it, each read from the fixture directory
    (relative external names resolve there); a fresh run of the
    generator gives the same views (the shard's write-time stamps aside)
    and the same SNR."""
    exp = json.loads((FIXTURES / "expected.json").read_text())
    assert sorted(exp["files"]) == sorted(mf.FIXTURES)
    size = sum((FIXTURES / n).stat().st_size
               for n in (*mf.FIXTURES, *mf.COMPANIONS))
    assert size <= mf.MAX_BYTES
    for name, d in exp["files"].items():
        for h, key in ((False, "digest"), (True, "digest_header_only")):
            for pkg in (jnc, tnc):
                assert mf.read_beside(pkg.from_netcdf, FIXTURES, name,
                                      header_only=h) == d[key], (name, h)
    fresh = tmp_path / "fresh"
    got, _ = mf.make(fresh)
    for name in mf.FIXTURES:
        assert mf.read_beside(tnc.from_netcdf, fresh, name, stable=True) \
            == mf.read_beside(tnc.from_netcdf, FIXTURES, name,
                              stable=True), name
    assert xcorr_tpu_torch.read(str(FIXTURES / mf.SHARD)) is not None
    np.testing.assert_allclose(
        np.array([got["shard"]["snr"][k] for k in ("snr", "s", "n")]),
        np.array([exp["shard"]["snr"][k] for k in ("snr", "s", "n")]),
        rtol=1e-6)
    shutil.rmtree(fresh)
