"""The port's HDF5 reader on the structures other writers use, on the CPU.

Each file here is written by h5py (HDF5 1.14) from numpy-seeded data;
the JAX package (``xcorr_tpu.io.netcdf``, on h5py) is the reference:

- every structure h5py reads and the codec refused until now reads to
  the JAX package's view and its sha256 (``tools/hdf5_view.py``), with
  and without ``header_only``: virtual datasets (bounded, unlimited,
  printf-style), the szip, scaleoffset and nbit filters, optional
  filters the writer skipped, 4-byte offsets and lengths, dataset
  region references, bitfield and opaque data, null dataspaces,
  external raw-data storage and external links;
- the native decoders are bit-equal to h5py's decoded chunks
  (``read_direct_chunk`` against the dataset read whole) and the native
  lzf to its Python form;
- external files resolve by HDF5's rules, with the working directory
  away from the file and with the prefix variables, where h5py's own
  environment is set in a subprocess (the library reads some of them
  once, when it starts);
- a chunk that a filter the codec lacks really filtered, and packed
  nbit, raise ``NotImplementedError`` naming them; what both packages
  refuse (a shared datatype message, the time and array datatypes)
  still fails in both.
"""
import contextlib
import json
import os
import shutil
import struct
import subprocess
import sys

import h5py
import numpy as np
import pytest

from tools import make_hdf5_fixtures as mf
from tools.hdf5_view import digest, view
from xcorr_tpu.io import netcdf as jnc
from xcorr_tpu_torch.io import hdf5, hdf5_extern, hdf5_filters
from xcorr_tpu_torch.io import netcdf as tnc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(pkg, path, header_only):
    """``(digest, view)`` of ``pkg``'s read, or the exception's type."""
    try:
        ds = pkg.from_netcdf(path, header_only=header_only)
    except Exception as e:      # noqa: BLE001 -- compared by type
        return type(e).__name__, None
    return digest(ds), view(ds)


def _same(path, views=True):
    """Both packages read ``path`` alike, with and without
    ``header_only``: the same digest (or the same exception type) and,
    with ``views``, views that compare equal (the port's objects on the
    left: an h5py reference equals nothing). Returns the JAX package's
    full read."""
    for header_only in (False, True):
        want = _read(jnc, path, header_only)
        got = _read(tnc, path, header_only)
        assert got[0] == want[0], (header_only, got[0], want[0])
        if views and want[1] is not None:
            assert got[1] == want[1], header_only
    return _read(jnc, path, False)


def _filter(path, fid):
    """One float dataset through filter ``fid`` as ``set_filter`` or the
    filter's own setter puts it: nbit and the filters this HDF5 lacks
    are optional, so their chunks are stored as they were."""
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((16,))
        if fid == 4:
            dcpl.set_szip(h5py.h5z.SZIP_NN_OPTION_MASK, 8)
        elif fid == 6:
            dcpl.set_scaleoffset(h5py.h5z.SO_FLOAT_DSCALE, 2)
        else:
            dcpl.set_filter(fid, h5py.h5z.FLAG_OPTIONAL, ())
        h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F32LE,
                        h5py.h5s.create_simple((40,)), dcpl=dcpl)
        f["x"][...] = np.arange(40.0)


def _small_offsets(path, libver):
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*libver)
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                          fapl=fapl)
    with h5py.File(fid) as f:
        f.create_dataset("x", data=np.arange(3.0))


def _low_type(path, tid):
    with h5py.File(path, "w") as f:
        h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,)))


def _one(path, data):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data)


def _external(path):
    """External storage in a file named by its absolute path."""
    np.arange(10, dtype="<f4").tofile(path + ".raw")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", shape=(10,), dtype="f4",
                         external=[(path + ".raw", 0, 40)])


def _virtual(path):
    src = path + ".src.h5"
    with h5py.File(src, "w") as f:
        f.create_dataset("x", data=np.arange(4.0))
    layout = h5py.VirtualLayout(shape=(4,), dtype="f8")
    layout[:] = h5py.VirtualSource(src, "x", shape=(4,))
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("v", layout)


def _external_link(path):
    with h5py.File(path + ".other.h5", "w") as f:
        f.create_dataset("x", data=np.arange(6).reshape(2, 3))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(100.0))
        f["e"] = h5py.ExternalLink(os.path.basename(path) + ".other.h5",
                                   "/x")


def _unlimited_virtual(path):
    """Unlimited mappings: a source grown after the virtual dataset was
    made, a 2-D one whose extent follows its source down, and a
    printf-style one (``%b``) over three sources in a row, the fourth
    missing and the fifth there."""
    d = os.path.dirname(path)
    with h5py.File(os.path.join(d, "grow.h5"), "w") as f:
        f.create_dataset("x", data=np.arange(10.0), maxshape=(None,),
                         chunks=(4,))
        f.create_dataset("y", data=np.arange(14.0).reshape(2, 7),
                         maxshape=(2, None), chunks=(2, 2))
    for i in (0, 1, 2, 4):
        with h5py.File(os.path.join(d, f"p{i}.h5"), "w") as f:
            f.create_dataset("x", data=np.arange(4.0) + 10 * i)
    unl = h5py.h5s.UNLIMITED
    one = h5py.VirtualLayout(shape=(10,), maxshape=(None,), dtype="f8")
    one[0:unl] = h5py.VirtualSource("grow.h5", "x", shape=(10,),
                                    maxshape=(None,))[0:unl]
    two = h5py.VirtualLayout(shape=(2, 10), maxshape=(2, None), dtype="f8")
    two[:, 0:unl] = h5py.VirtualSource("grow.h5", "y", shape=(2, 7),
                                       maxshape=(2, None))[:, 0:unl]
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("one", one, fillvalue=-1.0)
        f.create_virtual_dataset("two", two, fillvalue=-1.0)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        vspace = h5py.h5s.create_simple((12,), (unl,))
        vspace.select_hyperslab((0,), (unl,), stride=(4,), block=(4,))
        dcpl.set_virtual(vspace, b"p%b.h5", b"x",
                         h5py.h5s.create_simple((4,)))
        h5py.h5d.create(f.id, b"printf", h5py.h5t.IEEE_F64LE,
                        h5py.h5s.create_simple((12,), (unl,)), dcpl=dcpl)
    with h5py.File(os.path.join(d, "grow.h5"), "a") as f:
        f["x"].resize((15,))
        f["x"][10:] = np.arange(10.0, 15.0)


#: each structure h5py reads that the codec refused, by the name its case
#: had in ``test_torch_hdf5_v2.py``'s refusals, then richer files of each
READ = {
    "virtual_dataset": _virtual,
    **{f"filter_{name}": (lambda p, i=fid: _filter(p, i))
       for name, fid in [("szip", 4), ("nbit", 5), ("scaleoffset", 6),
                         ("blosc", 32001), ("zstd", 32015),
                         ("40000", 40000)]},
    "offsets_4_bytes": lambda p: _small_offsets(
        p, (h5py.h5f.LIBVER_EARLIEST, h5py.h5f.LIBVER_LATEST)),
    "offsets_4_bytes_v3": lambda p: _small_offsets(
        p, (h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)),
    "region_reference": lambda p: _low_type(p, h5py.h5t.STD_REF_DSETREG),
    "bitfield_datatype": lambda p: _low_type(p, h5py.h5t.STD_B8LE),
    "opaque_datatype": lambda p: _one(p, np.zeros(3, "V4")),
    "external_link": _external_link,
    "external_storage": _external,
    # richer files, as the committed fixtures hold them
    "szip_cases": mf.write_szip,
    "scaleoffset_cases": mf.write_scaleoffset,
    "nbit_cases": mf.write_optional,
    "skipped_blosc": lambda p: mf.write_optional(p, 32001),
    "offsets_4_bytes_rich": mf.write_small_offsets,
    "offsets_4_bytes_rich_v3": lambda p: mf.write_small_offsets(p, True),
    "region_references": mf.write_region_references,
    "bitfield_opaque": mf.write_bitfield_opaque,
    "null_dataspace": mf.write_null,
    "virtual_datasets": mf.write_virtual,
    "virtual_unlimited": _unlimited_virtual,
    "external_link_beside": mf.write_external_link,
    "external_storage_relative": mf.write_external_storage,
}


@pytest.mark.parametrize("case", list(READ))
def test_structure_reads_as_the_jax_package_reads_it(case, tmp_path,
                                                     monkeypatch):
    """The file's view and digest through the port equal the JAX
    package's, full and ``header_only`` (where the JAX package raises,
    as for a null dataset's header-only size, the port raises the same
    type). Read from the file's directory: relative external storage
    names resolve from the working directory."""
    path = str(tmp_path / f"{case}.h5")
    READ[case](path)
    monkeypatch.chdir(tmp_path)
    refs = "region" in case
    want, _ = _same(path, views=not refs)
    assert len(want) == 64, want


def test_null_dataset_is_an_empty_of_its_dtype(tmp_path):
    """A null dataspace reads as the port's ``Empty``: h5py's repr (a
    float's byte order shown), equal to h5py's own; ``size`` is
    ``None`` and ``header_only`` raises ``TypeError`` in both."""
    path = str(tmp_path / "null.h5")
    mf.write_null(path)
    got, want = tnc.from_netcdf(path), jnc.from_netcdf(path)
    for name in ("nothing", "none_i8"):
        e = got[name].values[()]
        assert isinstance(e, hdf5.Empty)
        assert repr(e) == repr(want[name].values[()])
        assert e == want[name].values[()]
    assert repr(got.attrs["empty"]) == "Empty(dtype=dtype('int32'))"
    assert repr(got["x"].attrs["empty"]) == "Empty(dtype=dtype('>f8'))"
    with hdf5.File(path) as f:
        assert f["nothing"].size is None and f["nothing"].ndim == 0
    for pkg in (jnc, tnc):
        with pytest.raises(TypeError):
            pkg.from_netcdf(path, header_only=True)


def test_region_references_select_what_h5py_selects(tmp_path):
    """Each region reference names its target and the elements h5py's
    dereference selects, in the selection's order; a null one is false
    and has h5py's text."""
    path = str(tmp_path / "regions.h5")
    mf.write_region_references(path)
    ds = tnc.from_netcdf(path)
    refs = list(ds["r"].values) + [ds.attrs["region"],
                                   ds["x"].attrs["region"]]
    with h5py.File(path, "r") as f:
        theirs = list(f["r"][...]) + [f.attrs["region"],
                                      f["x"].attrs["region"]]
        x = f["x"][...]
        for mine, ref in zip(refs, theirs):
            assert repr(mine) == repr(ref)
            if not ref:
                assert not mine and mine.target is None
                continue
            assert "/" + mine.target == f[ref].name
            c = mine.coordinates()
            np.testing.assert_array_equal(
                x[tuple(c.T)], np.asarray(f["x"][ref]).reshape(-1))


@pytest.mark.parametrize("dt", ["u1", "<i2", ">i2", "<u4", ">f4", "<f8",
                                ">u8"])
@pytest.mark.parametrize("opt", ["nn", "ec"])
def test_szip_decoder_is_bit_equal_to_h5py(dt, opt, tmp_path):
    """Raw szip chunks (``read_direct_chunk``) decoded natively give
    h5py's decoded chunk: 8 to 64 bits, both predictors and byte orders,
    blocks of 8, 16 and 32 pixels, noise (uncompressed blocks, splits),
    a random walk (the second extension), runs and zeros (zero blocks),
    chunks whose last scanline is short."""
    rng = np.random.default_rng(7)
    mask = {"nn": h5py.h5z.SZIP_NN_OPTION_MASK,
            "ec": h5py.h5z.SZIP_EC_OPTION_MASK}[opt]
    path = str(tmp_path / "szip.h5")
    n = 0
    for ppb in (8, 16, 32):
        for kind in ("random", "smooth", "runs", "zeros"):
            for shape, chunk in (((700,), (700,)), ((37, 29), (17, 29)),
                                 ((5, 130), (3, 130))):
                x = mf.szip_data(dt, shape, kind, rng)
                with h5py.File(path, "w") as f:
                    dcpl = mf._dcpl(chunk)
                    dcpl.set_szip(mask, ppb)
                    mf._low(f, "x", dt, shape, dcpl, x)
                n += _hold_chunks(path, hdf5_filters.unszip)
    assert n > 40


@pytest.mark.parametrize("opt", ["nn", "ec"])
def test_szip_every_precision(opt, tmp_path):
    """Integers of every precision from 1 to 32 bits (1-, 2- and 4-byte
    containers): the coder's bits per pixel is the precision, so each
    sample width and option identifier length runs."""
    rng = np.random.default_rng(8)
    mask = {"nn": h5py.h5z.SZIP_NN_OPTION_MASK,
            "ec": h5py.h5z.SZIP_EC_OPTION_MASK}[opt]
    path = str(tmp_path / "prec.h5")
    for prec in range(1, 33):
        base = (h5py.h5t.STD_U8LE if prec <= 8 else h5py.h5t.STD_U16BE
                if prec <= 16 else h5py.h5t.STD_U32LE)
        dt = {1: "u1", 2: ">u2", 4: "<u4"}[base.get_size()]
        tid = base.copy()
        tid.set_precision(prec)
        x = (np.cumsum(rng.integers(-3, 4, 500)) % (1 << prec)).astype(dt)
        x[100:300] = 0
        with h5py.File(path, "w") as f:
            dcpl = mf._dcpl((500,))
            dcpl.set_szip(mask, 16)
            mf._low(f, "x", dt, (500,), dcpl, x, tid=tid)
        with h5py.File(path, "r") as f:
            cd = f["x"].id.get_create_plist().get_filter(0)[2]
            assert cd[2] == (prec if prec <= 24 else 32)
        assert _hold_chunks(path, hdf5_filters.unszip) == 1


def _hold_chunks(path, decode):
    """Decode each filtered chunk of dataset ``x`` and hold it to
    h5py's read of the dataset; the number of chunks decoded."""
    n = 0
    with h5py.File(path, "r") as f:
        d = f["x"]
        cd = d.id.get_create_plist().get_filter(0)[2]
        whole = d[...]
        chunk = d.chunks
        for i in range(d.id.get_num_chunks()):
            info = d.id.get_chunk_info(i)
            mask, raw = d.id.read_direct_chunk(info.chunk_offset)
            if mask:    # the optional filter did not pay: stored as it is
                continue
            got = np.frombuffer(bytes(decode(raw, cd)), d.dtype).reshape(
                chunk)
            sl = tuple(slice(o, o + c) for o, c in
                       zip(info.chunk_offset, chunk))
            part = whole[sl]
            assert got[tuple(slice(0, s) for s in part.shape)].tobytes() \
                == part.tobytes()
            n += 1
    return n


@pytest.mark.parametrize("dt", ["u1", "i1", "<u2", "<i4", ">i4", "<i8",
                                "<u8"])
def test_scaleoffset_integers_are_bit_equal_to_h5py(dt, tmp_path):
    """Integer scaleoffset, minimum bits found by the library, with no
    fill value, a fill value in the data, and a constant chunk (1-byte
    data spans less than the type: at 8 bits HDF5 1.14.6 cannot read
    its own chunks back)."""
    rng = np.random.default_rng(9)
    info = np.iinfo(dt)
    path = str(tmp_path / "so.h5")
    span = 50 if info.bits == 8 else 1000
    for fill in (None, 5):
        for data in (rng.integers(max(info.min, -span),
                                  min(info.max, span), 300),
                     np.full(300, 5), np.full(300, 9)):
            x = data.astype(dt)
            x[:10] = 5
            with h5py.File(path, "w") as f:
                kw = {} if fill is None else {"fill": np.array(fill, dt)}
                dcpl = mf._dcpl((64,), **kw)
                dcpl.set_scaleoffset(h5py.h5z.SO_INT, 0)
                mf._low(f, "x", dt, x.shape, dcpl, x)
            assert _hold_chunks(path, hdf5_filters.unscaleoffset) == 5


@pytest.mark.parametrize("dt", ["<f4", ">f4", "<f8", ">f8"])
def test_scaleoffset_floats_are_bit_equal_to_h5py(dt, tmp_path):
    """Float D-scaling, 0 to 6 decimals, with and without a fill value:
    the library divides in the element's own type, so only the same
    arithmetic gives the same bits."""
    rng = np.random.default_rng(10)
    path = str(tmp_path / "so.h5")
    for d in range(7):
        for fill in (None, -1.5):
            x = (rng.normal(size=(40, 30)) * 10.0 ** (3 - d)).astype(dt)
            x[:3] = -1.5
            with h5py.File(path, "w") as f:
                kw = {} if fill is None else {"fill": np.array(fill, dt)}
                dcpl = mf._dcpl((16, 30), **kw)
                dcpl.set_scaleoffset(h5py.h5z.SO_FLOAT_DSCALE, d)
                mf._low(f, "x", dt, x.shape, dcpl, x)
            assert _hold_chunks(path, hdf5_filters.unscaleoffset) == 3


def test_nbit_full_precision_chunks_are_stored_as_they_are(tmp_path):
    """nbit at a type's full precision: the library flags it (second
    parameter) and stores each chunk unchanged, which the port reads;
    the same file with the flag cleared is packed nbit, refused by
    name."""
    path = str(tmp_path / "nbit.h5")
    mf.write_optional(path)
    for name in ("f4", "i2"):
        with h5py.File(path, "r") as f:
            cd = f[name].id.get_create_plist().get_filter(0)[2]
            assert cd[1] == 1
            mask, raw = f[name].id.read_direct_chunk((16,))
            assert mask == 0
            assert bytes(hdf5_filters.unfilter(
                hdf5_filters.Filter(5, cd), raw, len(raw), 4)) == \
                f[name][16:32].tobytes()
    with pytest.raises(NotImplementedError, match="packed nbit"):
        hdf5_filters.unfilter(hdf5_filters.Filter(5, (8, 0)), b"", 4, 4)


def test_native_lzf_equals_the_plain_decoder(tmp_path):
    """Every lzf chunk h5py wrote (literal runs, short and long back
    references, overlapping repeats) decodes to the same bytes natively
    and in Python, and to h5py's chunk; a corrupt stream is an
    ``OSError`` in both."""
    rng = np.random.default_rng(11)
    path = str(tmp_path / "lzf.h5")
    data = np.concatenate([np.tile(np.arange(3, dtype="u1"), 5000),
                           rng.integers(0, 256, 20_000).astype("u1"),
                           np.repeat(rng.integers(0, 256, 300), 97
                                     ).astype("u1")])
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(8192,), compression="lzf")
    n = 0
    with h5py.File(path, "r") as f:
        d = f["x"]
        cd = d.id.get_create_plist().get_filter(0)[2]
        for i in range(d.id.get_num_chunks()):
            info = d.id.get_chunk_info(i)
            mask, raw = d.id.read_direct_chunk(info.chunk_offset)
            if mask:
                continue
            native = hdf5_filters.unlzf(raw, cd[2])
            assert native == hdf5_filters.unlzf_plain(raw, cd[2])
            o = info.chunk_offset[0]
            part = data[o:o + 8192].tobytes()
            assert bytes(native[:len(part)]) == part
            n += 1
    assert n >= 3
    for fn in (hdf5_filters.unlzf, hdf5_filters.unlzf_plain):
        with pytest.raises(OSError, match="lzf"):
            fn(b"\xe0\x00\x00", 100)


def _really_filtered(path, n):
    """A dataset whose optional blosc filter h5py lacks, one chunk
    written with a mask that says blosc was applied."""
    with h5py.File(path, "w") as f:
        dcpl = mf._dcpl((n,))
        dcpl.set_filter(32001, h5py.h5z.FLAG_OPTIONAL, ())
        h5py.h5d.create(f.id, b"big", h5py.h5t.IEEE_F32LE,
                        h5py.h5s.create_simple((n,)), dcpl=dcpl)
        f["big"].id.write_direct_chunk((0,), np.arange(n, dtype="f4")
                                       .tobytes(), filter_mask=0)
        f.create_dataset("small", data=np.arange(3.0))


def test_a_chunk_a_missing_filter_filtered_is_refused_by_name(tmp_path):
    """The pipeline is read whatever its filters; a chunk is refused
    only where its mask says a filter the codec lacks was applied. A
    variable too large to decode header-only reads in both packages;
    read whole, both fail, the port naming the filter."""
    path = str(tmp_path / "blosc.h5")
    _really_filtered(path, 70_000)
    want = _read(jnc, path, True)
    assert _read(tnc, path, True)[0] == want[0] and len(want[0]) == 64
    with pytest.raises(OSError):
        jnc.from_netcdf(path)
    with pytest.raises(NotImplementedError, match="filter blosc"):
        tnc.from_netcdf(path)


@pytest.mark.parametrize("case", ["shared_datatype", "time_datatype",
                                  "array_datatype"])
def test_structures_both_packages_refuse(case, tmp_path):
    """Where h5py cannot give the JAX package a variable, the port fails
    too, naming the structure: a datatype message flagged shared with
    no shared-message table (h5py: ``KeyError``), the time datatype
    (the JAX package: ``TypeError``), the array datatype (its dims
    against the array's ``ndim``: ``ValueError``)."""
    path = str(tmp_path / f"{case}.h5")
    if case == "shared_datatype":
        _shared_datatype(path)
        jax_error, match = KeyError, "shared object header messages"
    elif case == "time_datatype":
        _low_type(path, h5py.h5t.UNIX_D32LE)
        jax_error, match = TypeError, "time datatypes"
    else:
        _low_type(path, h5py.h5t.array_create(h5py.h5t.IEEE_F32LE, (3,)))
        jax_error, match = ValueError, "array datatypes"
    with pytest.raises(jax_error):
        jnc.from_netcdf(path)
    with pytest.raises(NotImplementedError, match=match):
        tnc.from_netcdf(path)


def test_opaque_data_of_a_foreign_tag_fails_in_both(tmp_path):
    """h5py converts opaque data only where the tag is its own (none, or
    ``NUMPY:`` and a dtype); a foreign tag has no conversion path, and
    the port's read raises the same ``OSError``."""
    path = str(tmp_path / "tagged.h5")
    with h5py.File(path, "w") as f:
        tid = h5py.h5t.create(h5py.h5t.OPAQUE, 3)
        tid.set_tag(b"instrument blob")
        h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((2,)))
    for pkg in (jnc, tnc):
        with pytest.raises(OSError, match="conversion path"):
            pkg.from_netcdf(path)
    with hdf5.File(path) as f:
        assert f["x"].dtype == np.dtype("V3")


def _shared_datatype(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(100.0))
    with hdf5.File(path) as r:
        addr = r._entries["x"]
        q = next(q for t, q, _ in r._messages(addr) if t == 0x03)
        a = r._addr(addr)
    buf = bytearray(open(path, "rb").read())
    buf[q - 1] |= 0x02
    flags = buf[a + 5]
    p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    w = 1 << (flags & 0x03)
    end = p + w + int.from_bytes(buf[p:p + w], "little")
    from xcorr_tpu_torch.io import hdf5_v2
    struct.pack_into("<I", buf, end, hdf5_v2.lookup3(bytes(buf[a:end])))
    open(path, "wb").write(bytes(buf))


def test_rewrite_keeps_a_skipped_optional_filter(tmp_path):
    """Mode ``"a"`` takes over a dataset whose optional filter the
    writer skipped: its chunks and their masks as stored, the pipeline
    with the filter's id, flags and client data; a new chunked string
    dataset under the same kind of filter is skipped and masked as the
    library does. h5py reads the rewritten file to the same data."""
    path = str(tmp_path / "day.h5")
    mf.write_optional(path, 32015)
    with h5py.File(path, "a") as f:
        dcpl = mf._dcpl((2,))
        dcpl.set_filter(32015, h5py.h5z.FLAG_OPTIONAL, ())
        h5py.h5d.create(f.id, b"s", h5py.h5t.py_create(
            h5py.string_dtype(), logical=True), h5py.h5s.create_simple((3,)),
            dcpl=dcpl)
        f["s"][...] = np.array(["ab", "cde", "f"], object)
    with h5py.File(path, "r") as f:
        want = {k: f[k][...] for k in f}
        pl = f["f4"].id.get_create_plist().get_filter(0)
    with hdf5.File(path, "a") as f:
        f.create_dataset("added", data=np.arange(3.0))
        f["f4"].attrs["note"] = "kept"
    with h5py.File(path, "r") as f:
        assert f.id.get_create_plist().get_version()[0] == 0
        for k, v in want.items():
            np.testing.assert_array_equal(f[k][...], v)
            d = f[k]
            got = d.id.get_create_plist().get_filter(0)
            assert got[:3] == pl[:3]
            assert all(d.id.get_chunk_info(i).filter_mask == 1
                       for i in range(d.id.get_num_chunks()))
        assert f["f4"].attrs["note"] == "kept"


def _chunked_link(path):
    """An external link to a chunked, deflated dataset of another file,
    beside a dataset of the file itself."""
    with h5py.File(path + ".other.h5", "w") as f:
        f.create_dataset("x", data=np.arange(60.0).reshape(6, 10),
                         chunks=(2, 5), compression="gzip")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("y", data=np.arange(3.0))
        f["e"] = h5py.ExternalLink(os.path.basename(path) + ".other.h5",
                                   "/x")


def _soft_link(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3.0))
        f["s"] = h5py.SoftLink("/x")


def _null(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("nothing", data=h5py.Empty("<f4"))


#: files with a member that mode ``"a"`` cannot write again: the writer,
#: the member's name
_NOT_REWRITTEN = {
    "external_link": (_chunked_link, "e"),
    "soft_link": (_soft_link, "s"),
    "region_reference": (lambda p: _low_type(p, h5py.h5t.STD_REF_DSETREG),
                         "x"),
    "null_dataspace": (_null, "nothing"),
    "external_storage": (_external, "x"),
    "virtual_dataset": (_virtual, "v"),
}


@pytest.mark.parametrize("case", list(_NOT_REWRITTEN))
def test_rewrite_refuses_what_it_cannot_write_again(case, tmp_path):
    """Mode ``"a"`` refuses a file with a member it would write wrongly,
    naming the member: a soft or external link (it would become a copy,
    and a chunked link target's chunks would be read from this file),
    region references, a null dataspace, external storage, a virtual
    dataset. The file and the files beside it stay as they were, and
    h5py still reads the link's target through the link."""
    path = str(tmp_path / "day.h5")
    write, member = _NOT_REWRITTEN[case]
    write(path)
    before = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    with pytest.raises(NotImplementedError, match=f"rewriting '{member}'"):
        with hdf5.File(path, "a") as f:
            f.create_dataset("added", data=np.arange(3.0))
    assert {p.name: p.read_bytes() for p in tmp_path.iterdir()} == before
    if case == "external_link":
        with h5py.File(path, "r") as f:
            assert isinstance(f.get("e", getlink=True), h5py.ExternalLink)
            np.testing.assert_array_equal(
                f["e"][...], np.arange(60.0).reshape(6, 10))


@pytest.mark.parametrize("shuffle", [False, True])
def test_a_szip_chunk_of_another_size_than_the_chunk_is_refused(
        shuffle, tmp_path, monkeypatch):
    """Where no applied filter after szip changes a chunk's size (none,
    or shuffle), the decoder's output is the chunk's size, not the size
    in the stream's header: a header that says otherwise raises
    ``OSError``, and nothing is allocated at the header's size."""
    path = str(tmp_path / "szip.h5")
    x = np.arange(100, dtype="<f4")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=x, chunks=(100,), compression="szip",
                         shuffle=shuffle)
    sizes = []
    real = hdf5_filters._call

    def call(name, fn, src, want, *args):
        sizes.append((name, want))
        return real(name, fn, src, want, *args)

    monkeypatch.setattr(hdf5_filters, "_call", call)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["x"][...], x)
    assert sizes == [("szip", 400)]
    with h5py.File(path, "a") as f:
        mask, raw = f["x"].id.read_direct_chunk((0,))
        raw = struct.pack("<I", 0xFFFFFFF0) + raw[4:]
        f["x"].id.write_direct_chunk((0,), raw, mask)
    sizes.clear()
    with hdf5.File(path) as f:
        with pytest.raises(OSError, match="szip chunk of another size"):
            f["x"][...]
    assert sizes == [("szip", 400)]


#: resolution cases: (name, file in the layout below, working directory,
#: environment of h5py's process and of the port's read)
_LAYOUT_ENVS = {
    "none": {},
    "origin_sub": {"HDF5_EXTFILE_PREFIX": "${ORIGIN}/sub",
                   "HDF5_VDS_PREFIX": "${ORIGIN}/sub",
                   "HDF5_EXT_PREFIX": "/nowhere:{data}/sub"},
    "absolute": {"HDF5_EXTFILE_PREFIX": "{data}/sub",
                 "HDF5_VDS_PREFIX": "/nowhere:{data}/sub"},
    "origin": {"HDF5_EXTFILE_PREFIX": "${ORIGIN}"},
}
_CASES = {
    "none": [("efl_rel.h5", "else"), ("efl_rel.h5", "cwd"),
             ("efl_abs.h5", "else"), ("efl_sub.h5", "root"),
             ("l_beside.h5", "else"), ("l_sub.h5", "else"),
             ("l_cwd.h5", "cwd"), ("l_absmissing.h5", "else"),
             ("l_subpath.h5", "else"), ("v_beside.h5", "else"),
             ("v_sub.h5", "else"), ("v_cwd.h5", "cwd"),
             ("v_subpath.h5", "else")],
    "origin_sub": [("efl_rel.h5", "else"), ("l_sub.h5", "else"),
                   ("v_sub.h5", "else")],
    "absolute": [("efl_rel.h5", "else"), ("v_sub.h5", "else")],
    "origin": [("efl_sub.h5", "else"), ("efl_rel.h5", "else")],
}

_JAX_READS = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from tools.hdf5_view import digest
from xcorr_tpu.io.netcdf import from_netcdf
out = []
for path, cwd in json.loads(sys.argv[2]):
    os.chdir(cwd)
    try:
        out.append(digest(from_netcdf(path)))
    except Exception as e:
        out.append(type(e).__name__)
print(json.dumps(out))
"""


def _resolution_layout(root):
    """``data/`` holds the files that name others (``data/sub/`` some of
    the targets), ``cwd/`` targets found only from there, ``else/``
    nothing."""
    data = root / "data"
    for d in (data / "sub", root / "cwd", root / "else"):
        d.mkdir(parents=True)
    for d in (data / "sub", root / "cwd"):
        np.arange(10, dtype="<f4").tofile(d / "ext.raw")
    for name, where in (("efl_rel.h5", "ext.raw"),
                        ("efl_sub.h5", "sub/ext.raw"),
                        ("efl_abs.h5", str(data / "sub" / "ext.raw"))):
        with h5py.File(data / name, "w") as f:
            f.create_dataset("x", shape=(10,), dtype="<f4",
                             external=[(where, 0, 40)])
    for name, where in (("t_beside.h5", data), ("t_sub.h5", data / "sub"),
                        ("t_cwd.h5", root / "cwd")):
        with h5py.File(where / name, "w") as f:
            f.create_dataset("x", data=np.arange(6.0) + len(str(where)))
    for kind, target in (("beside", "t_beside.h5"), ("sub", "t_sub.h5"),
                         ("cwd", "t_cwd.h5"), ("subpath", "sub/t_sub.h5"),
                         ("absmissing", "/nonexistent/dir/t_beside.h5")):
        with h5py.File(data / f"l_{kind}.h5", "w", libver="latest") as f:
            f.create_dataset("a", data=np.arange(2))
            f["e"] = h5py.ExternalLink(target, "/x")
        if kind == "absmissing":
            continue
        layout = h5py.VirtualLayout(shape=(6,), dtype="f8")
        layout[:] = h5py.VirtualSource(target, "x", shape=(6,))
        with h5py.File(data / f"v_{kind}.h5", "w") as f:
            f.create_virtual_dataset("v", layout, fillvalue=-7.0)
    return data


@pytest.mark.parametrize("env", list(_LAYOUT_ENVS))
def test_external_files_resolve_as_hdf5_resolves_them(env, tmp_path,
                                                      monkeypatch):
    """External storage, external links and virtual dataset sources, read
    from a working directory away from the file (or where only the
    working directory holds the target), bare and under the prefix
    variables: the port's read of each equals h5py's (the JAX package
    in a process started with the same environment), a file that
    neither finds included."""
    data = _resolution_layout(tmp_path)
    dirs = {"else": tmp_path / "else", "cwd": tmp_path / "cwd",
            "root": tmp_path}
    cases = [(str(data / name) if where != "root" else
              os.path.join("data", name), str(dirs[where]))
             for name, where in _CASES[env]]
    extra = {k: v.replace("{data}", str(data))
             for k, v in _LAYOUT_ENVS[env].items()}
    for k in ("HDF5_EXTFILE_PREFIX", "HDF5_VDS_PREFIX", "HDF5_EXT_PREFIX"):
        monkeypatch.delenv(k, raising=False)
    run = subprocess.run(
        [sys.executable, "-c", _JAX_READS, ROOT, json.dumps(cases)],
        env={**os.environ, "JAX_PLATFORMS": "cpu", **extra},
        capture_output=True, text=True, check=True)
    want = json.loads(run.stdout.strip().splitlines()[-1])
    for k, v in extra.items():
        monkeypatch.setenv(k, v)
    got = []
    for path, cwd in cases:
        with contextlib.chdir(cwd):
            try:
                got.append(digest(tnc.from_netcdf(path)))
            except Exception as e:      # noqa: BLE001 -- compared by type
                got.append(type(e).__name__)
    assert got == want
    assert any(len(w) == 64 for w in want)


def test_selection_decoder_versions():
    """Serialized selections as the library writes them (version 1
    hyperslabs and points from region references, version 2 regular
    hyperslabs from unlimited mappings) and the later encodings
    (version 2 points and version 3 hyperslabs, 2-byte values), each
    to its elements in the library's order."""
    sel, end = hdf5_extern.selection(struct.pack(
        "<10I", 2, 1, 0, 24, 2, 1, 1, 2, 2, 3), 0)
    assert end == 40
    assert sel.flat((4, 5)).tolist() == [7, 8, 12, 13]
    sel, _ = hdf5_extern.selection(struct.pack(
        "<12I", 1, 1, 0, 32, 2, 3, 3, 4, 0, 1, 2, 2), 0)
    assert sel.flat((4, 5)).tolist() == [19, 1, 12]
    sel, _ = hdf5_extern.selection(struct.pack("<4I", 3, 1, 0, 0), 0)
    assert sel.flat((2, 2)).tolist() == [0, 1, 2, 3]
    sel, _ = hdf5_extern.selection(
        struct.pack("<IIBII", 2, 2, 1, 36, 1)
        + struct.pack("<4Q", 1, 4, 0xFFFFFFFFFFFFFFFF, 2), 0)
    assert sel.unlimited == 0
    assert sel.flat((11,)).tolist() == [1, 2, 5, 6, 9, 10]
    sel, _ = hdf5_extern.selection(
        struct.pack("<IIBIH", 1, 2, 2, 1, 3) + struct.pack("<3H", 4, 0, 2),
        0)
    assert sel.flat((5,)).tolist() == [4, 0, 2]
    sel, _ = hdf5_extern.selection(
        struct.pack("<IIBBI", 2, 3, 0, 2, 1) + struct.pack("<H4H", 2, 0, 1,
                                                            5, 6), 0)
    assert sel.flat((8,)).tolist() == [0, 1, 5, 6]


def test_committed_foreign_fixtures_name_files_beside_them(tmp_path):
    """The committed fixtures' external names resolve from the fixture
    directory (``tools/make_hdf5_fixtures.py`` reads every fixture with
    it as the working directory, as ``chip_smoke.py`` phase 12 does):
    copied elsewhere whole, they read the same; without the companions
    their targets are missing in both packages alike."""
    src = mf.OUT
    dst = tmp_path / "copy"
    shutil.copytree(src, dst)
    exp = json.loads((src / "expected.json").read_text())
    for name in ("virtual.h5", "external_link.h5", "external_storage.h5"):
        assert (dst / name).exists(), name
        with contextlib.chdir(dst):
            assert digest(tnc.from_netcdf(name)) == \
                exp["files"][name]["digest"]
    for name in mf.COMPANIONS:
        (dst / name).unlink()
    with contextlib.chdir(dst):
        for name in ("external_link.h5", "external_storage.h5"):
            for pkg in (jnc, tnc):
                with pytest.raises((KeyError, OSError)):
                    pkg.from_netcdf(name)
        assert digest(tnc.from_netcdf("virtual.h5")) == \
            digest(jnc.from_netcdf("virtual.h5"))
