"""HDF5 files that other writers make, and what the JAX package reads
from them: the fixtures of the port's HDF5 codec.

    python3 tools/make_hdf5_fixtures.py [--out tests/fixtures_torch/hdf5]

Writes, with h5py, one small file per structure that the port's reader
takes from other writers: the newer file format
(``xcorr_tpu_torch/io/hdf5_v2.py``: netCDF-C's layout, each version-4
chunk index, fletcher32, lzf), and the structures of
``io/hdf5_filters.py`` and ``io/hdf5_extern.py`` (szip, scaleoffset,
nbit, a skipped optional filter, 4-byte offsets in superblocks 0 and 3,
virtual datasets, an external link, external storage, region
references, bitfield and opaque data, null dataspaces), with the files
they name (:data:`COMPANIONS`) beside them; and a small xcorr shard that
the JAX package's ``to_netcdf`` wrote under netCDF-C's file settings.
Then ``expected.json``: the sha256 of each file's view as
``xcorr_tpu.io.netcdf.from_netcdf`` reads it (with and without
``header_only``; ``"raises <type>"`` where that read raises), and the
port's ``pair_snr`` of the shard on the CPU. Every fixture is read with
the fixture directory as the working directory (:func:`read_beside`),
here, in the tests and in ``chip_smoke.py`` phase 12: the library
resolves a relative external storage name from there. Needs h5py with
szip encoding and the JAX package, which the writers import in their
bodies; ``tests/test_torch_hdf5_v2.py`` and
``tests/test_torch_hdf5_foreign.py`` import the writers from here. The
views and their digests are in ``tools/hdf5_view.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.hdf5_view import digest_or_raise  # noqa: E402

OUT = ROOT / "tests" / "fixtures_torch" / "hdf5"
MAX_BYTES = 1 << 20

#: the file settings a foreign writer uses: netCDF-C's (creation order
#: tracked, the HDF5 1.8 format at the least), h5py's newest format, and
#: creation order alone
FILE_SETTINGS = {
    "netcdf_c": {"libver": ("v108", "latest"), "track_order": True},
    "latest": {"libver": "latest"},
    "track_order": {"track_order": True},
}
#: netCDF-C's NAME of a dimension that has no variable
NC_DIM = "This is a netCDF dimension but not a netCDF variable."

#: the shard: a pair 67 km apart, 5 Hz, four hours of 1 h windows
SHARD_PAIR = "IM.H03S1..EDH-IM.H03S2..EDH"
SHARD_DAY = "2014-02-01"
SHARD_DELAY = 45.0
SNR_FILTER = {"frequency": 0.5, "btype": "highpass", "order": 2}
SNR_CELERITY = (1000.0, 2000.0)
# ---------------------------------------------------------------------------
# writers (h5py)


def write_netcdf_c(path):
    """netCDF-C's layout: creation order tracked on the file and every
    dataset, ``_NCProperties``, ``_Netcdf4Dimid`` and
    ``_Netcdf4Coordinates``, a dimension without a variable (no data
    written), an unlimited chunked ``time``, more than 8 variables (dense
    links) and more than 8 attributes on the root and on ``cc`` (dense
    attributes)."""
    import h5py
    rng = np.random.default_rng(12)
    kw = {"track_order": True}
    with h5py.File(path, "w", **FILE_SETTINGS["netcdf_c"]) as f:
        f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,netcdf=4.9.2,hdf5=1.14.6")
        for i in range(9):
            f.attrs[f"g{8 - i}"] = [f"text {i}", 1.5 * i, np.int16(i),
                                    np.arange(i + 1.0)][i % 4]
        t = f.create_dataset("time", data=np.arange(6.0) * 3600.0,
                             maxshape=(None,), chunks=(4,), **kw)
        t.make_scale("time")
        t.attrs["_Netcdf4Dimid"] = np.int32(0)
        t.attrs["units"] = "seconds since 2014-02-01"
        nv = f.create_dataset("nv", shape=(2,), dtype="f4", **kw)
        nv.make_scale(f"{NC_DIM}{2:10d}")
        nv.attrs["_Netcdf4Dimid"] = np.int32(1)
        lag = f.create_dataset("lag", data=np.linspace(-2.0, 2.0, 9), **kw)
        lag.make_scale("lag")
        lag.attrs["_Netcdf4Dimid"] = np.int32(2)
        cc = f.create_dataset(
            "cc", data=rng.normal(size=(6, 9)).astype("f4"), chunks=(1, 9),
            maxshape=(None, 9), compression="gzip", shuffle=True, **kw)
        cc.dims[0].attach_scale(t)
        cc.dims[1].attach_scale(lag)
        cc.attrs["_Netcdf4Coordinates"] = np.array([0, 2], "i4")
        for i in range(10):
            cc.attrs[f"a{9 - i}"] = [np.float32(i), f"ü{i}", i][i % 3]
        bnds = f.create_dataset("time_bnds", data=np.arange(12.0).reshape(
            6, 2), **kw)
        bnds.dims[0].attach_scale(t)
        bnds.dims[1].attach_scale(nv)
        bnds.attrs["_Netcdf4Coordinates"] = np.array([0, 1], "i4")
        for i in range(7):
            v = f.create_dataset(f"v{i}", data=rng.integers(
                -9, 9, size=6).astype(["i1", "u2", "i4", "i8", "f2", "f4",
                                        "f8"][i]), **kw)
            v.dims[0].attach_scale(t)
            v.attrs["long_name"] = f"variable {i}"


#: the version-4 chunk indexes: (shape, maximum shape, chunks); each has
#: partial edge chunks and chunks it never writes
INDEXES = {
    "single": ((5, 7), None, (5, 7)),
    "implicit": ((10, 7), None, (4, 3)),
    "fixed": ((150, 45), None, (1, 2)),                 # 3450 chunks
    "extensible": ((700, 10), (None, 10), (1, 4)),      # 2100 chunks
    "extensible_swizzled": ((10, 70), (10, None), (3, 1)),
    "extensible_paged": ((131_200,), (None,), (1,)),     # paged data block
    "btree2": ((61, 40), (None, None), (4, 3)),         # an internal node
}


def write_index(path, kind, filtered=False, settings="latest"):
    """A dataset under one chunk index, in h5py's newest format, with
    fill value -1 where chunks were never written."""
    import h5py
    shape, maxshape, chunks = INDEXES[kind]
    rng = np.random.default_rng(len(kind))
    data = rng.normal(size=shape).astype("f4")
    filt = {"compression": "gzip", "shuffle": True} if filtered else {}
    with h5py.File(path, "w", **FILE_SETTINGS[settings]) as f:
        if kind == "implicit":
            # early allocation and no filter: the implicit index
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk(chunks)
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            dcpl.set_fill_value(np.array(-1.0, "f4"))
            h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F32LE,
                            h5py.h5s.create_simple(shape), dcpl=dcpl)
            d = f["x"]
        else:
            d = f.create_dataset("x", shape=shape, dtype="f4", chunks=chunks,
                                 maxshape=maxshape, fillvalue=-1.0, **filt)
        if kind == "extensible_paged":
            for i in list(range(0, 40, 3)) + [131_100, 131_150, 131_199]:
                d[i] = data[i]
        elif kind == "single":
            d[...] = data
        else:
            n0 = shape[0]
            d[: n0 // 3] = data[: n0 // 3]
            d[n0 // 2: n0 // 2 + 2] = data[n0 // 2: n0 // 2 + 2]
            d[-1] = data[-1]
        d.attrs["kind"] = kind
    return path


def write_filter(path, name, settings=None):
    """fletcher32 (with shuffle and deflate) or lzf, chunked with
    partial edge chunks, in the oldest or newest format."""
    import h5py
    rng = np.random.default_rng(7)
    data = rng.normal(size=(37, 50)).astype("f4")
    data[5:20] = 0.25      # something for lzf to compress
    kw = {"fletcher32": {"fletcher32": True, "compression": "gzip",
                         "shuffle": True},
          "lzf": {"compression": "lzf", "shuffle": True}}[name]
    with h5py.File(path, "w", **FILE_SETTINGS.get(settings, {})) as f:
        f.create_dataset("x", data=data, chunks=(8, 16), **kw)
        f.create_dataset("i", data=np.arange(1000, dtype="i8"),
                         chunks=(300,), **{k: v for k, v in kw.items()
                                           if k != "shuffle"})
    return path


def _dcpl(chunk, **kw):
    import h5py
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunk)
    if "fill" in kw:
        dcpl.set_fill_value(np.asarray(kw["fill"]))
    return dcpl


def _low(f, name, dt, shape, dcpl, data, tid=None):
    """A dataset through h5py's low-level API (``dcpl``'s filters), then
    written whole through the high-level one."""
    import h5py
    tid = h5py.h5t.py_create(np.dtype(dt)) if tid is None else tid
    h5py.h5d.create(f.id, name.encode(), tid, h5py.h5s.create_simple(shape),
                    dcpl=dcpl)
    f[name][...] = data


#: szip cases: (dtype, options, pixels per block, shape, chunk, data kind);
#: chunks whose last dimension is no multiple of the block (a short last
#: scanline), both predictors, both byte orders, 8 to 64 bits
SZIP_CASES = {
    "u1_nn": ("u1", "nn", 8, (40, 29), (17, 29), "smooth"),
    "i2_ec": ("<i2", "ec", 16, (300,), (128,), "random"),
    "i2_be_nn": (">i2", "nn", 32, (5, 70), (5, 70), "runs"),
    "f4_nn": ("<f4", "nn", 8, (37, 50), (8, 16), "smooth"),
    "f4_be_ec": (">f4", "ec", 16, (64,), (64,), "random"),
    "f8_nn": ("<f8", "nn", 32, (600,), (250,), "smooth"),
    "u8_ec": ("<u8", "ec", 8, (33,), (33,), "zeros"),
}


def szip_data(dt, shape, kind, rng):
    """Data that takes each of the coder's options: noise (no
    compression, splits), a random walk (splits, the second extension),
    runs and zeros (zero blocks)."""
    n = int(np.prod(shape))
    dt = np.dtype(dt)
    if kind == "random":
        x = rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)
        if dt.kind == "f":
            x = rng.normal(size=n).astype(dt)
    elif kind == "smooth":
        x = np.cumsum(rng.normal(size=n) * 2.0)
        x = (x - x.min()).astype(dt)
    elif kind == "runs":
        x = np.zeros(n, dt)
        x[n // 3:n // 3 + 9] = 3
        x[-2:] = 1
    else:
        x = np.zeros(n, dt)
    return x.reshape(shape)


def write_szip(path):
    """One dataset per :data:`SZIP_CASES` entry, through h5py's szip
    encoder (libaec); needs an HDF5 built with szip encoding."""
    import h5py
    rng = np.random.default_rng(41)
    opts = {"nn": h5py.h5z.SZIP_NN_OPTION_MASK,
            "ec": h5py.h5z.SZIP_EC_OPTION_MASK}
    with h5py.File(path, "w") as f:
        for name, (dt, opt, ppb, shape, chunk, kind) in SZIP_CASES.items():
            dcpl = _dcpl(chunk)
            dcpl.set_szip(opts[opt], ppb)
            _low(f, name, dt, shape, dcpl, szip_data(dt, shape, kind, rng))
    return path


def write_scaleoffset(path):
    """scaleoffset: integers with the minimum bits found by the library
    and with a fill value, floats by D-scaling (0, 2 and 5 decimals) with
    and without a fill value, big-endian among them."""
    import h5py
    rng = np.random.default_rng(42)
    with h5py.File(path, "w") as f:
        for name, dt, fill in [("i4", "<i4", None), ("u2_fill", "<u2", 7),
                               ("i8_be_fill", ">i8", -3)]:
            x = rng.integers(-900 if dt != "<u2" else 0, 900, (50, 9)
                             ).astype(dt)
            x[:2] = 7 if fill is None else fill
            kw = {} if fill is None else {"fill": np.array(fill, dt)}
            dcpl = _dcpl((16, 9), **kw)
            dcpl.set_scaleoffset(h5py.h5z.SO_INT, 0)
            _low(f, name, dt, x.shape, dcpl, x)
        for name, dt, d, fill in [("f4_d0", "<f4", 0, None),
                                  ("f4_d2_fill", "<f4", 2, -1.5),
                                  ("f8_d5", "<f8", 5, 0.0),
                                  ("f4_be_d2", ">f4", 2, None)]:
            x = (rng.normal(size=(40, 30)) * 10.0 ** (3 - d)).astype(dt)
            x[:3] = -1.5
            kw = {} if fill is None else {"fill": np.array(fill, dt)}
            dcpl = _dcpl((16, 30), **kw)
            dcpl.set_scaleoffset(h5py.h5z.SO_FLOAT_DSCALE, d)
            _low(f, name, dt, x.shape, dcpl, x)
    return path


def write_optional(path, fid=5):
    """A filter set optional through ``set_filter``: nbit (id 5) stores
    full-precision chunks as they are; filters this HDF5 lacks (blosc
    32001, zstd 32015, an unknown 40000) are skipped, each chunk's mask
    saying so."""
    import h5py
    with h5py.File(path, "w") as f:
        for name, dt in (("f4", "<f4"), ("i2", ">i2")):
            dcpl = _dcpl((16,))
            dcpl.set_filter(fid, h5py.h5z.FLAG_OPTIONAL, ())
            _low(f, name, dt, (40,), dcpl, np.arange(40).astype(dt))
    return path


def write_small_offsets(path, latest=False):
    """4-byte offsets and lengths (``set_sizes(4, 4)``), in superblock 0
    or 3: chunked deflate and shuffle, strings, attributes, dimension
    scales; in superblock 3 also dense links and attributes and the
    chunk indexes."""
    import h5py
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    low = h5py.h5f.LIBVER_LATEST if latest else h5py.h5f.LIBVER_EARLIEST
    fapl.set_libver_bounds(low, h5py.h5f.LIBVER_LATEST)
    rng = np.random.default_rng(43)
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                          fapl=fapl)
    with h5py.File(fid) as f:
        t = f.create_dataset("time", data=np.arange(12.0))
        t.make_scale("time")
        cc = f.create_dataset("cc", data=rng.normal(size=(12, 40)).astype(
            "f4"), chunks=(3, 16), compression="gzip", shuffle=True)
        cc.dims[0].attach_scale(t)
        f.create_dataset("names", data=np.array(["a", "ü", ""], object),
                         dtype=h5py.string_dtype())
        f.attrs["title"] = "four-byte offsets"
        f.attrs["list"] = ["x", "yz"]
        cc.attrs["scale"] = np.float32(0.5)
        if latest:
            for i in range(10):
                cc.attrs[f"a{i}"] = i * 1.5
                f.create_dataset(f"v{i}", data=np.arange(i + 2, dtype="i2"))
            f.create_dataset("fixed", data=rng.normal(size=(30, 4)),
                             chunks=(4, 4), compression="gzip")
            f.create_dataset("single", data=rng.normal(size=(9, 7)),
                             chunks=(9, 7), compression="gzip")
    return path


def write_region_references(path):
    """Dataset region references (old style, h5py's ``regionref``): a
    dataset of them (a hyperslab, all, a strided hyperslab, points, a
    null one) and one in an attribute."""
    import h5py
    with h5py.File(path, "w") as f:
        x = f.create_dataset("x", data=np.arange(20.0).reshape(4, 5))
        r = f.create_dataset("r", (5,), dtype=h5py.regionref_dtype)
        r[0] = x.regionref[1:3, 2:4]
        r[1] = x.regionref[...]
        r[2] = x.regionref[0:4:2, 1]
        space = x.id.get_space()
        space.select_elements(np.array([[3, 4], [0, 1], [2, 2]]))
        r[3] = h5py.h5r.create(x.id, b".", h5py.h5r.DATASET_REGION, space)
        f.attrs["region"] = x.regionref[0:1, ::2]
        x.attrs["region"] = x.regionref[[0, 2], :]
    return path


def write_bitfield_opaque(path):
    """Bitfields of 1, 2 (big-endian) and 4 bytes, which h5py reads as
    unsigned integers; opaque data untagged (``V4``) and tagged by h5py's
    ``opaque_dtype`` (datetime64), in datasets and an attribute."""
    import h5py
    rng = np.random.default_rng(44)
    with h5py.File(path, "w") as f:
        for name, tid, dt in (("b8", h5py.h5t.STD_B8LE, "u1"),
                              ("b16be", h5py.h5t.STD_B16BE, ">u2"),
                              ("b32", h5py.h5t.STD_B32LE, "<u4")):
            h5py.h5d.create(f.id, name.encode(), tid,
                            h5py.h5s.create_simple((6,)))
            f[name][...] = rng.integers(0, 200, 6).astype(dt)
        f.create_dataset("v4", data=np.frombuffer(
            rng.integers(0, 256, 24, dtype=np.uint8).tobytes(), "V4"))
        t = np.array(["2014-02-01T00:00", "2014-02-01T03:00"], "M8[ns]")
        f.create_dataset("when", data=t.astype(
            h5py.opaque_dtype(t.dtype)))
        f.attrs["blob"] = np.frombuffer(b"abcdef", "V2")
    return path


def write_null(path):
    """Null dataspaces (h5py's ``Empty``): datasets of a float and an
    integer type, and attributes on the file and on a dataset."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("nothing", data=h5py.Empty("<f4"))
        f.create_dataset("none_i8", data=h5py.Empty("<i8"))
        x = f.create_dataset("x", data=np.arange(3.0))
        x.attrs["empty"] = h5py.Empty(">f8")
        f.attrs["empty"] = h5py.Empty("i4")
    return path


#: files that the fixtures of other files name, written beside them
COMPANIONS = ("vds_source.h5", "link_target.h5", "external.raw")


def write_virtual(path):
    """Virtual datasets: rows of ``vds_source.h5`` (named by a relative
    path, so it resolves beside the file), a strided source selection,
    an integer source in a float dataset, a source in the file itself
    (``"."``), a source file that is missing, and the fill value where
    nothing maps."""
    import h5py
    src = os.path.join(os.path.dirname(os.path.abspath(path)),
                       "vds_source.h5")
    with h5py.File(src, "w") as f:
        f.create_dataset("x", data=np.arange(12.0).reshape(3, 4))
        f.create_dataset("i", data=np.arange(10, dtype="i4"))
    name = "vds_source.h5"
    layout = h5py.VirtualLayout(shape=(2, 6), dtype="f8")
    layout[0, :4] = h5py.VirtualSource(name, "x", shape=(3, 4))[1]
    layout[1, 1:3] = h5py.VirtualSource(name, "x", shape=(3, 4))[2, ::2]
    layout[1, 4:6] = h5py.VirtualSource("missing.h5", "x", shape=(3, 4))[
        0, :2]
    ints = h5py.VirtualLayout(shape=(5,), dtype="f8")
    ints[:] = h5py.VirtualSource(name, "i", shape=(10,))[::2]
    with h5py.File(path, "w") as f:
        f.create_dataset("y", data=np.arange(5.0))
        f.create_virtual_dataset("v", layout, fillvalue=-1.0)
        f.create_virtual_dataset("ints", ints, fillvalue=0.5)
        same = h5py.VirtualLayout(shape=(3,), dtype="f8")
        same[:] = h5py.VirtualSource(f["y"])[1:4]
        f.create_virtual_dataset("w", same)
    return path


def write_external_link(path):
    """An external link to a dataset in the root group of
    ``link_target.h5`` (a relative name: it resolves beside the file),
    beside a dataset of the file itself."""
    import h5py
    target = os.path.join(os.path.dirname(os.path.abspath(path)),
                          "link_target.h5")
    with h5py.File(target, "w") as f:
        d = f.create_dataset("x", data=np.arange(12.0).reshape(3, 4))
        d.attrs["units"] = "m"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("a", data=np.arange(3))
        f["e"] = h5py.ExternalLink("link_target.h5", "/x")
    return path


def write_external_storage(path):
    """External raw data storage: two slots of ``external.raw`` (a name
    the library resolves from the working directory, so the file is read
    from its own directory), the second running past the file's end."""
    import h5py
    path = os.path.abspath(path)
    with contextlib.chdir(os.path.dirname(path)):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", shape=(10,), dtype="<f4",
                             external=[("external.raw", 0, 16),
                                       ("external.raw", 24, 24)])
        with open("external.raw", "wb") as fh:
            fh.write(np.arange(10, dtype="<f4").tobytes())
    return path


def shard_settings(settings):
    """A stand-in for the ``h5py`` module that opens files for writing
    with ``FILE_SETTINGS[settings]`` (h5py's defaults for ``None``)."""
    import h5py

    class Proxy:
        def __getattr__(self, name):
            return getattr(h5py, name)

        @staticmethod
        def File(path, mode="r", **kw):
            if mode != "r":
                kw = {**FILE_SETTINGS.get(settings, {}), **kw}
            return h5py.File(path, mode, **kw)

    return Proxy()


def shard_dataset():
    """One pair-day of the JAX package at 5 Hz: ``init`` + ``process``
    on the CPU, the delay and the pair's distance set for ``pair_snr``."""
    import pandas as pd

    import xcorr_tpu
    ch = xcorr_tpu.stream.Channel
    inv = xcorr_tpu.stream.Inventory([
        ch("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        ch("IM", "H03S2", "", "EDH", latitude=-33.0, longitude=-78.8)])
    chain = [("detrend", {"type": "demean"}),
             ("filter", {"type": "bandpass", "freqmin": 0.3,
                         "freqmax": 2.0}),
             ("taper", {"type": "cosine", "max_percentage": 0.05})]
    ds = xcorr_tpu.init(
        pair=SHARD_PAIR, starttime=pd.Timestamp(SHARD_DAY),
        endtime=pd.Timestamp(SHARD_DAY) + pd.Timedelta("4h"),
        preprocess={"EDH": chain}, sampling_rate=5.0, window_length=3600.0,
        window_overlap=0.5, clip_lag=(0.0, 100.0), inventory=inv,
        attrs={"institution": "fixture", "author": "fixture",
               "source": "synthetic"})
    client = xcorr_tpu.stream.SyntheticClient(
        sampling_rate=5.0, delays={"IM.H03S2..EDH": SHARD_DELAY},
        source_period=600.0, source_amplitude=20.0)
    xcorr_tpu.process(ds, client, verb=0)
    return ds


def write_shard(path, settings="netcdf_c", ds=None):
    """The shard through the JAX package's ``write`` (its ``to_netcdf``
    on h5py), the file opened with ``FILE_SETTINGS[settings]`` (h5py's
    defaults for ``None``)."""
    import xcorr_tpu
    from xcorr_tpu.io import netcdf as jnc
    ds = shard_dataset() if ds is None else ds
    real = jnc.h5py
    jnc.h5py = shard_settings(settings)
    try:
        out = xcorr_tpu.write(ds, str(path), verb=0)
    finally:
        jnc.h5py = real
    if os.path.abspath(out) != os.path.abspath(path):
        os.replace(out, path)
    return path


#: the committed fixtures: name -> writer(path)
FIXTURES = {
    "netcdf_c.nc": write_netcdf_c,
    "single.h5": lambda p: write_index(p, "single"),
    "single_gzip.h5": lambda p: write_index(p, "single", True),
    "implicit.h5": lambda p: write_index(p, "implicit"),
    "fixed_gzip.h5": lambda p: write_index(p, "fixed", True),
    "extensible.h5": lambda p: write_index(p, "extensible"),
    "extensible_paged.h5": lambda p: write_index(p, "extensible_paged"),
    "btree2_gzip.h5": lambda p: write_index(p, "btree2", True),
    "fletcher32.h5": lambda p: write_filter(p, "fletcher32"),
    "lzf.h5": lambda p: write_filter(p, "lzf", "latest"),
    "szip.h5": write_szip,
    "scaleoffset.h5": write_scaleoffset,
    "nbit.h5": write_optional,
    "skipped_filter.h5": lambda p: write_optional(p, 32001),
    "offsets_4_bytes.h5": write_small_offsets,
    "offsets_4_bytes_v3.h5": lambda p: write_small_offsets(p, True),
    "virtual.h5": write_virtual,
    "external_link.h5": write_external_link,
    "external_storage.h5": write_external_storage,
    "region_references.h5": write_region_references,
    "bitfield_opaque.h5": write_bitfield_opaque,
    "null.h5": write_null,
    "shard_netcdf_c.nc": write_shard,
}
SHARD = "shard_netcdf_c.nc"


def shard_snr(path):
    """The port's ``pair_snr`` of the shard on the CPU: ``snr``, ``s``
    and ``n`` per window."""
    import xcorr_tpu_torch
    from xcorr_tpu_torch.scripts.snr import pair_snr
    ds = xcorr_tpu_torch.read(str(path))
    out = pair_snr(ds, celerity=SNR_CELERITY, filter_kwargs=SNR_FILTER,
                   device="cpu")
    return {k: np.asarray(out[k].values, "f8").reshape(-1).tolist()
            for k in ("snr", "s", "n")}


def read_beside(read, out_dir, name, **kw):
    """:func:`tools.hdf5_view.digest_or_raise` of ``read`` on fixture
    ``name``, with ``out_dir`` as the working directory."""
    with contextlib.chdir(out_dir):
        return digest_or_raise(read, name, **kw)


def expected(out_dir):
    """``expected.json``'s content for the files in ``out_dir``."""
    from xcorr_tpu.io import netcdf as jnc
    files = {}
    for name in FIXTURES:
        files[name] = {
            "digest": read_beside(jnc.from_netcdf, out_dir, name),
            "digest_header_only": read_beside(jnc.from_netcdf, out_dir,
                                              name, header_only=True)}
    return {"files": files, "shard": {
        "file": SHARD, "pair": SHARD_PAIR, "day": SHARD_DAY,
        "celerity": SNR_CELERITY, "filter": SNR_FILTER,
        "snr": shard_snr(Path(out_dir) / SHARD)}}


def make(out_dir):
    """Write every fixture and ``expected.json`` into ``out_dir``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, fn in FIXTURES.items():
        fn(str(out_dir / name))
    size = sum((out_dir / n).stat().st_size for n in
               (*FIXTURES, *COMPANIONS))
    if size > MAX_BYTES:
        raise SystemExit(f"fixtures hold {size} bytes, over {MAX_BYTES}")
    exp = expected(out_dir)
    (out_dir / "expected.json").write_text(json.dumps(exp, indent=1) + "\n")
    return exp, size


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    _, size = make(args.out)
    print(f"{len(FIXTURES)} files, {size} bytes, in {args.out}")


if __name__ == "__main__":
    main()
