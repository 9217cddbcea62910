"""HDF5 files in the newer file format, and what the JAX package reads
from them: the fixtures of the port's HDF5 codec.

    python3 tools/make_hdf5_fixtures.py [--out tests/fixtures_torch/hdf5]

Writes, with h5py, one small file per structure that
``xcorr_tpu_torch/io/hdf5_v2.py`` reads (netCDF-C's layout, each
version-4 chunk index, fletcher32, lzf) and a small xcorr shard that the
JAX package's ``to_netcdf`` wrote under netCDF-C's file settings; then
``expected.json``: the sha256 of each file's view as
``xcorr_tpu.io.netcdf.from_netcdf`` reads it (with and without
``header_only``), and the port's ``pair_snr`` of the shard on the CPU.
Needs h5py and the JAX package, which the writers import in their
bodies; ``tests/test_torch_hdf5_v2.py`` imports the writers from here.
The views and their digests are in ``tools/hdf5_view.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.hdf5_view import digest  # noqa: E402

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


def expected(out_dir):
    """``expected.json``'s content for the files in ``out_dir``."""
    from xcorr_tpu.io import netcdf as jnc
    files = {}
    for name in FIXTURES:
        path = str(Path(out_dir) / name)
        files[name] = {"digest": digest(jnc.from_netcdf(path)),
                       "digest_header_only": digest(
                           jnc.from_netcdf(path, header_only=True))}
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
    size = sum((out_dir / n).stat().st_size for n in FIXTURES)
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
