"""Read seconds of a production-size shard in each HDF5 layout, through
the port's codec and through h5py.

    python3 tools/hdf5_read_times.py [--reps 3] [--out DIR]

Makes one pair-day shard at the production geometry of
``xcorr_tpu/scripts/cc.py`` (50 Hz, 24 h windows every 3 h, lags 0-9 h:
``cc`` of (1, 8, 1,620,001) float32, shuffle + deflate level 1, one
chunk per window) with seeded noise in ``cc``, and writes it four ways:
the JAX package's ``write`` (h5py) with h5py's defaults, with netCDF-C's
file settings and with ``libver="latest"``, and the port's own writer.
Each file is read ``--reps`` times by ``xcorr_tpu_torch.io.netcdf.
from_netcdf`` (the codec) and ``xcorr_tpu.io.netcdf.from_netcdf`` (h5py);
the median seconds are printed beside the file's superblock version, its
``cc`` chunk index (and the codec's walk of it, in ms) and whether the
codec decompressed in threads. Then a copy of ``cc`` through h5py's lzf
filter (with shuffle) is read by the codec (its native decoder, then
its plain Python one) and by h5py. Needs h5py and the JAX package;
about 1 GB of memory and a minute.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools import make_hdf5_fixtures as mf  # noqa: E402

PAIR = "IM.H03S1..EDH-IM.H03S2..EDH"


def production_dataset():
    """The JAX package's ``init`` at the production geometry, ``cc``
    filled with seeded noise and every status 1."""
    import pandas as pd

    import xcorr_tpu
    ds = xcorr_tpu.init(
        pair=PAIR, starttime=pd.Timestamp("2014-02-01"),
        endtime=pd.Timestamp("2014-02-02"), sampling_rate=50.0,
        window_length=86400.0, window_overlap=21.0 / 24.0,
        clip_lag=(0.0, 9 * 3600.0),
        preprocess={"EDH": [("detrend", {"type": "demean"})]},
        attrs={"institution": "x", "author": "x", "source": "x"})
    rng = np.random.default_rng(20140201)
    ds["cc"].values[...] = rng.normal(
        scale=1e-2, size=ds["cc"].shape).astype(ds["cc"].dtype)
    ds["status"].values[...] = 1
    return ds


def layout(path):
    """Superblock version, ``cc``'s chunk index, its chunk count, the
    seconds of the codec's walk of it, and whether the codec reads
    ``cc`` in threads."""
    from xcorr_tpu_torch.io import hdf5
    with hdf5.File(path) as f:
        sb = f._b[f._base + 8]
        cc = f["cc"]
        kind = cc._layout[2][0] if cc.chunks else None
        names = {0: "v1 B-tree", 1: "single chunk", 2: "implicit",
                 3: "fixed array", 4: "extensible array", 5: "v2 B-tree"}
        t0 = time.perf_counter()
        found = cc._chunks()
        walk = time.perf_counter() - t0
        threaded = (sum(n for n, _, _, _ in found) >= hdf5._PARALLEL_READ_MIN
                    and len(found) > 1)
        return sb, names.get(kind), len(found), walk, threaded


def median_s(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import h5py

    import xcorr_tpu_torch
    from xcorr_tpu.io import netcdf as jnc
    from xcorr_tpu_torch.io import netcdf as tnc
    tmp = tempfile.TemporaryDirectory(dir=args.out)
    ds = production_dataset()
    cc = ds["cc"].values
    print(f"cc {cc.shape} {cc.dtype}, {cc.nbytes} bytes")
    paths = {}
    for name, settings in (("h5py default", None), ("netcdf_c", "netcdf_c"),
                           ("latest", "latest")):
        path = os.path.join(tmp.name, f"{name.replace(' ', '_')}.nc")
        paths[name] = mf.write_shard(path, settings, ds=ds)
    path = os.path.join(tmp.name, "port.nc")
    tnc.to_netcdf(tnc.from_netcdf(paths["h5py default"]), path)
    paths["port writer"] = path
    for name, path in paths.items():
        assert xcorr_tpu_torch.read(path) is not None, name
        sb, index, nchunks, walk, threaded = layout(path)
        port = median_s(lambda: tnc.from_netcdf(path), args.reps)
        ref = median_s(lambda: jnc.from_netcdf(path), args.reps)
        print(f"{name}: superblock {sb}, cc index {index} ({nchunks} "
              f"chunks, walked in {walk * 1e3:.3f} ms, threaded "
              f"{threaded}), {os.path.getsize(path)} bytes; read s: codec "
              f"{port:.4f}, h5py {ref:.4f}")
    # lzf: the same cc through h5py's lzf filter
    from xcorr_tpu_torch.io import hdf5, hdf5_filters
    path = os.path.join(tmp.name, "lzf.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("cc", data=cc, chunks=(1, 1, cc.shape[-1]),
                         compression="lzf", shuffle=True)

    def codec():
        with hdf5.File(path) as f:
            return f["cc"][...]

    def ref():
        with h5py.File(path, "r") as f:
            return f["cc"][...]

    np.testing.assert_array_equal(codec(), cc)
    native_s = median_s(codec, args.reps)
    # the Python decoder, the native one's plain form
    native = hdf5_filters.unlzf
    hdf5_filters.unlzf = hdf5_filters.unlzf_plain
    try:
        plain_s = median_s(codec, args.reps)
    finally:
        hdf5_filters.unlzf = native
    print(f"lzf + shuffle cc, {os.path.getsize(path)} bytes: read s: "
          f"codec {native_s:.4f}, codec with the plain decoder "
          f"{plain_s:.4f}, h5py {median_s(ref, args.reps):.4f}")
    tmp.cleanup()


if __name__ == "__main__":
    main()
