r"""
:mod:`scripts.timelapse` -- Timelapse CLI (``xcorr-torch-timelapse``)
=====================================================================

Cross-correlate the spectrograms of every triggered-time pair on the
(time1, time2) plane, per frequency band
(spec: ``xcorr/scripts/timelapse.py:35-467``; port of
``xcorr_tpu/scripts/timelapse.py``).

All T spectrograms of a pair are computed once
(:func:`pair_spectrograms`, on datasets in memory), then the
upper-triangle cells are 2-D-correlated in batches on the torch device
that ``--platform`` names (:func:`correlate_spectrograms`; ``cuda`` by
default, raising without a card), or with ``mesh=`` each batch split
over a mesh's devices (SURVEY.md §2.8 P2). The shard I/O is imported on
use (it needs h5py).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd
import torch

from .. import ops
from ..core.postprocess import postprocess
from ..core.process import resolve_device
from ..ndlabel import Dataset
from ..signal.spectrogram import spectrogram
from ..util.convert import to_device, to_numpy
from ..util.metadata import global_attrs
from . import utils

__all__ = ["init_timelapse", "correlate_spectrograms", "pair_spectrograms",
           "timelapse", "main"]


def init_timelapse(pair, times, freq_bands, attrs: dict = None):
    """The (pair, freq, time1, time2) result dataset
    (reference ``scripts/timelapse.py:35-139``)."""
    ds = Dataset()
    ds.attrs = global_attrs({
        "title": "Timelapse 2-D spectrogram cross-correlation",
        **(attrs or {}),
    })
    pair = np.atleast_1d(np.asarray(pair, dtype=object))
    ds.coords["pair"] = pair
    fb = np.asarray(freq_bands, dtype=np.float64)
    ds.coords["freq"] = fb.mean(axis=1)
    ds.coords["freq"].attrs = {"long_name": "Center frequency",
                               "units": "s-1"}
    ds["freq_bw"] = (("freq",), fb[:, 1] - fb[:, 0],
                     {"long_name": "Frequency bandwidth", "units": "s-1"})
    t = np.asarray(times)
    ds.coords["time1"] = t
    ds.coords["time2"] = t.copy()
    shape = (pair.size, fb.shape[0], t.size, t.size)
    ds["cc2"] = (("pair", "freq", "time1", "time2"),
                 np.full(shape, np.nan, dtype=np.float32),
                 {"long_name": "2-D cross-correlation peak", "units": "-"})
    ds["delta_freq"] = (("pair", "freq", "time1", "time2"),
                        np.full(shape, np.nan, dtype=np.float32),
                        {"long_name": "Frequency shift at peak",
                         "units": "s-1"})
    ds["delta_lag"] = (("pair", "freq", "time1", "time2"),
                       np.full(shape, np.nan, dtype=np.float32),
                       {"long_name": "Lag shift at peak", "units": "s"})
    ds["status"] = (("pair", "freq", "time1", "time2"),
                    np.zeros(shape, dtype=np.int8),
                    {"long_name": "processing status"})
    return ds


def _normed(a):
    """Frobenius-normalize over the trailing two axes."""
    n = torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))
    return a / torch.where(n == 0, torch.ones_like(n), n)


def _cell_peaks(sp, ii, jj):
    """Peaks and flat argmaxes of the normalized 2-D correlations of the
    cells ``(ii, jj)`` of the stack ``sp``, on ``sp``'s device."""
    n1, n2 = sp.shape[-2], sp.shape[-1]
    nf = ops.fft.next_fast_len(2 * n1 - 1)
    nl = ops.fft.next_fast_len(2 * n2 - 1)
    a = _normed(sp[ii])
    b = _normed(sp[jj])
    A = torch.fft.rfft2(a, s=(nf, nl))
    B = torch.fft.rfft2(b, s=(nf, nl))
    r = torch.fft.irfft2(A * torch.conj(B), s=(nf, nl))
    # fftshift both axes to linear lags
    r = ops.cc.lag_slice_of_circular(r.movedim(-2, -1), n1, nf, 0,
                                     2 * n1 - 1).movedim(-1, -2)
    r = ops.cc.lag_slice_of_circular(r, n2, nl, 0, 2 * n2 - 1)
    flat = r.reshape(r.shape[0], -1)
    k = torch.argmax(flat, dim=-1)
    return torch.gather(flat, -1, k[:, None])[:, 0], k


def correlate_spectrograms(specs, i_idx, j_idx, batch: int = 64,
                           mesh=None, device="cuda"):
    """Batched normalized 2-D correlation peaks between spectrogram pairs,
    on ``device`` (``'cuda'`` by default, which raises without a card).

    specs: (T, F, L) stack; (i_idx, j_idx): cell index lists.
    Returns (peak, df_shift, dl_shift) arrays of len(cells), where the
    shifts are argmax offsets in bins relative to zero lag. Each batch
    gathers both spectrograms of ``batch`` cells, normalizes them,
    correlates them through ``rfft2``/``irfft2`` at the port's
    cuFFT-fast lengths and takes the flat argmax; the last batch runs at
    its own size.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`, in place of ``device``):
    the stack goes to each of its devices, ``batch`` is rounded to a
    multiple of its size, as the JAX package rounds it, and each batch
    splits into contiguous shares, one per entry, each run on the
    entry's device; the results come back in cell order.
    """
    if mesh is None:
        devices = (resolve_device(device),)
    else:
        from ..parallel.mesh import split
        devices = tuple(resolve_device(d) for d in mesh.devices)
        batch = max(batch, mesh.size) // mesh.size * mesh.size
    uniq = tuple(dict.fromkeys(devices))
    stacks = {d: to_device(specs, d) for d in uniq}
    ii = np.asarray(i_idx, dtype=np.int64)
    jj = np.asarray(j_idx, dtype=np.int64)
    cells = {d: (to_device(ii, d), to_device(jj, d)) for d in uniq}
    n1, n2 = stacks[devices[0]].shape[-2:]
    w = 2 * n2 - 1
    ncells = ii.shape[0]
    # each device's outputs hold the cells its entries ran
    peaks = {d: torch.empty(ncells, dtype=stacks[d].dtype, device=d)
             for d in uniq}
    am = {d: torch.empty(ncells, dtype=torch.int64, device=d)
          for d in uniq}
    owner = np.zeros(ncells, dtype=np.intp)   # index into uniq
    for s in range(0, ncells, batch):
        rows = min(batch, ncells - s)
        parts = [(devices[0], 0, rows)] if mesh is None else \
            split(mesh, rows)
        for d, a, b in parts:
            rs = slice(s + a, s + b)
            peaks[d][rs], am[d][rs] = _cell_peaks(
                stacks[d], cells[d][0][rs], cells[d][1][rs])
            owner[rs] = uniq.index(d)
    if len(uniq) == 1:
        pk_host = to_numpy(peaks[uniq[0]]).astype(np.float32)
        am_host = to_numpy(am[uniq[0]])
    else:
        pk_host = np.empty(ncells, dtype=np.float32)
        am_host = np.empty(ncells, dtype=np.int64)
        for k, d in enumerate(uniq):
            mine = owner == k
            pk_host[mine] = to_numpy(peaks[d])[mine]
            am_host[mine] = to_numpy(am[d])[mine]
    return (pk_host,
            (am_host // w - (n1 - 1)).astype(np.int32),
            (am_host % w - (n2 - 1)).astype(np.int32))


def pair_spectrograms(datasets, times, clim=(1460.0, 1500.0),
                      duration: float = 2.5, padding_factor: int = 4,
                      filter_kwargs: dict = None, device="cuda"):
    """The spectrogram cache of one pair: ``(specs, freq)``.

    ``datasets`` yields one CCF dataset (or None) per entry of ``times``;
    each is postprocessed and the spectrogram of its window nearest to the
    time is kept as a float32 ``(freq, lag)`` array, trimmed to the first
    one's lag size; None where there is no dataset or postprocess leaves
    no data. ``freq`` is the spectrograms' frequency coordinate (None when
    none was made).
    """
    specs = []
    freq_coord = None
    lag_size = None
    for t, shard in zip(times, datasets):
        if shard is None:
            specs.append(None)
            continue
        try:
            shard = postprocess(shard, clim=clim,
                                filter_kwargs=filter_kwargs, device=device)
        except ValueError:
            specs.append(None)
            continue
        cc = shard["cc"]
        # nearest window to the triggered time
        tv = pd.DatetimeIndex(cc.coords["time"].values)
        k = int(np.argmin(np.abs(tv - t)))
        one = cc.isel(time=k).squeeze("pair")
        psd = spectrogram(one, duration=duration,
                          padding_factor=padding_factor, device=device)
        if freq_coord is None:
            freq_coord = psd.coords["freq"].values
            lag_size = psd.sizes["lag"]
        if psd.sizes["lag"] != lag_size:
            psd = psd.isel(lag=slice(0, lag_size))
        specs.append(np.asarray(psd.values, dtype=np.float32))
    return specs, freq_coord


def _read_shards(pair, times, root):
    """One shard (or None) per time, read as they are iterated."""
    from .. import io as xio
    from ..io.filesystem import ncfile
    for t in times:
        nc = ncfile(pair, t, root)
        yield xio.read(nc, fast=True) if os.path.exists(nc) else None


def timelapse(pairs, times, root, freq_bands=((3.0, 6.0), (6.0, 12.0)),
              clim=(1460.0, 1500.0), duration: float = 2.5,
              padding_factor: int = 4, attrs: dict = None,
              batch: int = 64, filter_kwargs: dict = None,
              mesh=None, verb: int = 1, device="cuda"):
    """Full timelapse computation for the given triggered times, from the
    shards under ``root``, on ``device``; with ``mesh``, the cells of each
    (pair, band) split over the mesh (:func:`correlate_spectrograms`)."""
    device = resolve_device(device)
    times = pd.DatetimeIndex(np.asarray(times))
    ds = init_timelapse(list(pairs), times.values, freq_bands, attrs)
    iu, ju = np.triu_indices(len(times))

    for ip, pair in enumerate(pairs):
        # load + postprocess + spectrogram ONCE per triggered time
        specs, freq_coord = pair_spectrograms(
            _read_shards(pair, times, root), times, clim=clim,
            duration=duration, padding_factor=padding_factor,
            filter_kwargs=filter_kwargs, device=device)
        valid = [i for i, s in enumerate(specs) if s is not None]
        if len(valid) < 2:
            continue
        if verb:
            print(f"{pair}: {len(valid)} spectrograms cached")

        for ifb, (f0, f1) in enumerate(freq_bands):
            sel = (freq_coord >= f0) & (freq_coord <= f1)
            if not sel.any():
                continue
            stack = np.stack([specs[i][sel] for i in valid])
            cells = [(a, b) for a, b in zip(iu, ju)
                     if a in valid and b in valid]
            if not cells:
                continue
            vmap = {v: k for k, v in enumerate(valid)}
            ii = [vmap[a] for a, b in cells]
            jj = [vmap[b] for a, b in cells]
            peaks, dfs, dls = correlate_spectrograms(stack, ii, jj,
                                                     batch=batch, mesh=mesh,
                                                     device=device)
            for (a, b), pk, df_, dl_ in zip(cells, peaks, dfs, dls):
                ds["cc2"].values[ip, ifb, a, b] = pk
                ds["delta_freq"].values[ip, ifb, a, b] = df_
                ds["delta_lag"].values[ip, ifb, a, b] = dl_
                ds["status"].values[ip, ifb, a, b] = 1
            if verb:
                print(f"  band {f0}-{f1} Hz: {len(cells)} cells")

    # mirror the lower triangle (cc2 symmetric; shifts antisymmetric)
    for name, sign in (("cc2", 1), ("delta_freq", -1), ("delta_lag", -1),
                       ("status", 1)):
        v = ds[name].values
        ds[name].values[:] = np.where(
            np.isnan(v) if v.dtype.kind == "f" else (v == 0),
            sign * np.swapaxes(v, -1, -2), v)
    return ds


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-timelapse",
        description="2-D CC of CCF spectrograms on the (time1,time2) "
                    "plane (PyTorch port).")
    parser.add_argument("ct", metavar="ct", type=str,
                        help="Coincidence-trigger netCDF (xcorr-torch-ct), "
                             "or 'all' with --start/--end for every day")
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        required=True)
    parser.add_argument("--start", metavar="..", type=str, default=None)
    parser.add_argument("--end", metavar="..", type=str, default=None)
    parser.add_argument("--freq", metavar="..", type=float, nargs=2,
                        action="append", default=None,
                        help="Frequency band (repeatable)")
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--filter-freq", metavar="..", type=float,
                        default=3.0,
                        help="Postprocess highpass corner (Hz)")
    parser.add_argument("--duration", metavar="..", type=float,
                        default=2.5, help="Spectrogram segment length (s)")
    parser.add_argument("--out", metavar="..", type=str, default=None)
    parser.add_argument("--init", action="store_true", default=False,
                        help="Only initialize the (time1,time2) dataset")
    parser.add_argument("--update", metavar="..", type=str, default=None,
                        help="Resume/extend an existing timelapse netCDF")
    utils.add_common_arguments(parser)
    utils.add_attrs_group(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    device = resolve_device(utils.init_compute(args)["device"])
    attrs = utils.parse_attrs(args)
    from .. import io as xio

    if args.ct == "all":
        times = pd.date_range(args.start, args.end, freq="1D")
    else:
        ct_ds = xio.read(args.ct, fast=True) or xio.from_netcdf(args.ct)
        trig = ct_ds["ct"].values
        tvals = pd.DatetimeIndex(ct_ds.coords["time"].values)
        times = tvals[~np.isnan(np.asarray(trig, dtype=float))]
        times = pd.DatetimeIndex(sorted(set(times.normalize())))
    freq_bands = args.freq or [(3.0, 6.0), (6.0, 12.0)]
    log.info("timelapse: %d pairs x %d times x %d bands on %s",
             len(args.pair), len(times), len(freq_bands), device)

    if args.init:
        ds = init_timelapse(args.pair, times.values, freq_bands, attrs)
    else:
        ds = timelapse(args.pair, times, args.root, freq_bands=freq_bands,
                       clim=tuple(args.celerity), attrs=attrs,
                       duration=args.duration,
                       filter_kwargs={"frequency": args.filter_freq,
                                      "btype": "highpass", "order": 2},
                       device=device)
        if args.update and os.path.exists(args.update):
            from ..ndlabel import combine_by_coords
            old = xio.read(args.update, fast=True) or \
                xio.from_netcdf(args.update)
            ds = combine_by_coords([old, ds])

    out = args.out or utils.ncfile_name(
        (args.prefix or "") + "timelapse", times[0], times[-1],
        args.suffix)
    if os.path.exists(out) and not args.overwrite and not args.update:
        log.error("%s exists (use --overwrite)", out)
        return 1
    xio.write(ds, out, verb=1, force_write=True)
    log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
