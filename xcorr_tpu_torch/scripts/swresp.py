r"""
:mod:`scripts.swresp` -- Surface-wave response CLI (``xcorr-torch-swresp``)
===========================================================================

Vertical/radial CC pair -> rfft cross-spectrum ``Y_R * conj(Y_Z)`` ->
amplitude ratio and phase = the surface-wave response
(spec: ``xcorr/scripts/swresp.py:77-90``; port of
``xcorr_tpu/scripts/swresp.py``).

The chain and the transforms run on the torch device that ``--platform``
names (``cuda`` by default, raising without a card); the ratio and phase
on the host. :func:`swresp_datasets` is the computation on datasets in
memory. The shard I/O is imported on use.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from .. import ndlabel
from ..core.postprocess import postprocess
from ..core.process import resolve_device
from ..ndlabel import DataArray, Dataset
from ..signal.fft import rfft as signal_rfft
from . import utils

__all__ = ["swresp_datasets", "swresp_day", "main"]


def swresp_datasets(ds_z, ds_r, clim=(1460.0, 1500.0), attrs: dict = None,
                    filter_kwargs: dict = None, device="cuda"):
    """Surface-wave response (amplitude ratio + phase) of one day's
    vertical and radial CCF datasets, or None when postprocess leaves no
    data in either (its ``ValueError``)."""
    out = {}
    for key, ds in (("Z", ds_z), ("R", ds_r)):
        try:
            out[key] = postprocess(ds, clim=clim,
                                   filter_kwargs=filter_kwargs,
                                   device=device)
        except ValueError:
            return None
    # align lag windows (they can differ by a sample after clipping)
    nz = out["Z"].dims["lag"]
    nr = out["R"].dims["lag"]
    n = min(nz, nr)
    ccz = out["Z"]["cc"].isel(lag=slice(0, n))
    ccr = out["R"]["cc"].isel(lag=slice(0, n))
    # also align times (both days should have the same windows)
    nt = min(ccz.sizes["time"], ccr.sizes["time"])
    ccz = ccz.isel(time=slice(0, nt)).squeeze("pair")
    ccr = ccr.isel(time=slice(0, nt)).squeeze("pair")

    Yz = signal_rfft(ccz, dim="lag", device=device)
    # the R spectrum must use Z's freq grid: same n, same delta -> it does
    Yr = signal_rfft(ccr.copy(deep=False), dim="lag", device=device)

    cross = Yr.values * np.conj(Yz.values)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.abs(Yr.values) / np.where(np.abs(Yz.values) > 0,
                                             np.abs(Yz.values), np.inf)
    phase = np.angle(cross)

    ds = Dataset(attrs={
        "title": "Surface-wave response",
        **(attrs or {}),
    })
    ds.coords["time"] = ccz.coords["time"]
    ds.coords["freq"] = Yz.coords["freq"]
    ds["ratio"] = DataArray(ratio, dims=("time", "freq"), name="ratio",
                            attrs={"long_name": "R/Z amplitude ratio",
                                   "units": "-"})
    ds["phase"] = DataArray(phase, dims=("time", "freq"), name="phase",
                            attrs={"long_name": "R-Z cross-spectral phase",
                                   "units": "rad"})
    return ds


def swresp_day(pair_z, pair_r, day, root, clim=(1460.0, 1500.0),
               attrs: dict = None, filter_kwargs: dict = None,
               device="cuda"):
    """:func:`swresp_datasets` of one day's Z and R shards under ``root``,
    or None when either is missing."""
    from .. import io as xio
    from ..io.filesystem import ncfile

    datasets = []
    for pair in (pair_z, pair_r):
        nc = ncfile(pair, day, root)
        if not os.path.exists(nc):
            return None
        ds = xio.read(nc, fast=True)
        if ds is None:
            return None
        datasets.append(ds)
    return swresp_datasets(*datasets, clim=clim, attrs=attrs,
                           filter_kwargs=filter_kwargs, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-swresp",
        description="Surface-wave response from vertical/radial CC pairs "
                    "(PyTorch port).")
    parser.add_argument("start", metavar="start", type=str)
    parser.add_argument("end", metavar="end", type=str)
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair-z", metavar="..", type=str, required=True,
                        help="Vertical-component pair (…BHZ)")
    parser.add_argument("--pair-r", metavar="..", type=str, required=True,
                        help="Radial-component pair (…BHR)")
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--filter-freq", metavar="..", type=float,
                        default=3.0,
                        help="Postprocess highpass corner (Hz)")
    parser.add_argument("--out", metavar="..", type=str, default=None)
    utils.add_common_arguments(parser)
    utils.add_attrs_group(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    cfg = utils.init_compute(args)
    device = resolve_device(cfg["device"])
    attrs = utils.parse_attrs(args)

    days = pd.date_range(args.start, args.end, freq="1D")
    with ThreadPoolExecutor(max_workers=cfg["nworkers"]) as ex:
        results = list(ex.map(
            lambda d: swresp_day(args.pair_z, args.pair_r, d, args.root,
                                 clim=tuple(args.celerity), attrs=attrs,
                                 filter_kwargs={
                                     "frequency": args.filter_freq,
                                     "btype": "highpass", "order": 2},
                                 device=device),
            days))
    results = [r for r in results if r is not None]
    if not results:
        log.error("no swresp results")
        return 1
    merged = results[0] if len(results) == 1 else \
        ndlabel.combine_by_coords(results)
    out = args.out or utils.ncfile_name(
        (args.prefix or "") + "swresp", days[0], days[-1], args.suffix)
    if os.path.exists(out) and not args.overwrite:
        log.error("%s exists (use --overwrite)", out)
        return 1
    from .. import io as xio
    xio.write(merged, out, verb=1, force_write=True)
    log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
