r"""
:mod:`scripts.beamform` -- Beamforming CLI (``xcorr-torch-beamform``)
=====================================================================

Per day: merge the array-pair CCF shards, postprocess, estimate the
least-squares plane wave with local aeqd xy coordinates
(spec: ``xcorr/scripts/beamform.py:33-104``; port of
``xcorr_tpu/scripts/beamform.py``).

The chain and the co-array correlations run on the torch device that
``--platform`` names (``cuda`` by default, raising without a card).
:func:`beamform_datasets` is the computation on datasets in memory, for
callers that hold their CCFs without shards. The shard I/O is imported on
use.
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
from ..ndlabel import DataArray
from ..signal.beamform import plane_wave_estimate
from ..util.receiver import get_pair_xy_coordinates, split_pair
from . import utils

__all__ = ["beamform_datasets", "beamform_day", "main"]


def beamform_datasets(datasets, inventory, clim=(1460.0, 1500.0),
                      envelope: bool = False, attrs: dict = None,
                      filter_kwargs: dict = None, device="cuda"):
    """Plane-wave estimate from one day's array-pair CCF datasets, or None
    when fewer than three pairs have data after postprocess.

    The receiver array is formed by whichever side of the pairs *varies*
    (the other side is the common reference, e.g. the distant source
    station); co-array lags come from the pair CCFs.
    """
    kept = []
    for ds in datasets:
        try:
            ds = postprocess(ds, clim=clim, filter_kwargs=filter_kwargs,
                             device=device)
        except ValueError:
            continue
        kept.append(ds)
    if len(kept) < 3:
        return None
    merged = ndlabel.concat(kept, "pair")

    # local aeqd xy of the array receivers (meters; the varying side)
    pair_strs = [str(p) for p in merged.coords["pair"].values]
    firsts = [split_pair(p)[0] for p in pair_strs]
    seconds = [split_pair(p)[1] for p in pair_strs]
    arr = firsts if len(set(firsts)) > len(set(seconds)) else seconds
    receivers, x_km, y_km = get_pair_xy_coordinates(
        pair_strs, inventory, km=True)
    idx = [receivers.index(r) for r in arr]
    x = DataArray(np.asarray(x_km)[idx] * 1e3, dims=("pair",),
                  name="x")
    y = DataArray(np.asarray(y_km)[idx] * 1e3, dims=("pair",),
                  name="y")
    x._coords = {"pair": merged.coords["pair"]}
    y._coords = {"pair": merged.coords["pair"]}

    return plane_wave_estimate(merged["cc"], x, y, dim="lag",
                               envelope=envelope, device=device,
                               **(attrs or {}))


def beamform_day(pairs, day, root, inventory, clim=(1460.0, 1500.0),
                 envelope: bool = False, attrs: dict = None,
                 filter_kwargs: dict = None, device="cuda"):
    """:func:`beamform_datasets` of one day's shards under ``root``."""
    from .. import io as xio
    from ..io.filesystem import ncfile

    datasets = []
    for pair in pairs:
        nc = ncfile(pair, day, root)
        if not os.path.exists(nc):
            continue
        ds = xio.read(nc, fast=True)
        if ds is not None:
            datasets.append(ds)
    return beamform_datasets(datasets, inventory, clim=clim,
                             envelope=envelope, attrs=attrs,
                             filter_kwargs=filter_kwargs, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-beamform",
        description="Plane-wave beamforming across a CCF receiver array "
                    "(PyTorch port).")
    parser.add_argument("start", metavar="start", type=str)
    parser.add_argument("end", metavar="end", type=str)
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        required=True, help="Array pair (repeat >= 3x)")
    parser.add_argument("--inventory", metavar="..", type=str,
                        required=True, help="Inventory JSON")
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--envelope", action="store_true", default=False)
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
    from .. import io as xio
    from ..stream import Inventory

    inventory = Inventory.from_json(args.inventory)
    days = pd.date_range(args.start, args.end, freq="1D")

    with ThreadPoolExecutor(max_workers=cfg["nworkers"]) as ex:
        results = list(ex.map(
            lambda d: beamform_day(args.pair, d, args.root, inventory,
                                   clim=tuple(args.celerity),
                                   envelope=args.envelope, attrs=attrs,
                                   filter_kwargs={
                                       "frequency": args.filter_freq,
                                       "btype": "highpass", "order": 2},
                                   device=device),
            days))
    keep = [r for r in results if r is not None]
    if not keep:
        log.error("no beamform results")
        return 1
    # concat along the existing time dim: each day's result carries its
    # per-window timestamps
    merged = ndlabel.concat(keep, "time")
    out = args.out or utils.ncfile_name(
        (args.prefix or "") + "beamform", days[0], days[-1], args.suffix)
    if os.path.exists(out) and not args.overwrite:
        log.error("%s exists (use --overwrite)", out)
        return 1
    xio.write(merged, out, verb=1, force_write=True)
    log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
