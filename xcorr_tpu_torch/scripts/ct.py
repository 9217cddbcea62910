r"""
:mod:`scripts.ct` -- Coincidence triggers CLI (``xcorr-torch-ct``)
==================================================================

Merge SNR files, run the coincidence trigger on the SNR characteristic
function, export triggered periods (spec: ``xcorr/scripts/ct.py:28-164``;
port of ``xcorr_tpu/scripts/ct.py``). The trigger runs on the host, as in
the JAX package; the device ``--platform`` names (``cuda`` by default) is
still resolved up front, so a run asked for a missing card raises. The
shard I/O is imported on use. ``--plot`` draws the SNR
series with the triggered periods shaded (matplotlib, on the host).
"""

from __future__ import annotations

import argparse
import glob
import os

from .. import ndlabel
from ..core.process import resolve_device
from ..signal.trigger import coincidence_trigger, trigger_periods
from . import utils

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-ct",
        description="Coincidence triggers from SNR time series "
                    "(PyTorch port).")
    parser.add_argument("snr", metavar="snr", type=str, nargs="+",
                        help="SNR netCDF file(s) or glob(s)")
    parser.add_argument("--threshold", metavar="..", type=float,
                        default=10.0, help="Trigger-on SNR threshold")
    parser.add_argument("--thr-off", metavar="..", type=float, default=None)
    parser.add_argument("--coincidence-sum", metavar="..", type=int,
                        default=None)
    parser.add_argument("--extend", metavar="..", type=int, default=0)
    parser.add_argument("--out", metavar="..", type=str, default=None)
    parser.add_argument("--csv", metavar="..", type=str, default=None,
                        help="Also export triggered periods as CSV")
    utils.add_common_arguments(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    resolve_device(utils.init_compute(args)["device"])
    from .. import io as xio

    paths = []
    for pattern in args.snr:
        paths.extend(sorted(glob.glob(pattern)) or [pattern])
    datasets = [d for d in (xio.read(p, fast=True,
                                     quick_and_dirty=args.quick_and_dirty)
                            for p in paths) if d is not None]
    if not datasets:
        # SNR products may lack pair/time validation context; fall back
        datasets = [xio.from_netcdf(p) for p in paths
                    if os.path.exists(p)]
    if not datasets:
        log.error("no SNR datasets")
        return 1
    ds = datasets[0] if len(datasets) == 1 else \
        ndlabel.combine_by_coords(datasets)

    ct = coincidence_trigger(
        ds["snr"], thr_on=args.threshold, thr_off=args.thr_off,
        thr_coincidence_sum=args.coincidence_sum,
        extend=args.extend, dim="time")
    log.info("%d triggered period(s)", int(ct.attrs["nperiods"]))

    ds["ct"] = ct
    out = args.out or "ct_" + os.path.basename(paths[0])
    if os.path.exists(out) and not args.overwrite:
        log.error("%s exists (use --overwrite)", out)
        return 1
    xio.write(ds, out, verb=1, force_write=True)
    log.info("wrote %s", out)

    if args.csv and int(ct.attrs["nperiods"]) > 0:
        trigger_periods(ct).to_csv(args.csv)
        log.info("wrote %s", args.csv)
    if args.plot:
        import matplotlib.pyplot as plt
        from ..core.plot import plot_snr_ct
        plot_snr_ct(ds["snr"], ct)
        plt.show()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
