r"""
:mod:`scripts.snr` -- SNR estimation CLI (``xcorr-torch-snr``)
==============================================================

Per day: read each pair's CCF shard, run the postprocess chain, build
signal/noise lag masks (hydroacoustic celerity window vs late-lag noise),
estimate SNR, concatenate over pairs and days, write one netCDF
(spec: ``xcorr/scripts/snr.py:32-224``; port of ``xcorr_tpu/scripts/snr.py``).

The chain and the envelope run on the torch device that ``--platform``
names (``cuda`` by default, raising without a card). :func:`pair_snr` is
the per-pair computation on a dataset in memory, for callers that hold
their CCFs without shards. The shard I/O is imported on use.
``--plot`` draws the SNR series with matplotlib on the host.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import pandas as pd

from .. import ndlabel
from ..core.postprocess import postprocess
from ..core.process import resolve_device
from ..signal.snr import snr as signal_snr
from . import utils

__all__ = ["pair_snr", "estimate_snr_for_day", "main"]


def pair_snr(ds, celerity=(1460.0, 1500.0),
             noise_lag=(6 * 3600.0, 9 * 3600.0), envelope: bool = True,
             attrs: dict = None, filter_kwargs: dict = None, device="cuda",
             **kwargs):
    """SNR dataset of one pair's CCF dataset, or None when postprocess
    leaves no data (its ``ValueError``), as
    ``xcorr_tpu.scripts.snr.estimate_snr_for_day`` does per pair."""
    try:
        ds = postprocess(ds, clim=(celerity[0], celerity[1]),
                         filter_kwargs=filter_kwargs, device=device, **kwargs)
    except ValueError:
        return None
    cc = ds["cc"]
    lag = cc.coords["lag"]
    d = float(ds["distance"].values.max()) * 1000.0  # m
    sigm = (lag >= d / celerity[1]) & (lag <= d / celerity[0])
    noim = (lag >= noise_lag[0]) & (lag <= noise_lag[1])
    if not noim.values.any():
        # postprocess clipped the noise band away: use the last 20%
        nl = lag.values
        noim = lag >= nl[int(0.8 * nl.size)]
    return signal_snr(cc, sigm, noim, dim="lag", extend=True,
                      envelope=envelope, device=device, **(attrs or {}))


def estimate_snr_for_day(pairs, day, root, celerity=(1460.0, 1500.0),
                         noise_lag=(6 * 3600.0, 9 * 3600.0),
                         envelope: bool = True, attrs: dict = None,
                         filter_kwargs: dict = None, device="cuda",
                         **kwargs):
    """SNR dataset for all pairs of one day (reference
    ``scripts/snr.py:32-83``)."""
    from .. import io as xio
    from ..io.filesystem import ncfile

    out = []
    for pair in pairs:
        nc = ncfile(pair, day, root)
        if not os.path.exists(nc):
            continue
        ds = xio.read(nc, fast=True)
        if ds is None:
            continue
        sn = pair_snr(ds, celerity=celerity, noise_lag=noise_lag,
                      envelope=envelope, attrs=attrs,
                      filter_kwargs=filter_kwargs, device=device, **kwargs)
        if sn is not None:
            out.append(sn)
    if not out:
        return None
    return ndlabel.concat(out, "pair") if len(out) > 1 else out[0]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-snr",
        description="Signal-to-noise ratio estimation of daily CCFs "
                    "(PyTorch port).")
    parser.add_argument("start", metavar="start", type=str,
                        help="Start date")
    parser.add_argument("end", metavar="end", type=str, help="End date")
    parser.add_argument("--root", metavar="..", type=str, default="data/cc",
                        help="CCF shard root")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        default=None,
                        help="Receiver pair (repeatable); default: scan "
                             "the archive tree")
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0),
                        help="Signal celerity window (m/s)")
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

    pairs = args.pair
    if not pairs:
        pairs = sorted({
            d for year in os.listdir(args.root)
            if os.path.isdir(os.path.join(args.root, year))
            for d in os.listdir(os.path.join(args.root, year))
        }) if os.path.isdir(args.root) else []
    if not pairs:
        log.error("no pairs found under %s", args.root)
        return 1

    days = pd.date_range(args.start, args.end, freq="1D")
    log.info("SNR for %d pairs x %d days on %s", len(pairs), len(days),
             device)

    with ThreadPoolExecutor(max_workers=cfg["nworkers"]) as ex:
        results = list(ex.map(
            lambda day: estimate_snr_for_day(
                pairs, day, args.root, celerity=tuple(args.celerity),
                attrs=attrs,
                filter_kwargs={"frequency": args.filter_freq,
                               "btype": "highpass", "order": 2},
                device=device),
            days))
    results = [r for r in results if r is not None]
    if not results:
        log.error("no SNR results")
        return 1

    snr_ds = results[0] if len(results) == 1 else \
        ndlabel.combine_by_coords(results)
    out = args.out or utils.ncfile_name(
        (args.prefix or "") + "snr", days[0], days[-1], args.suffix)
    if os.path.exists(out) and not args.overwrite:
        log.error("%s exists (use --overwrite)", out)
        return 1
    from .. import io as xio
    xio.write(snr_ds, out, verb=1, force_write=True)
    log.info("wrote %s", out)
    if args.plot:
        _plot(snr_ds)
    return 0


def _plot(snr_ds):
    import matplotlib.pyplot as plt
    from ..core.plot import plot_snr_ct
    plot_snr_ct(snr_ds["snr"])
    plt.show()


if __name__ == "__main__":
    raise SystemExit(main())
