r"""
:mod:`scripts.psd` -- PSD spectrograms of triggered periods
===========================================================

The ``xcorr-torch-psd`` console script.

For each triggered period x pair: read the CCF shards, postprocess with a
celerity window, compute the per-sample-hop PSD spectrogram, combine with
the SNR values and write one netCDF per period
(spec: ``xcorr/scripts/psd.py:42-100``; port of ``xcorr_tpu/scripts/psd.py``).

The chain and the spectrogram run on the torch device that ``--platform``
names (``cuda`` by default, raising without a card). :func:`pair_psd` is
the per-pair computation on a dataset in memory. The shard I/O is
imported on use. ``--plot`` is accepted and draws
nothing, as in the JAX package.
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
from ..signal.spectrogram import spectrogram
from ..signal.trigger import trigger_periods
from . import utils

__all__ = ["pair_psd", "psd_of_period", "iter_pair_psd", "period_ncfile",
           "main"]


def pair_psd(ds, pair, start, end, clim=(1460.0, 1500.0),
             duration: float = 2.5, padding_factor: int = 4,
             filter_kwargs: dict = None, snr=None, fmax: float = 20.0,
             device="cuda"):
    """PSD spectrogram dataset of one pair's CCF dataset over one
    triggered period, or None when postprocess leaves no data (its
    ``ValueError``): psd trimmed to ``freq <= fmax`` and the period's
    ``snr`` of ``pair`` merged in (spec: ``xcorr/scripts/psd.py:42-78``)."""
    try:
        ds = postprocess(ds, clim=clim, time_lim=(start, end),
                         filter_kwargs=filter_kwargs, device=device)
    except ValueError:
        return None
    psd = spectrogram(ds["cc"], duration=duration,
                      padding_factor=padding_factor, device=device)
    if fmax is not None:
        psd = psd.where(psd.coords["freq"] <= fmax, drop=True)
    psd_ds = ndlabel.Dataset(attrs=dict(ds.attrs))
    psd_ds["psd"] = psd
    psd_ds["distance"] = ds["distance"]
    if snr is not None:
        try:
            s = snr.sel(pair=[pair])
            t0 = np.datetime64(pd.Timestamp(start))
            t1 = np.datetime64(pd.Timestamp(end))
            s = s.where((s.coords["time"] >= t0) & (s.coords["time"] <= t1),
                        drop=True)
            psd_ds["snr"] = s
        except (KeyError, ValueError):
            pass
    return psd_ds


def iter_pair_psd(pairs, start, end, root, clim=(1460.0, 1500.0),
                  duration: float = 2.5, padding_factor: int = 4,
                  filter_kwargs: dict = None, snr=None,
                  fmax: float = 20.0, device="cuda"):
    """Yield ``(pair, dataset)`` PSD spectrograms for one triggered
    period, one dataset per pair read from the shards under ``root``."""
    from .. import io as xio
    from ..io.filesystem import ncfile

    days = pd.date_range(pd.Timestamp(start).normalize(),
                         pd.Timestamp(end).normalize(), freq="1D")
    for pair in pairs:
        files = [ncfile(pair, d, root) for d in days]
        files = [f for f in files if os.path.exists(f)]
        if not files:
            continue
        psd_ds = pair_psd(xio.mfread(files, fast=True), pair, start, end,
                          clim=clim, duration=duration,
                          padding_factor=padding_factor,
                          filter_kwargs=filter_kwargs, snr=snr, fmax=fmax,
                          device=device)
        if psd_ds is not None:
            yield pair, psd_ds


def psd_of_period(pairs, start, end, root, **kwargs):
    """All pairs' PSD spectrograms of one period, concatenated."""
    out = [ds for _, ds in iter_pair_psd(pairs, start, end, root,
                                         **kwargs)]
    if not out:
        return None
    return ndlabel.concat(out, "pair") if len(out) > 1 else out[0]


def period_ncfile(pair: str, start, ndays: float, root: str) -> str:
    """``root/psd/pair/pair.yyyy.doy.hhh.psd.nc`` (ref
    ``xcorr/scripts/psd.py:81-100``)."""
    start = pd.Timestamp(start)
    name = "{p}.{y:04d}.{d:03d}.{h:03d}.psd.nc".format(
        p=pair, y=start.year, d=start.dayofyear, h=int(ndays * 24))
    return os.path.join(root, "psd", pair, name)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-psd",
        description="PSD spectrograms of triggered CCF periods "
                    "(PyTorch port).")
    parser.add_argument("ct", metavar="ct", type=str,
                        help="Coincidence-trigger netCDF (from xcorr-ct)")
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        default=None)
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--duration", metavar="..", type=float, default=2.5)
    parser.add_argument("--padding-factor", metavar="..", type=int,
                        default=4)
    parser.add_argument("--filter-freq", metavar="..", type=float,
                        default=3.0,
                        help="Postprocess highpass corner (Hz)")
    parser.add_argument("--fmax", metavar="..", type=float, default=20.0,
                        help="Trim spectrogram to freq <= fmax (Hz); "
                             "the usable band below Nyquist "
                             "(ref psd.py:66-68)")
    parser.add_argument("--outdir", metavar="..", type=str, default=".",
                        help="Output root: files land at "
                             "outdir/psd/pair/pair.yyyy.doy.hhh.psd.nc")
    utils.add_common_arguments(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    cfg = utils.init_compute(args)
    device = resolve_device(cfg["device"])
    from .. import io as xio

    ct_ds = xio.read(args.ct, fast=True) or xio.from_netcdf(args.ct)
    periods = trigger_periods(ct_ds["ct"])
    log.info("%d triggered periods", len(periods))

    pairs = args.pair or [str(p) for p in
                          ct_ds.coords["pair"].values.tolist()]

    snr = ct_ds["snr"] if "snr" in ct_ds else None
    if snr is None:
        log.warning("no 'snr' variable in %s; period files will not "
                    "carry snr", args.ct)

    def run(idx_row):
        idx, row = idx_row
        start, end = row["start"], row["end"]
        ndays = (pd.Timestamp(end) - pd.Timestamp(start)) / pd.Timedelta(
            days=1)
        outs = []
        for pair, ds in iter_pair_psd(
                pairs, start, end, args.root,
                clim=tuple(args.celerity), duration=args.duration,
                padding_factor=args.padding_factor, snr=snr,
                fmax=args.fmax,
                filter_kwargs={"frequency": args.filter_freq,
                               "btype": "highpass", "order": 2},
                device=device):
            out = period_ncfile(pair, start, ndays, args.outdir)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            xio.write(ds, out, verb=0, force_write=True)
            outs.append(out)
        return outs

    with ThreadPoolExecutor(max_workers=cfg["nworkers"]) as ex:
        outs = [o for sub in ex.map(run, periods.iterrows())
                for o in (sub or [])]
    for o in outs:
        log.info("wrote %s", o)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
