r"""
:mod:`scripts.plmax` -- Local spectrogram peaks CLI (``xcorr-torch-plmax``)
===========================================================================

Per (pair, day): postprocess -> spectrogram (or scaleogram) -> 2-D local
peak extraction -> long-form DataFrame, written as CSV or pandas HDF
(spec: ``xcorr/scripts/plmax.py:31-80``; port of
``xcorr_tpu/scripts/plmax.py``).

The chain, the spectrogram or scaleogram and the peak filter run on the
torch device that ``--platform`` names (``cuda`` by default, raising
without a card). :func:`pair_plmax` is the computation on a dataset in
memory. The shard I/O is imported on use.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import pandas as pd

from ..core.postprocess import postprocess
from ..core.process import resolve_device
from ..signal.cwt import scaleogram
from ..signal.peak_local_max import peak_local_max
from ..signal.spectrogram import spectrogram
from . import utils

__all__ = ["pair_plmax", "plmax_day", "main"]


def pair_plmax(ds, clim=(1460.0, 1500.0), min_distance: int = 25,
               wavelet: bool = False, duration: float = 2.5,
               padding_factor: int = 4, filter_kwargs: dict = None,
               device="cuda"):
    """Peak DataFrame of one pair's CCF dataset, or None when postprocess
    leaves no data (its ``ValueError``) or no peak is found."""
    try:
        ds = postprocess(ds, clim=clim, filter_kwargs=filter_kwargs,
                         device=device)
    except ValueError:
        return None
    cc = ds["cc"]
    psd = (scaleogram(cc, dim="lag", device=device) if wavelet
           else spectrogram(cc, duration=duration,
                            padding_factor=padding_factor, device=device))
    df = peak_local_max(psd, min_distance=min_distance,
                        as_dataframe=True, device=device)
    if df is None or len(df) == 0:
        return None
    return df


def plmax_day(pair, day, root, clim=(1460.0, 1500.0),
              min_distance: int = 25, wavelet: bool = False,
              duration: float = 2.5, padding_factor: int = 4,
              filter_kwargs: dict = None, device="cuda"):
    """Peak DataFrame for one (pair, day) shard under ``root``, with its
    ``day`` column."""
    from .. import io as xio
    from ..io.filesystem import ncfile

    nc = ncfile(pair, day, root)
    if not os.path.exists(nc):
        return None
    ds = xio.read(nc, fast=True)
    if ds is None:
        return None
    df = pair_plmax(ds, clim=clim, min_distance=min_distance,
                    wavelet=wavelet, duration=duration,
                    padding_factor=padding_factor,
                    filter_kwargs=filter_kwargs, device=device)
    if df is not None:
        df["day"] = pd.Timestamp(day)
    return df


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-plmax",
        description="Local maxima of CCF spectrograms (PyTorch port).")
    parser.add_argument("start", metavar="start", type=str)
    parser.add_argument("end", metavar="end", type=str)
    parser.add_argument("--root", metavar="..", type=str, default="data/cc")
    parser.add_argument("--pair", metavar="..", type=str, action="append",
                        required=True)
    parser.add_argument("--celerity", metavar="..", type=float, nargs=2,
                        default=(1460.0, 1500.0))
    parser.add_argument("--min-distance", metavar="..", type=int,
                        default=25)
    parser.add_argument("--wavelet", action="store_true", default=False,
                        help="Use the CWT scaleogram instead of the STFT")
    parser.add_argument("--filter-freq", metavar="..", type=float,
                        default=3.0,
                        help="Postprocess highpass corner (Hz)")
    parser.add_argument("--out", metavar="..", type=str, default=None,
                        help="Output .h5 (pandas HDF) or .csv path")
    utils.add_common_arguments(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    cfg = utils.init_compute(args)
    device = resolve_device(cfg["device"])

    days = pd.date_range(args.start, args.end, freq="1D")
    items = [(p, d) for p in args.pair for d in days]
    with ThreadPoolExecutor(max_workers=cfg["nworkers"]) as ex:
        frames = list(ex.map(
            lambda it: plmax_day(it[0], it[1], args.root,
                                 clim=tuple(args.celerity),
                                 min_distance=args.min_distance,
                                 wavelet=args.wavelet,
                                 filter_kwargs={
                                     "frequency": args.filter_freq,
                                     "btype": "highpass", "order": 2},
                                 device=device),
            items))
    frames = [f for f in frames if f is not None]
    if not frames:
        log.error("no peaks found")
        return 1
    df = pd.concat(frames, ignore_index=True)
    out = args.out or utils.ncfile_name(
        "plmax", days[0], days[-1], args.suffix).replace(".nc", ".csv")
    if out.endswith(".h5"):
        df.to_hdf(out, key="plmax")
    else:
        df.to_csv(out, index=False)
    log.info("wrote %s (%d peaks)", out, len(df))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
