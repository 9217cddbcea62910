r"""
:mod:`scripts.cc` -- Batch CCF production config
================================================

The production batch configuration script (spec: ``xcorr/scripts/cc.py``;
port of ``xcorr_tpu/scripts/cc.py``, console script ``xcorr-torch-cc``):
init args (50 Hz, 24 h windows, 3 h shift, 9 h lag clip, POI-relative
distances), client args, receiver pairs and the period, handed to
:func:`xcorr_tpu_torch.lazy_process` on the torch device that
``--platform`` names (``cuda`` by default). Run directly or import the
config dicts. ``default_config`` is the JAX package's, unchanged.

No ``--cc-precision``: the port has no precision setting (every product
of the correlation runs in float32).
"""

from __future__ import annotations

import argparse

import pandas as pd

from . import utils

__all__ = ["default_config", "main"]


def default_config(sds_root: str = "data/sds", fdsn: str = None):
    """The cookbook production configuration
    (reference ``xcorr/scripts/cc.py:25-165``)."""
    xcorr_init_args = {
        "sampling_rate": 50.0,
        "window_length": 86400.0,       # 24h
        "window_overlap": 21.0 / 24.0,  # 3h shift
        "clip_lag": (0.0, 9 * 3600.0),
        "unbiased_cc": False,           # correct dataset-wide afterwards
        "hash_waveforms": False,
        "stationary_poi": {
            "name": "MVC",
            "latitude": -25.887,
            "longitude": -177.188,
        },
        "attrs": {
            "title": "Monowai Volcanic Centre",
            "institution": "n/a",
            "author": "n/a",
            "source": "CTBTO/IMS hydroacoustic array and IRIS/USGS "
                      "seismic network",
        },
        "preprocess": {
            "BHZ": [
                ("merge", {"method": 1, "fill_value": "interpolate",
                           "interpolation_samples": 0}),
                ("filter", {"type": "highpass", "freq": .05}),
                ("detrend", {"type": "demean"}),
                ("remove_response", {"output": "VEL"}),
                ("filter", {"type": "highpass", "freq": 3.}),
                ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                                 "a": 20}),
                ("filter", {"type": "lowpass", "freq": 20.}),
                ("trim", {}),
                ("detrend", {"type": "demean"}),
                ("taper", {"type": "cosine", "max_percentage": 0.05,
                           "max_length": 30.}),
            ],
            "BHR": [
                ("merge", {"method": 1, "fill_value": "interpolate",
                           "interpolation_samples": 0}),
                ("filter", {"type": "highpass", "freq": .05}),
                ("detrend", {"type": "demean"}),
                ("remove_response", {"output": "VEL"}),
                ("rotate", {"method": "->ZNE"}),
                ("rotate", {"method": "NE->RT", "back_azimuth": 250.39}),
                ("select", {"channel": "BHR"}),
                ("filter", {"type": "highpass", "freq": 3.}),
                ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                                 "a": 20}),
                ("filter", {"type": "lowpass", "freq": 20.}),
                ("trim", {}),
                ("detrend", {"type": "demean"}),
                ("taper", {"type": "cosine", "max_percentage": 0.05,
                           "max_length": 30.}),
            ],
            "EDH": [
                ("merge", {"method": 1, "fill_value": "interpolate",
                           "interpolation_samples": 0}),
                ("detrend", {"type": "demean"}),
                ("remove_sensitivity", {}),
                ("filter", {"type": "bandpass", "freqmin": 3.,
                            "freqmax": 20.}),
                ("decimate", {"factor": 5}),
                ("trim", {}),
                ("detrend", {"type": "demean"}),
                ("taper", {"type": "cosine", "max_percentage": 0.05,
                           "max_length": 30.}),
            ],
        },
    }

    xcorr_client_args = {
        "sds_root": sds_root,
        "fdsn_base_url": fdsn,
        "parallel": True,
    }

    pairs = [
        "IM.H10N1..EDH-IU.RAR.10.BHZ",
        "IM.H10N1..EDH-IU.RAR.10.BHR",
        "IM.H03S1..EDH-IU.RAR.10.BHZ",
        "IM.H03S1..EDH-IU.RAR.10.BHR",
        "IM.H10N1..EDH-IM.H03S1..EDH",
        "IM.H10N2..EDH-IM.H03S2..EDH",
        "IM.H10N3..EDH-IM.H03S3..EDH",
        "IM.H10N1..EDH-IU.AFI.00.BHZ",
    ]

    times = pd.date_range("2014-01-01", "2015-01-01", freq="1D")

    return xcorr_init_args, xcorr_client_args, pairs, times


def main(argv=None):
    """xcorr-torch-cc entry: run the batch config against an SDS
    archive."""
    parser = argparse.ArgumentParser(
        prog="xcorr-torch-cc",
        description="Batch-produce daily CCF shards for receiver pairs "
                    "(PyTorch port; the correlation runs in float32, "
                    "there is no --cc-precision).")
    parser.add_argument("--root", metavar="..", type=str, default="data/cc",
                        help="CCF output root")
    parser.add_argument("--sds-root", metavar="..", type=str,
                        default="data/sds", help="SDS waveform archive")
    parser.add_argument("--fdsn", metavar="..", type=str, default=None,
                        help="FDSN base url for remote fetch (optional)")
    parser.add_argument("--start", metavar="..", type=str,
                        default="2014-01-01")
    parser.add_argument("--end", metavar="..", type=str,
                        default="2015-01-01")
    parser.add_argument("--pair", metavar="..", action="append",
                        default=None, help="Receiver pair (repeatable)")
    parser.add_argument("--inventory", metavar="..", type=str, default=None,
                        help="Inventory JSON file")
    parser.add_argument("--pack-cc", action="store_true",
                        help="store cc CF-packed as int16 (per-file "
                             "scale_factor): ~40%% smaller shards, "
                             "~35%% faster writes, ~1.5e-5 quantization")
    parser.add_argument("--complevel", metavar="N", type=int, default=1,
                        help="zlib level for shard variables (default 1; "
                             "9 restores the reference's storage config)")
    utils.add_common_arguments(parser)
    args = parser.parse_args(argv)

    log = utils.init_logging(args.debug)
    cfg = utils.init_compute(args)

    init_args, client_args, pairs, _ = default_config(args.sds_root,
                                                      args.fdsn)
    if args.pair:
        pairs = args.pair
    times = pd.date_range(args.start, args.end, freq="1D")

    inventory = None
    if args.inventory:
        from ..stream import Inventory
        inventory = Inventory.from_json(args.inventory)
    init_args["inventory"] = inventory
    if args.pack_cc:
        init_args["pack_cc"] = True
    if args.complevel != 1:
        init_args["complevel"] = args.complevel

    from ..core.lazy import lazy_process
    log.info("Batch correlate %d pairs x %d days -> %s on %s",
             len(pairs), len(times), args.root, cfg["device"])
    results = lazy_process(pairs, times, init_args, client_args,
                           inventory=inventory, root=args.root,
                           nworkers=cfg["nworkers"], device=cfg["device"])
    log.info("completed %d/%d", sum(map(bool, results)), len(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
