r"""
:mod:`scripts.utils` -- Shared CLI plumbing
===========================================

Logging init, the common argparse options and the compute set-up of the
port's console scripts (port of the parts of ``xcorr_tpu/scripts/utils.py``
that ``cc`` uses; spec ``xcorr/scripts/utils.py:29-159``).

``--platform`` names the torch device: ``cuda`` (the default) or ``cpu``.
The multi-host options (``--coordinator``, ``--num-processes``,
``--process-id``) raise until the multi-GPU slice. Not carried: the JAX
persistent compile cache and the heap settings of ``util/sysmem``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

__all__ = ["init_logging", "add_common_arguments", "init_compute",
           "PLATFORMS"]

#: ``--platform`` values: the torch device the work runs on
PLATFORMS = ("cuda", "cpu")


def init_logging(debug: bool = False):
    """Configure stdout logging (reference ``scripts/utils.py:29-47``)."""
    logging.basicConfig(
        stream=sys.stdout,
        format="%(asctime)s %(levelname)s %(message)s",
        level=logging.DEBUG if debug else logging.INFO,
    )
    return logging.getLogger()


def init_compute(args):
    """The host worker count and the torch device of a run: ``{"nworkers":
    n, "device": "cuda" | "cpu"}``.

    ``--nworkers`` sizes the host IO thread pool (default: the cpu
    count); ``--platform`` picks the device (default ``cuda``, which
    raises at first use when torch sees no card). The multi-host options
    raise: the port runs on one card until the multi-GPU slice.
    """
    n = getattr(args, "nworkers", None) or os.cpu_count() or 4
    if getattr(args, "debug", False):
        logging.getLogger().setLevel(logging.DEBUG)
    multi = [opt for opt, name in (("--coordinator", "coordinator"),
                                   ("--num-processes", "num_processes"),
                                   ("--process-id", "process_id"))
             if getattr(args, name, None) is not None]
    if multi:
        raise SystemExit(f"{', '.join(multi)}: multi-host runs are not "
                         "ported to xcorr_tpu_torch yet")
    return {"nworkers": n, "device": getattr(args, "platform", None)
            or "cuda"}


def add_common_arguments(parser: argparse.ArgumentParser):
    """The shared CLI options (reference ``scripts/utils.py:115-159``)."""
    parser.add_argument(
        "-n", "--nworkers", metavar="..", type=int, default=None,
        help="Set the number of host IO workers (defaults to cpu count)")
    parser.add_argument(
        "--scheduler", metavar="..", type=str, default=None,
        help="Accepted for reference-CLI compatibility (ignored)")
    parser.add_argument(
        "--coordinator", metavar="host:port", type=str, default=None,
        help="Multi-host formation address: not ported yet (raises)")
    parser.add_argument(
        "--num-processes", metavar="N", type=int, default=None,
        help="Multi-host process count: not ported yet (raises)")
    parser.add_argument(
        "--process-id", metavar="I", type=int, default=None,
        help="Multi-host process index: not ported yet (raises)")
    parser.add_argument(
        "--platform", metavar="..", type=str, default=None,
        choices=PLATFORMS,
        help="Torch device: cuda (default) or cpu")
    parser.add_argument(
        "--prefix", metavar="..", type=str, default=None,
        help="Set the output file prefix")
    parser.add_argument(
        "--suffix", metavar="..", type=str, default=None,
        help="Set the output file suffix")
    parser.add_argument(
        "--overwrite", action="store_true", default=False,
        help="Overwrite output when it exists")
    parser.add_argument(
        "--plot", action="store_true", default=False,
        help="Render result plots")
    parser.add_argument(
        "--quick-and-dirty", action="store_true", default=False,
        dest="quick_and_dirty",
        help="Skip hash verification on reads")
    parser.add_argument(
        "--debug", action="store_true", default=False,
        help="Verbose debug logging")
    parser.add_argument(
        "--version", action="version",
        version=_version_string())
    return parser


def _version_string():
    from .. import __version__
    return f"xcorr-tpu-torch {__version__}"
