# Carried from xcorr_tpu/io/read.py (see test_torch_host_copies).
r"""
:mod:`io.read` -- Dataset loading
=================================

Validated single and multi-file reads
(reference: ``xcorr/io/read.py:32-203``).
"""

from __future__ import annotations

from ..ndlabel import combine_by_coords
from .netcdf import from_netcdf
from .validate import validate, validate_list

__all__ = ["read", "mfread"]


def read(path, extract: bool = False, engine: str = None, verb: int = 0,
         header_only: bool = False, **kwargs):
    """Open and validate a single netCDF shard.

    ``extract=True`` masks cc by ``status == 1``
    (reference ``xcorr/io/read.py:89-91``).

    ``header_only=True`` skips decompressing large data variables
    (``cc`` becomes a zero placeholder; attrs/coords/status intact) —
    for status/metadata checks such as resume scans; implies
    ``fast`` validation and the result cannot be written back.
    """
    if header_only:
        # binding, not a default: full-data-hash validation over the
        # zero placeholders would always mismatch and return None
        kwargs["fast"] = True
    if isinstance(path, str):
        try:
            dataset = from_netcdf(path, header_only=header_only)
        except (OSError, KeyError, ValueError) as error:
            if verb > 0:
                print(f"Failed to open {path}: {error}")
            return None
    else:
        dataset = path
    dataset = validate(dataset, verb=verb, **kwargs)
    if dataset is None:
        return None
    if extract:
        dataset["cc"] = dataset["cc"].where(dataset["status"] == 1)
    return dataset


def mfread(paths, extract: bool = False, preprocess=None, engine: str = None,
           parallel: bool = True, chunks=None, naive: bool = False,
           verb: int = 0, **kwargs):
    """Open and combine many shards by coordinates.

    ``naive=True`` skips validation (reference ``xcorr/io/read.py:95-203``).
    """
    if naive:
        if isinstance(paths, str):
            import glob
            paths = sorted(glob.glob(paths))
        datasets = [from_netcdf(p) for p in paths]
    else:
        datasets = validate_list(paths, parallel=parallel, verb=verb,
                                 **kwargs)
    dataset = combine_by_coords(datasets)
    if extract:
        dataset["cc"] = dataset["cc"].where(dataset["status"] == 1)
    return dataset
