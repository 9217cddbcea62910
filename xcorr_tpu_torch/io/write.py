# Carried from xcorr_tpu/io/write.py (see test_torch_host_copies).
r"""
:mod:`io.write` -- Atomic dataset persistence
=============================================

Hash-stamped, atomic netCDF shard writes
(reference: ``xcorr/io/write.py:31-184``): refresh the metadata hash,
refuse all-zero-status datasets unless forced, optionally hash the full
data, serialize the preprocess dict to JSON, write to a timestamped tmp
file and move it into place.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pandas as pd

from .. import util
from .utils import (preprocess_operations_to_dict,
                    preprocess_operations_to_json)

__all__ = ["write"]


def write(dataset, path: str, close: bool = True,
          force_write: bool = False, variable_encoding: dict = None,
          hash_data: bool = True, verb: int = 1, **kwargs):
    """Write a Dataset to ``path`` atomically, with provenance hashes.

    ``hash_data=False`` skips the (slow) full-data sha256, matching the
    reference's two-tier hashing.
    """
    isdataset = hasattr(dataset, "data_vars")

    # refuse to write a dataset with no processed data (unless forced)
    if isdataset and "status" in dataset.variables:
        status = dataset.status.values
        if (status == 1).sum() == 0 and not force_write:
            if verb > 0:
                print("Dataset contains no data. Set force_write to save "
                      "anyway.")
            return None

    if verb > 0:
        print(f"Write dataset as {path}", end=": ")

    # refresh history + hashes
    dataset.attrs["history"] = (
        dataset.attrs.get("history", "") +
        f", Write started @ {pd.to_datetime('now')}")
    dataset.attrs["sha256_hash_metadata"] = util.hasher.hash_Dataset(
        dataset, metadata_only=True)
    if hash_data:
        if verb > 0:
            print("hash", end=". ")
        # CF-packed variables (encoding dtype int16/int32 on float
        # data): hash the quantize->decode round trip — the stored
        # digest must match what a reader of the packed file recomputes
        hash_src = dataset
        packed = {}
        if isdataset:
            enc_all = variable_encoding or {}
            for name in dataset.data_vars:
                enc = {**dataset.encoding.get(name, {}), **enc_all}
                pdt = enc.get("dtype")
                if pdt is not None and \
                        np.issubdtype(np.dtype(pdt), np.integer) and \
                        np.issubdtype(dataset[name].dtype, np.floating):
                    packed[name] = enc
        if packed:
            from ..ndlabel import DataArray
            from .netcdf import pack_roundtrip
            hash_src = dataset.copy()
            for name, enc in packed.items():
                da = dataset[name]
                hash_src[name] = DataArray(
                    pack_roundtrip(da.values, enc), dims=da.dims,
                    name=name, attrs=dict(da.attrs))
            hash_src.attrs = dataset.attrs
        dataset.attrs["sha256_hash"] = util.hasher.hash_Dataset(
            hash_src, metadata_only=False)
    else:
        dataset.attrs.pop("sha256_hash", None)

    # preprocess dict -> JSON for storage
    if "pair" in dataset.coords:
        preprocess_operations_to_json(dataset.coords["pair"])

    # per-variable encoding overrides
    if variable_encoding:
        for name in list(dataset.data_vars) + list(dataset.coords):
            enc = dict(dataset.encoding.get(name, {}))
            enc.update(variable_encoding)
            dataset.encoding[name] = enc

    abspath = os.path.abspath(path)
    os.makedirs(os.path.dirname(abspath) or ".", exist_ok=True)
    tmp = "{p}.{t}".format(p=abspath,
                           t=int(pd.to_datetime("now").timestamp() * 1e3))
    if verb > 0:
        print("to temporary netcdf", end=". ")
    from .netcdf import to_netcdf
    try:
        to_netcdf(dataset, tmp, mode="w")
        if verb > 0:
            print("replace", end=". ")
        shutil.move(tmp, abspath)
    finally:
        # a failed write must not leak the tmp file NOR leave the
        # in-memory pair 'preprocess' attr in its JSON-string storage
        # form — a retried write would then hash the string form and
        # record a metadata hash validate() can never reproduce
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        if "pair" in dataset.coords:
            preprocess_operations_to_dict(dataset.coords["pair"])

    if verb > 0:
        print("done.")
    return abspath
