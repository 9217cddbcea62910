# Carried from xcorr_tpu/io/validate.py (see test_torch_host_copies).
r"""
:mod:`io.validate` -- Dataset validation gatekeeper
===================================================

Hash-verify datasets on read (reference: ``xcorr/io/validate.py:35-369``):
require version + metadata-hash attrs, recompute and compare hashes,
apply template filters (metadata/preprocess hash, version), and normalize
types (scalar attr fixups, utf-8 pairs, timedelta -> float seconds).
"""

from __future__ import annotations

import glob
import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import util
from .utils import preprocess_operations_to_dict

__all__ = ["validate", "validate_list"]


def validate(dataset, fast: bool = False, quick_and_dirty: bool = False,
             metadata_hash: str = None, preprocess_hash: str = None,
             xcorr_version: str = None, verb: int = 0, **kwargs):
    """Validate a Dataset; returns the normalized dataset or None."""
    if dataset is None or not hasattr(dataset, "data_vars"):
        return None

    if ("xcorr_version" not in dataset.attrs or
            "sha256_hash_metadata" not in dataset.attrs):
        return None

    if "sha256_hash" not in dataset.attrs:
        fast = True

    # single-element ndarray attr fixups (HDF5 scalar round trip)
    for var in dataset.variables:
        da = dataset.variables[var]
        for attr in list(da.attrs.keys()):
            v = da.attrs[attr]
            if isinstance(v, np.ndarray) and v.ndim > 0 and len(v) == 1:
                da.attrs[attr] = v.item()

    src = dataset.encoding.get("source", "[memory]")

    if metadata_hash is not None:
        if not isinstance(metadata_hash, str):
            raise TypeError("``metadata_hash`` should be a string.")
        if len(metadata_hash) != 64:
            raise ValueError("``metadata_hash`` should be of length 64.")

    if not ("pair" in dataset.coords and "time" in dataset.coords):
        if verb > 0:
            warnings.warn("dataset lacks the pair/time coordinates",
                          UserWarning)
        return None

    # preprocess JSON -> verified dict (before hashing, like the reference)
    preprocess_operations_to_dict(dataset.coords["pair"])

    if not quick_and_dirty:
        sha256_hash_metadata = util.hasher.hash_Dataset(
            dataset, metadata_only=True)
        if sha256_hash_metadata != dataset.attrs["sha256_hash_metadata"]:
            if verb > 0:
                warnings.warn(
                    f"metadata sha256 recorded in {src} does not match its recomputed digest",
                    UserWarning)
            if verb > 1:
                print("source :", src)
                print("sha256 in file     :",
                      dataset.attrs["sha256_hash_metadata"])
                print("sha256 computed    :", sha256_hash_metadata)
            return None

    if not (quick_and_dirty or fast):
        sha256_hash = util.hasher.hash_Dataset(dataset, metadata_only=False)
        if sha256_hash != dataset.attrs["sha256_hash"]:
            if verb > 0:
                warnings.warn(
                    f"data sha256 recorded in {src} does not match its recomputed digest",
                    UserWarning)
            return None

    if not quick_and_dirty:
        if metadata_hash and \
                dataset.attrs["sha256_hash_metadata"] != metadata_hash:
            if verb > 0:
                warnings.warn("metadata hash differs from the requested reference digest",
                              UserWarning)
            return None
        if preprocess_hash and dataset.coords["pair"].attrs[
                "preprocess"]["sha256_hash"] != preprocess_hash:
            if verb > 0:
                warnings.warn("preprocess hash differs from the requested reference digest",
                              UserWarning)
            return None
        if xcorr_version and dataset.attrs["xcorr_version"] != xcorr_version:
            if verb > 0:
                warnings.warn("dataset was written by a different xcorr version",
                              UserWarning)
            return None

    # timedelta64 -> float seconds
    for var in list(dataset.variables):
        da = dataset.variables[var]
        if np.issubdtype(da.dtype, np.timedelta64):
            da.data = da.data / np.timedelta64(1, "s")
            da.attrs["units"] = "s"

    return dataset


def validate_list(datasets, strict: bool = False, paths_only: bool = False,
                  keep_opened: bool = False, parallel: bool = False,
                  engine: str = None, verb: int = 0, **kwargs):
    """Validate a list of datasets or paths; the first file is validated
    eagerly and becomes the template (hashes/version) for the rest
    (reference: ``xcorr/io/validate.py:222-369``)."""
    from .netcdf import from_netcdf

    if isinstance(datasets, str):
        datasets = [datasets]
    sources = []
    for d in datasets:
        if isinstance(d, str):
            expanded = sorted(glob.glob(d))
            sources.extend(expanded if expanded else
                           ([d] if os.path.exists(d) else []))
        else:
            sources.append(d)
    if not sources:
        raise ValueError("No data found!")

    def load(src):
        if isinstance(src, str):
            try:
                return from_netcdf(src), src
            except (OSError, KeyError, ValueError):
                return None, src
        return src, src.encoding.get("source", "[memory]")

    # scan forward to the FIRST VALID dataset (reference behavior,
    # xcorr/io/validate.py:329-339): a corrupt leading shard is skipped
    # with a warning, not fatal for the whole merge
    first = None
    nskip = 0
    for nskip, src in enumerate(sources):
        first, first_src = load(src)
        first = validate(first, verb=verb, **kwargs)
        if first is not None:
            break
        warnings.warn(f"Dataset {first_src} failed validation; skipped",
                      UserWarning)
    if first is None:
        raise RuntimeError("No valid dataset found")

    # template pinned to the first valid dataset (reference
    # xcorr/io/validate.py:345-349): the metadata hash (config-only, so
    # it repeats across same-config shards) gates cross-shard
    # consistency; the version gate applies only when strict
    template = {
        "metadata_hash": first.attrs.get("sha256_hash_metadata"),
        "preprocess_hash":
            first.coords["pair"].attrs["preprocess"]["sha256_hash"]
            if "preprocess" in first.coords["pair"].attrs else None,
        "xcorr_version": first.attrs.get("xcorr_version") if strict
            else None,
    }

    def check(src):
        ds, name = load(src)
        v = validate(ds, verb=verb, **{**kwargs, **template})
        if v is None:
            if strict:
                raise RuntimeError(f"Dataset {name} failed validation")
            return None
        return name if paths_only else v

    rest = sources[nskip + 1:]
    if parallel and rest:
        with ThreadPoolExecutor() as ex:
            validated = list(ex.map(check, rest))
    else:
        validated = [check(s) for s in rest]
    head = first_src if paths_only else first
    return [head] + [v for v in validated if v is not None]
