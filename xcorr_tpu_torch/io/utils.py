# Carried from xcorr_tpu/io/utils.py (see test_torch_host_copies).
r"""
:mod:`io.utils` -- In-place preprocess attr converters
======================================================

Convert the pair coordinate's hashed preprocess-operations attribute between
`dict` (in memory) and JSON `str` (netCDF-safe), verifying the sha256 on
load (reference: ``xcorr/io/utils.py:11-52``).
"""

from __future__ import annotations

from ..stream.process import operations_to_dict, operations_to_json

__all__ = ["preprocess_operations_to_dict", "preprocess_operations_to_json"]


def preprocess_operations_to_dict(pair, attribute: str = None):
    """JSON str -> verified dict, in place on ``pair.attrs``."""
    attribute = attribute or "preprocess"
    if attribute in pair.attrs and isinstance(pair.attrs[attribute], str):
        pair.attrs[attribute] = operations_to_dict(pair.attrs[attribute])


def preprocess_operations_to_json(pair, attribute: str = None):
    """dict -> hashed JSON str, in place on ``pair.attrs``."""
    attribute = attribute or "preprocess"
    if attribute in pair.attrs and isinstance(pair.attrs[attribute], dict):
        pair.attrs[attribute] = operations_to_json(pair.attrs[attribute])
