# Carried from xcorr_tpu/ndlabel/__init__.py (see test_torch_host_copies).
r"""
:mod:`xcorr_tpu.ndlabel` -- Labelled N-D arrays
===============================================

A lean, self-contained labelled-array substrate (dims, coords, attrs) in the
spirit of ``xarray.DataArray``/``xarray.Dataset``, which the reference
framework builds on (reference: ``xcorr/core/init.py``,
``xcorr/signal/*`` all operate on xarray objects).

This rebuild keeps host metadata handling in plain numpy while the compute
path hands dense blocks to JAX; the substrate therefore stays deliberately
small: no lazy indexes, no dask, no alignment-by-label arithmetic beyond
dimension broadcasting.
"""

from .dataarray import DataArray
from .dataset import Dataset
from .combine import concat, combine_by_coords, merge

__all__ = ["DataArray", "Dataset", "concat", "combine_by_coords", "merge"]
