# Carried from xcorr_tpu/io/__init__.py (see test_torch_host_copies).
r"""
:mod:`xcorr_tpu.io` -- Storage
==============================

Validated, hash-stamped netCDF persistence of CCF datasets on an SDS-like
``year/pair/*.nc`` tree (reference layer: ``xcorr/io/``).
"""

from .read import read, mfread
from .write import write
from .validate import validate, validate_list
from .filesystem import ncfile
from .netcdf import to_netcdf, from_netcdf

__all__ = ["read", "mfread", "write", "validate", "validate_list", "ncfile",
           "to_netcdf", "from_netcdf"]
