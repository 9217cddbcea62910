r"""
:mod:`signal._helpers` -- Shared wrapper plumbing
=================================================

The dimension check of ``xcorr_tpu/signal/_helpers.py``, which is all the
carried :mod:`.unbias` needs.
"""

from __future__ import annotations

from ..ndlabel import DataArray

__all__ = ["get_dim"]


def get_dim(x: DataArray, dim: str = None):
    """Validate and default the core dimension (last dim)."""
    dim = dim or x.dims[-1]
    if not isinstance(dim, str):
        raise TypeError("dim should be a string")
    if dim not in x.dims:
        raise ValueError(f'x has no dimensions "{dim}"')
    return dim
