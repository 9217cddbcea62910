"""A Dataset's view, for comparing two readers of one file: everything
the Dataset carries, in order, in a form ``==`` and ``repr`` compare
exactly, and the sha256 of it.

Imports numpy alone, so that a check on a machine without h5py or the
JAX package (``chip_smoke.py`` phase 12) can use it beside
``tools/make_hdf5_fixtures.py``, which writes the digests, and
``tests/test_torch_hdf5_v2.py``.
"""

from __future__ import annotations

import hashlib

import numpy as np

#: global attributes that change from one write to the next
VOLATILE = ("history", "sha256_hash")


def plain(v):
    """A value in a form ``==`` and ``repr`` compare exactly, type
    included."""
    if isinstance(v, dict):
        return [[k, plain(x)] for k, x in v.items()]
    if isinstance(v, (list, tuple)):
        return [type(v).__name__, [plain(x) for x in v]]
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ["object", v.shape, [plain(x) for x in v.reshape(-1)]]
        return [str(v.dtype), v.shape, v.tobytes()]
    if isinstance(v, np.generic):
        return [type(v).__name__, plain(np.asarray(v))]
    return [type(v).__name__, v]


def view(ds, stable=False):
    """Everything a Dataset carries, in order (variables, coordinates,
    attributes, encoding), the source path aside; ``stable`` drops the
    global attributes that change with each write."""
    attrs = {k: v for k, v in ds.attrs.items()
             if not (stable and k in VOLATILE)}
    out = {"attrs": plain(attrs), "dims": plain(dict(ds.dims)),
           "encoding": plain({k: v for k, v in ds.encoding.items()
                              if k != "source"}),
           "coords": list(ds._coords), "vars": list(ds._vars)}
    for group in (ds._coords, ds._vars):
        for name, da in group.items():
            out[name] = (tuple(da.dims), plain(np.asarray(da.data)),
                         plain(dict(da.attrs)))
    return out


def digest(ds, stable=False):
    """sha256 of :func:`view`."""
    return hashlib.sha256(repr(view(ds, stable)).encode()).hexdigest()


def digest_or_raise(read, path, stable=False, **kw):
    """:func:`digest` of ``read(path, **kw)``, or ``"raises <type>"``
    where the read raises (a structure the reader refuses, such as a
    null dataset's size in a header-only read)."""
    try:
        ds = read(path, **kw)
    except Exception as e:      # noqa: BLE001 -- recorded by type
        return f"raises {type(e).__name__}"
    return digest(ds, stable)
