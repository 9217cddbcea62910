# Carried from xcorr_tpu/ndlabel/combine.py (see test_torch_host_copies).
r"""
:mod:`ndlabel.combine` -- concat / merge / combine_by_coords
============================================================

Combination primitives mirroring the xarray calls the reference relies on:
``xr.concat`` (``xcorr/scripts/snr.py:81-83``), ``xr.merge`` and
``xr.combine_by_coords(data_vars='minimal', join='outer')``
(``xcorr/core/merge.py:53-88``, ``xcorr/io/read.py:167-177``).
"""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray
from .dataset import Dataset


def concat(objs, dim):
    """Concatenate DataArrays or Datasets along ``dim``.

    New-dim semantics follow xarray: if ``dim`` is not present in the inputs
    each object contributes one slice.
    """
    objs = list(objs)
    if isinstance(objs[0], Dataset):
        return _concat_datasets(objs, dim)
    return _concat_dataarrays(objs, dim)


def _concat_dataarrays(objs, dim):
    first = objs[0]
    if dim in first.dims:
        axis = first.dims.index(dim)
        data = np.concatenate([o.data for o in objs], axis=axis)
        out = DataArray(data, dims=first.dims, name=first.name,
                        attrs=dict(first.attrs))
        for k, c in first._coords.items():
            if dim in c.dims:
                cax = c.dims.index(dim)
                cdata = np.concatenate([o._coords[k].data for o in objs],
                                       axis=cax)
                out._coords[k] = DataArray(cdata, dims=c.dims, name=k,
                                           attrs=dict(c.attrs))
            else:
                out._coords[k] = c
        return out
    # new dimension: stack
    expanded = [o.expand_dims(dim) for o in objs]
    out = _concat_dataarrays(expanded, dim)
    # promote scalar coords named dim, if each object carried one
    labels = []
    for o in objs:
        c = o._coords.get(dim)
        labels.append(c.data if c is not None and c.ndim == 0 else None)
    if all(lab is not None for lab in labels):
        out._coords[dim] = DataArray(np.asarray(labels), dims=(dim,), name=dim)
    return out


def _concat_datasets(objs, dim):
    first = objs[0]
    out = Dataset(attrs=dict(first.attrs))
    out.encoding = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in first.encoding.items()}
    has_dim = any(dim in v.dims for v in first._vars.values()) or \
        any(dim in c.dims for c in first._coords.values())
    if not has_dim:
        # NEW dimension (xarray concat semantics): every data variable
        # gains it as the leading axis, one slice per object; per-object
        # scalar coords named ``dim`` promote to the dim coordinate.
        # (Previously this branch silently returned the first object's
        # variables unstacked — data loss.)
        for k, c in first._coords.items():
            if k != dim:
                out._coords[k] = c
        labels = []
        for o in objs:
            c = o._coords.get(dim)
            labels.append(c.data if c is not None and c.ndim == 0
                          else None)
        if all(lab is not None for lab in labels):
            out._coords[dim] = DataArray(np.asarray(labels), dims=(dim,),
                                         name=dim)
        for k, v in first._vars.items():
            data = np.stack([np.asarray(o._vars[k].data) for o in objs],
                            axis=0)
            nv = DataArray(data, dims=(dim,) + v.dims, name=k,
                           attrs=dict(v.attrs))
            out._vars[k] = nv
        return out
    for k, c in first._coords.items():
        if dim in c.dims:
            cax = c.dims.index(dim)
            cdata = np.concatenate([o._coords[k].data for o in objs],
                                   axis=cax)
            out._coords[k] = DataArray(cdata, dims=c.dims, name=k,
                                       attrs=dict(c.attrs))
        else:
            out._coords[k] = c
    for k, v in first._vars.items():
        if dim in v.dims:
            axis = v.dims.index(dim)
            data = np.concatenate([o._vars[k].data for o in objs], axis=axis)
            out._vars[k] = DataArray(data, dims=v.dims, name=k,
                                     attrs=dict(v.attrs))
        else:
            out._vars[k] = v
    return out


def merge(objs, combine_attrs="override"):
    """Shallow merge of Datasets: union of coords and variables.

    Conflicting variables must be identical-shaped; the first occurrence
    wins (matching ``xr.merge`` compat='override').
    """
    out = Dataset()
    for o in objs:
        if isinstance(o, DataArray):
            ds = Dataset()
            ds[o.name] = o
            o = ds
        if not out.attrs:
            out.attrs = dict(o.attrs)
        for k, c in o._coords.items():
            if k not in out._coords:
                out._coords[k] = c
        for k, v in o._vars.items():
            if k not in out._vars:
                out._vars[k] = v
        for k, e in o.encoding.items():
            out.encoding.setdefault(k, dict(e) if isinstance(e, dict) else e)
    return out


def _union_coord(values_list):
    """Sorted unique union of 1-D coordinate arrays."""
    cat = np.concatenate([np.asarray(v) for v in values_list])
    return np.unique(cat)


def combine_by_coords(datasets, data_vars="minimal", join="outer",
                      combine_attrs="override", fill_value=np.nan):
    """Outer-join datasets on their shared 1-D dimension coordinates.

    Implements the subset of :func:`xarray.combine_by_coords` exercised by
    the reference: per-(pair, day) CCF shards carrying identical schemas are
    unioned along ``pair`` and ``time`` (``xcorr/core/merge.py:62-68``).
    Later datasets overwrite earlier ones on overlapping cells.
    """
    datasets = list(datasets)
    if len(datasets) == 1:
        return datasets[0].copy(deep=False)
    first = datasets[0]

    # union coordinate per dim that has a 1-D dim coordinate. Dims whose
    # coordinate is IDENTICAL across all datasets (the 4.7M-sample lag
    # vector of every same-config CCF shard) skip the union entirely —
    # np.unique over 365 concatenated copies of a day-scale lag axis is
    # a multi-GB sort, and placement degrades to a full-length fancy
    # index where a plain slice suffices.
    dim_coords = {}
    for ds in datasets:
        for k, c in ds._coords.items():
            if c.ndim == 1 and c.dims == (k,):
                dim_coords.setdefault(k, []).append(c.data)
    unions, identical = {}, set()
    for k, vals in dim_coords.items():
        f = np.asarray(vals[0])
        if len(vals) == len(datasets) and all(
                np.asarray(v).shape == f.shape
                and np.array_equal(np.asarray(v), f) for v in vals[1:]):
            unions[k] = f
            identical.add(k)
        else:
            unions[k] = _union_coord(vals)

    out = Dataset(attrs=dict(first.attrs))
    out.encoding = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in first.encoding.items()}
    for k, c in first._coords.items():
        if k in unions:
            out._coords[k] = DataArray(unions[k], dims=(k,), name=k,
                                       attrs=dict(c.attrs))
        else:
            out._coords[k] = c

    # gather the full variable catalogue (any dataset may contribute)
    catalogue = {}
    for ds in datasets:
        for k, v in ds._vars.items():
            catalogue.setdefault(k, v)

    for k, proto in catalogue.items():
        shape = tuple(unions[d].size if d in unions else proto.sizes[d]
                      for d in proto.dims)
        if np.issubdtype(proto.dtype, np.floating):
            data = np.full(shape, fill_value, dtype=proto.dtype)
        elif proto.dtype == object:
            data = np.full(shape, None, dtype=object)
        else:
            data = np.zeros(shape, dtype=proto.dtype)
        for ds in datasets:
            if k not in ds._vars:
                continue
            v = ds._vars[k]
            idx = []
            for d in proto.dims:
                if d in unions and d not in identical:
                    pos = np.searchsorted(unions[d], ds._coords[d].data)
                    idx.append(pos)
                else:  # identical coord -> positions are 0..n-1: slice
                    idx.append(None)
            # sequential placement per dim (np.ix_-style for index arrays)
            arrays = [i for i in idx if i is not None]
            if len(arrays) == 0:
                data[...] = v.data
            else:
                ix = tuple(i if i is not None else slice(None) for i in idx)
                # build open mesh for the fancy index dims
                mesh = np.ix_(*[i for i in idx if i is not None])
                full = []
                m = iter(mesh)
                for i in idx:
                    full.append(next(m) if i is not None else slice(None))
                # np.ix_ meshes must be adjacent for mixed indexing; the CCF
                # schema has dim coords leading (pair, time, ...), so this
                # holds in practice. Fall back per-row otherwise.
                try:
                    data[tuple(full)] = v.data
                except (IndexError, ValueError):
                    it = np.ndindex(*[len(i) for i in arrays])
                    for multi in it:
                        src, dst, a = [], [], 0
                        for i in idx:
                            if i is None:
                                src.append(slice(None))
                                dst.append(slice(None))
                            else:
                                src.append(multi[a])
                                dst.append(i[multi[a]])
                                a += 1
                        data[tuple(dst)] = v.data[tuple(src)]
        out._vars[k] = DataArray(data, dims=proto.dims, name=k,
                                 attrs=dict(proto.attrs))
    return out
