# Carried from xcorr_tpu/ndlabel/dataarray.py (see test_torch_host_copies).
r"""
:mod:`ndlabel.dataarray` -- DataArray
=====================================

A labelled N-D array: numpy data + named dims + coordinate arrays + attrs.

API subset modelled on :class:`xarray.DataArray` as used throughout the
reference (``xcorr/signal/*.py``, ``xcorr/core/*.py``).
"""

from __future__ import annotations

import numpy as np


def _as_np(data):
    """Materialise anything array-like (incl. jax arrays) as numpy."""
    return np.asarray(data)


def _is_monotonic(cv):
    if cv.size < 2:
        return True
    try:
        d = cv[1:] >= cv[:-1]
    except TypeError:
        return False
    return bool(np.all(d))


def _label_to_index(coord_values, label):
    """Map a coordinate label (scalar / slice / array) to positional index.

    Slice labels require a monotonic coordinate (pandas/xarray raise the
    same way); array labels use exact matching so unsorted coordinates
    (pair/receiver strings in user order) resolve correctly —
    ``searchsorted`` silently assumes sorted input.
    """
    cv = np.asarray(coord_values)
    if isinstance(label, slice):
        # label-based slicing is inclusive on both ends (xarray convention)
        if (label.start is not None or label.stop is not None) \
                and not _is_monotonic(cv):
            raise KeyError(
                "cannot slice by label on a non-monotonic coordinate")
        start, stop = 0, cv.size
        if label.start is not None:
            start = int(np.searchsorted(cv, np.asarray(label.start), "left"))
        if label.stop is not None:
            stop = int(np.searchsorted(cv, np.asarray(label.stop), "right"))
        return slice(start, stop, label.step)
    lab = np.asarray(label)
    if lab.ndim == 0:
        idx = np.nonzero(cv == lab)[0]
        if idx.size == 0:
            raise KeyError(f"label {label!r} not found in coordinate")
        return int(idx[0])
    if lab.dtype == bool:
        return np.nonzero(lab)[0]
    # exact positional lookup, order-independent (first occurrence wins)
    pos = {}
    for i, v in enumerate(cv.tolist()):
        pos.setdefault(v, i)
    try:
        return np.asarray([pos[v] for v in lab.tolist()], dtype=np.int64)
    except KeyError:
        raise KeyError("one or more labels not found in coordinate") \
            from None


class DataArray:
    """Labelled N-D array with dims, coords and attrs."""

    __array_priority__ = 50  # beat raw ndarray in mixed arithmetic

    def __init__(self, data, coords=None, dims=None, name=None, attrs=None):
        if isinstance(data, DataArray):
            coords = coords or data._coords
            dims = dims or data.dims
            name = name or data.name
            attrs = attrs if attrs is not None else dict(data.attrs)
            data = data.data
        self.data = _as_np(data)
        if dims is None:
            if coords and len(coords) == self.data.ndim:
                dims = tuple(coords)
            else:
                dims = tuple(f"dim_{i}" for i in range(self.data.ndim))
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"dims {self.dims} do not match data ndim {self.data.ndim}"
            )
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self._coords = {}
        if coords:
            for k, v in coords.items():
                self._set_coord(k, v)
        # validate dim coord sizes
        for k, v in self._coords.items():
            for d, s in zip(v.dims, v.shape):
                if d in self.dims and s != self.sizes[d]:
                    raise ValueError(
                        f"coord {k!r} size {s} mismatches dim {d!r} size "
                        f"{self.sizes[d]}"
                    )

    # -- construction helpers ------------------------------------------------

    def _set_coord(self, k, v):
        if isinstance(v, DataArray):
            c = DataArray(v.data, dims=v.dims, name=k, attrs=dict(v.attrs))
        elif isinstance(v, tuple) and len(v) in (2, 3) and not np.isscalar(v[0]):
            # (dims, data[, attrs])
            cdims, cdata = v[0], v[1]
            cattrs = v[2] if len(v) == 3 else None
            c = DataArray(cdata, dims=cdims, name=k, attrs=cattrs)
        else:
            arr = _as_np(v)
            if arr.ndim == 0:
                c = DataArray(arr, dims=(), name=k)
            elif arr.ndim == 1:
                c = DataArray(arr, dims=(k,), name=k)
            else:
                raise ValueError(
                    f"coord {k!r}: cannot infer dims for {arr.ndim}-d data"
                )
        self._coords[k] = c

    def copy(self, deep=True, data=None):
        d = self.data if data is None else _as_np(data)
        if deep and data is None:
            d = d.copy()
        out = DataArray(d, dims=self.dims, name=self.name,
                        attrs=dict(self.attrs))
        out._coords = {k: v.copy(deep=deep) for k, v in self._coords.items()}
        return out

    # -- basic properties ----------------------------------------------------

    @property
    def values(self):
        return self.data

    @values.setter
    def values(self, v):
        v = _as_np(v)
        if v.shape != self.data.shape:
            raise ValueError("shape mismatch in values setter")
        self.data = v

    @property
    def coords(self):
        return self._coords

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return self.data.size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    def item(self):
        return self.data.item()

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        dims = ", ".join(f"{d}: {s}" for d, s in self.sizes.items())
        lines = [f"<ndlabel.DataArray {self.name!r} ({dims})>",
                 repr(self.data)]
        if self._coords:
            lines.append("Coordinates: " + ", ".join(self._coords))
        if self.attrs:
            lines.append("Attributes: " + ", ".join(self.attrs))
        return "\n".join(lines)

    # attribute-style access to attrs and coords (xarray convention)
    def __getattr__(self, key):
        # only called when normal lookup fails
        coords = self.__dict__.get("_coords", {})
        if key in coords:
            return coords[key]
        attrs = self.__dict__.get("attrs", {})
        if key in attrs:
            return attrs[key]
        raise AttributeError(key)

    # -- indexing ------------------------------------------------------------

    def _positional(self, indexers):
        """Build a full positional index tuple from a {dim: idx} mapping."""
        idx = [slice(None)] * self.ndim
        for d, i in indexers.items():
            if d not in self.dims:
                raise KeyError(f"no dimension {d!r} in {self.dims}")
            idx[self.dims.index(d)] = i
        return tuple(idx)

    @property
    def loc(self):
        """Label-based get/set: ``da.loc[{'pair': p, 'time': t}]``
        (xarray convention, used pervasively by reference-style user
        code, e.g. ``xcorr/core/process.py:93-165``)."""
        return _LocIndexer(self)

    def isel(self, indexers=None, **kw):
        indexers = dict(indexers or {}, **kw)
        data = self.data
        new_dims = list(self.dims)
        # apply one dim at a time: no numpy advanced-indexing cross products
        for d, i in indexers.items():
            if d not in new_dims:
                raise KeyError(f"no dimension {d!r} in {self.dims}")
            ax = new_dims.index(d)
            sl = [slice(None)] * data.ndim
            sl[ax] = i
            data = data[tuple(sl)]
            if isinstance(i, (int, np.integer)):
                new_dims.pop(ax)
        out = DataArray(data, dims=tuple(new_dims), name=self.name,
                        attrs=dict(self.attrs))
        for k, c in self._coords.items():
            sub = {d: i for d, i in indexers.items() if d in c.dims}
            cc = c.isel(sub) if sub else c
            out._coords[k] = cc
        return out

    def sel(self, indexers=None, **kw):
        indexers = dict(indexers or {}, **kw)
        pos = {}
        for d, lab in indexers.items():
            if d not in self._coords:
                raise KeyError(f"no coordinate for dimension {d!r}")
            pos[d] = _label_to_index(self._coords[d].data, lab)
        return self.isel(pos)

    def squeeze(self, dim=None):
        dims = [dim] if isinstance(dim, str) else (
            dim if dim is not None
            else [d for d, s in self.sizes.items() if s == 1])
        out = self
        for d in dims:
            if out.sizes[d] != 1:
                raise ValueError(f"cannot squeeze dim {d!r} of size >1")
            out = out.isel({d: 0})
        return out

    def expand_dims(self, dim, axis=0):
        if isinstance(dim, str):
            dim = {dim: 1}
        out = self
        for d, n in dim.items():
            data = np.expand_dims(out.data, axis)
            if n != 1:
                data = np.repeat(data, n, axis)
            dims = out.dims[:axis] + (d,) + out.dims[axis:]
            new = DataArray(data, dims=dims, name=out.name,
                            attrs=dict(out.attrs))
            new._coords = dict(out._coords)
            out = new
        return out

    def transpose(self, *dims):
        if not dims:
            dims = self.dims[::-1]
        axes = [self.dims.index(d) for d in dims]
        out = DataArray(self.data.transpose(axes), dims=dims, name=self.name,
                        attrs=dict(self.attrs))
        out._coords = dict(self._coords)
        return out

    def rename(self, name=None, **dim_renames):
        out = self.copy(deep=False)
        if isinstance(name, dict):
            dim_renames = {**name, **dim_renames}
            name = None
        if name is not None:
            out.name = name
        if dim_renames:
            out.dims = tuple(dim_renames.get(d, d) for d in self.dims)
            newc = {}
            for k, c in out._coords.items():
                c2 = c.copy(deep=False)
                c2.dims = tuple(dim_renames.get(d, d) for d in c.dims)
                k2 = dim_renames.get(k, k)
                c2.name = k2
                newc[k2] = c2
            out._coords = newc
        return out

    def astype(self, dtype):
        out = self.copy(deep=False, data=self.data.astype(dtype))
        return out

    def fillna(self, value):
        data = np.where(np.isnan(self.data), value, self.data)
        return self.copy(deep=False, data=data)

    # -- broadcasting arithmetic ----------------------------------------------

    def _broadcast_with(self, other):
        """Align self and other onto the union of their dims (self order
        first, then other's extra dims appended)."""
        odims = other.dims
        out_dims = list(self.dims) + [d for d in odims if d not in self.dims]

        def expand(da):
            data = da.data
            # move existing axes into out order, add length-1 axes for missing
            shape = []
            src_axes = []
            for d in out_dims:
                if d in da.dims:
                    src_axes.append(da.dims.index(d))
                    shape.append(da.sizes[d])
                else:
                    shape.append(1)
            if src_axes:
                data = np.transpose(data, src_axes)
            reshape = [da.sizes[d] if d in da.dims else 1 for d in out_dims]
            return data.reshape(reshape)

        return expand(self), expand(other), tuple(out_dims)

    def _binop(self, other, op, reflexive=False):
        if isinstance(other, DataArray):
            a, b, dims = self._broadcast_with(other)
            data = op(b, a) if reflexive else op(a, b)
            out = DataArray(data, dims=dims, name=self.name)
            for k, c in {**other._coords, **self._coords}.items():
                if all(d in dims for d in c.dims):
                    out._coords[k] = c
            return out
        data = op(other, self.data) if reflexive else op(self.data, other)
        out = DataArray(data, dims=self.dims, name=self.name)
        out._coords = dict(self._coords)
        return out

    def __add__(self, o): return self._binop(o, np.add)
    def __radd__(self, o): return self._binop(o, np.add, True)
    def __sub__(self, o): return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._binop(o, np.subtract, True)
    def __mul__(self, o): return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._binop(o, np.multiply, True)
    def __truediv__(self, o): return self._binop(o, np.divide)
    def __rtruediv__(self, o): return self._binop(o, np.divide, True)
    def __pow__(self, o): return self._binop(o, np.power)
    def __neg__(self): return self.copy(deep=False, data=-self.data)
    def __abs__(self): return self.copy(deep=False, data=np.abs(self.data))
    def __ge__(self, o): return self._binop(o, np.greater_equal)
    def __gt__(self, o): return self._binop(o, np.greater)
    def __le__(self, o): return self._binop(o, np.less_equal)
    def __lt__(self, o): return self._binop(o, np.less)
    def __eq__(self, o): return self._binop(o, np.equal)
    def __ne__(self, o): return self._binop(o, np.not_equal)
    def __and__(self, o): return self._binop(o, np.logical_and)
    def __or__(self, o): return self._binop(o, np.logical_or)
    def __invert__(self):
        return self.copy(deep=False, data=np.logical_not(self.data))

    __hash__ = None

    def __array__(self, dtype=None):
        return self.data if dtype is None else self.data.astype(dtype)

    # -- reductions ------------------------------------------------------------

    def _reduce(self, fn, dim=None, **kw):
        if dim is None:
            return DataArray(fn(self.data, **kw), dims=(), name=self.name)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        data = fn(self.data, axis=axes, **kw)
        out_dims = tuple(d for d in self.dims if d not in dims)
        out = DataArray(data, dims=out_dims, name=self.name,
                        attrs=dict(self.attrs))
        for k, c in self._coords.items():
            if all(d in out_dims for d in c.dims):
                out._coords[k] = c
        return out

    def min(self, dim=None): return self._reduce(np.nanmin, dim)
    def max(self, dim=None): return self._reduce(np.nanmax, dim)
    def mean(self, dim=None): return self._reduce(np.nanmean, dim)
    def std(self, dim=None): return self._reduce(np.nanstd, dim)
    def sum(self, dim=None): return self._reduce(np.nansum, dim)
    def median(self, dim=None): return self._reduce(np.nanmedian, dim)
    def any(self, dim=None): return self._reduce(np.any, dim)
    def all(self, dim=None): return self._reduce(np.all, dim)
    def count(self, dim=None):
        return self._reduce(lambda x, **k: np.sum(~np.isnan(x), **k), dim)

    def argmax(self, dim=None):
        vals = self.data
        if np.issubdtype(vals.dtype, np.floating):
            vals = np.where(np.isnan(vals), -np.inf, vals)  # skipna
        if dim is None:
            return DataArray(np.argmax(vals), dims=())
        axis = self.dims.index(dim)
        data = np.argmax(vals, axis=axis)
        out_dims = tuple(d for d in self.dims if d != dim)
        out = DataArray(data, dims=out_dims, name=self.name)
        for k, c in self._coords.items():
            if all(d in out_dims for d in c.dims):
                out._coords[k] = c
        return out

    def idxmax(self, dim):
        """Coordinate label of the maximum along ``dim``."""
        am = self.argmax(dim)
        labels = self._coords[dim].data[am.data]
        out = DataArray(labels, dims=am.dims, name=dim)
        out._coords = dict(am._coords)
        return out

    def diff(self, dim, n=1):
        axis = self.dims.index(dim)
        data = np.diff(self.data, n=n, axis=axis)
        out = DataArray(data, dims=self.dims, name=self.name,
                        attrs=dict(self.attrs))
        for k, c in self._coords.items():
            if dim in c.dims:
                cidx = [slice(None)] * c.ndim
                cidx[c.dims.index(dim)] = slice(n, None)
                out._coords[k] = DataArray(c.data[tuple(cidx)], dims=c.dims,
                                           name=k, attrs=dict(c.attrs))
            else:
                out._coords[k] = c
        return out

    def cumsum(self, dim):
        axis = self.dims.index(dim)
        out = self.copy(deep=False,
                        data=np.cumsum(self.data, axis=axis))
        return out

    # -- masking ----------------------------------------------------------------

    def where(self, cond, other=np.nan, drop=False):
        if isinstance(cond, DataArray):
            a, b, dims = self._broadcast_with(cond)
            a, b = np.broadcast_arrays(a, b)
            data = np.where(b, a, other)
            out = DataArray(data, dims=dims, name=self.name,
                            attrs=dict(self.attrs))
            for k, c in {**cond._coords, **self._coords}.items():
                if all(d in dims for d in c.dims):
                    out._coords[k] = c
            if drop:
                out = _drop_all_false(out, cond)
            return out
        data = np.where(cond, self.data, other)
        out = self.copy(deep=False, data=data)
        return out

    def notnull(self):
        return self.copy(deep=False, data=~np.isnan(self.data))

    def isnull(self):
        return self.copy(deep=False, data=np.isnan(self.data))


class _LocIndexer:
    """Label-based indexing adapter for DataArray."""

    def __init__(self, da):
        self._da = da

    def _positional(self, key):
        if not isinstance(key, dict):
            raise TypeError("loc expects a {dim: label} mapping")
        idx = [slice(None)] * self._da.ndim
        for d, lab in key.items():
            if hasattr(lab, "values") and hasattr(lab, "dims"):
                lab = lab.values
            pos = _label_to_index(self._da.coords[d].data, lab)
            idx[self._da.dims.index(d)] = pos
        return tuple(idx)

    def __getitem__(self, key):
        pos = {d: i for d, i in zip(self._da.dims, self._positional(key))}
        return self._da.isel({d: p for d, p in pos.items()
                              if not (isinstance(p, slice)
                                      and p == slice(None))})

    def __setitem__(self, key, value):
        idx = list(self._positional(key))
        # xarray outer-product semantics: multiple array indexers select
        # the block, not the numpy-broadcast diagonal. np.ix_ over EVERY
        # axis (slices expanded to ranges) also sidesteps numpy's
        # advanced-index placement rule for non-adjacent arrays.
        n_arr = sum(isinstance(p, np.ndarray) and p.ndim == 1
                    for p in idx)
        if n_arr > 1:
            full = []
            for i, p in enumerate(idx):
                if isinstance(p, slice):
                    full.append(np.arange(
                        *p.indices(self._da.data.shape[i])))
                elif isinstance(p, np.ndarray) and p.ndim == 1:
                    full.append(p)
                else:  # scalar position: keep the axis, length 1
                    full.append(np.asarray([p]))
            self._da.data[np.ix_(*full)] = np.asarray(value)
            return
        self._da.data[tuple(idx)] = np.asarray(value)


def _drop_all_false(out, cond):
    """xarray where(drop=True): trim each cond dim to the label range where
    cond is True anywhere."""
    for d in cond.dims:
        axes = tuple(i for i, dd in enumerate(cond.dims) if dd != d)
        keep = np.any(cond.data, axis=axes) if axes else cond.data
        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            raise ValueError(f"where(drop=True) removed every {d!r} slice")
        out = out.isel({d: idx})
    return out
