# Carried from xcorr_tpu/ndlabel/dataset.py (see test_torch_host_copies).
r"""
:mod:`ndlabel.dataset` -- Dataset
=================================

A dict of :class:`DataArray` variables sharing dimensions and coordinates,
modelled on :class:`xarray.Dataset` as used by the reference
(``xcorr/core/init.py:123-326`` builds exactly this structure).
"""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray


class Dataset:
    """Labelled set of N-D data arrays with shared coords and global attrs."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.attrs = dict(attrs) if attrs else {}
        self._coords = {}
        self._vars = {}
        self.encoding = {}
        if coords:
            for k, v in coords.items():
                self.coords[k] = v
        if data_vars:
            for k, v in data_vars.items():
                self[k] = v

    # -- coords ----------------------------------------------------------------

    @property
    def coords(self):
        return _CoordAccessor(self)

    @property
    def data_vars(self):
        return dict(self._vars)

    @property
    def variables(self):
        return {**self._coords, **self._vars}

    @property
    def dims(self):
        sizes = {}
        for da in self.variables.values():
            for d, s in da.sizes.items():
                sizes[d] = s
        return sizes

    @property
    def sizes(self):
        return self.dims

    # -- item access -------------------------------------------------------------

    def __contains__(self, key):
        return key in self._vars or key in self._coords

    def __iter__(self):
        return iter(self._vars)

    def keys(self):
        return self._vars.keys()

    def __getitem__(self, key):
        if key in self._vars:
            da = self._vars[key]
        elif key in self._coords:
            da = self._coords[key]
        else:
            raise KeyError(key)
        out = da.copy(deep=False)
        out._coords = {
            k: c for k, c in self._coords.items()
            if all(d in da.dims for d in c.dims) and k != key
        }
        return out

    def __setitem__(self, key, value):
        if isinstance(value, tuple):
            # (dims, data[, attrs[, encoding]])
            dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
            da = DataArray(value[1], dims=dims, name=key,
                           attrs=value[2] if len(value) > 2 else None)
            if len(value) > 3:
                self.encoding[key] = dict(value[3])
        elif isinstance(value, DataArray):
            da = value.copy(deep=False)
            da.name = key
            # absorb any coords the DataArray carries
            for ck, cv in da._coords.items():
                if ck not in self._coords:
                    self._coords[ck] = cv
            da._coords = {}
        else:
            da = DataArray(value, name=key)
        # validate shared dim sizes
        for d, s in da.sizes.items():
            cur = self.dims.get(d)
            if cur is not None and cur != s:
                raise ValueError(
                    f"variable {key!r}: dim {d!r} size {s} != existing {cur}"
                )
        self._vars[key] = da

    def __delitem__(self, key):
        del self._vars[key]

    def __getattr__(self, key):
        vars_ = self.__dict__.get("_vars", {})
        coords = self.__dict__.get("_coords", {})
        if key in vars_ or key in coords:
            return self[key]
        attrs = self.__dict__.get("attrs", {})
        if key in attrs:
            return attrs[key]
        raise AttributeError(key)

    def __repr__(self):
        lines = ["<ndlabel.Dataset>"]
        lines.append("Dimensions: " + ", ".join(
            f"{d}: {s}" for d, s in self.dims.items()))
        lines.append("Coordinates: " + ", ".join(self._coords))
        lines.append("Data variables: " + ", ".join(self._vars))
        if self.attrs:
            lines.append("Attributes: " + ", ".join(self.attrs))
        return "\n".join(lines)

    # -- transformations -----------------------------------------------------------

    def copy(self, deep=True):
        out = Dataset(attrs=dict(self.attrs))
        out._coords = {k: v.copy(deep=deep) for k, v in self._coords.items()}
        out._vars = {k: v.copy(deep=deep) for k, v in self._vars.items()}
        out.encoding = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in self.encoding.items()}
        return out

    def drop_vars(self, names):
        names = [names] if isinstance(names, str) else list(names)
        out = self.copy(deep=False)
        for n in names:
            out._vars.pop(n, None)
            out._coords.pop(n, None)
        return out

    def rename(self, renames):
        out = Dataset(attrs=dict(self.attrs))
        out._coords = {renames.get(k, k): v.rename(
            {d: renames[d] for d in v.dims if d in renames})
            for k, v in self._coords.items()}
        for k, v in out._coords.items():
            v.name = k
        out._vars = {renames.get(k, k): v.rename(
            {d: renames[d] for d in v.dims if d in renames})
            for k, v in self._vars.items()}
        for k, v in out._vars.items():
            v.name = k
        out.encoding = {renames.get(k, k): (dict(v) if isinstance(v, dict)
                                            else v)
                        for k, v in self.encoding.items()}
        return out

    def isel(self, indexers=None, **kw):
        indexers = dict(indexers or {}, **kw)
        out = Dataset(attrs=dict(self.attrs))
        out.encoding = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in self.encoding.items()}
        for k, v in self._coords.items():
            sub = {d: i for d, i in indexers.items() if d in v.dims}
            out._coords[k] = v.isel(sub) if sub else v
        for k, v in self._vars.items():
            sub = {d: i for d, i in indexers.items() if d in v.dims}
            out._vars[k] = v.isel(sub) if sub else v
        return out

    def sel(self, indexers=None, **kw):
        from .dataarray import _label_to_index
        indexers = dict(indexers or {}, **kw)
        pos = {}
        for d, lab in indexers.items():
            if d not in self._coords:
                raise KeyError(f"no coordinate for dimension {d!r}")
            pos[d] = _label_to_index(self._coords[d].data, lab)
        return self.isel(pos)

    def where(self, cond, other=np.nan, drop=False):
        out = self.copy(deep=False)
        for k, v in self._vars.items():
            if all(d in v.dims for d in cond.dims):
                da = self[k].where(cond, other=other)
                da._coords = {}
                out._vars[k] = da
        if drop:
            for d in cond.dims:
                axes = tuple(i for i, dd in enumerate(cond.dims) if dd != d)
                keep = np.any(cond.data, axis=axes) if axes else cond.data
                idx = np.nonzero(keep)[0]
                out = out.isel({d: idx})
        return out

    def chunk(self, *a, **kw):
        """No-op chunking shim (dask compatibility surface)."""
        return self

    def load(self):
        return self

    def close(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def to_netcdf(self, path, **kw):
        from ..io.netcdf import to_netcdf
        return to_netcdf(self, path, **kw)


class _CoordAccessor:
    """dict-like view over a Dataset's coordinates."""

    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, k):
        return self._ds._coords[k]

    def __setitem__(self, k, v):
        if isinstance(v, tuple) and len(v) in (2, 3):
            dims = (v[0],) if isinstance(v[0], str) else tuple(v[0])
            da = DataArray(v[1], dims=dims, name=k,
                           attrs=v[2] if len(v) > 2 else None)
        elif isinstance(v, DataArray):
            da = v.copy(deep=False)
            da.name = k
            da._coords = {}
        else:
            arr = np.asarray(v)
            dims = (k,) if arr.ndim == 1 else tuple(
                f"dim_{i}" for i in range(arr.ndim))
            da = DataArray(arr, dims=dims, name=k)
        # size validation against existing dimensions (matching
        # Dataset.__setitem__ for variables): a silently short/long dim
        # coordinate writes a corrupt netCDF (dimension-scale length !=
        # dimension size) with no error anywhere downstream
        sizes = self._ds.sizes
        for d, size in zip(da.dims, da.data.shape):
            if d in sizes and sizes[d] != size:
                raise ValueError(
                    f"coordinate {k!r} has {size} elements along "
                    f"{d!r}, but the dimension has {sizes[d]}")
        self._ds._coords[k] = da

    def __contains__(self, k):
        return k in self._ds._coords

    def __iter__(self):
        return iter(self._ds._coords)

    def keys(self):
        return self._ds._coords.keys()

    def items(self):
        return self._ds._coords.items()

    def __len__(self):
        return len(self._ds._coords)
