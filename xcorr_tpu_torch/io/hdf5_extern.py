r"""
:mod:`io.hdf5_extern` -- what a dataset reaches outside its own storage
=======================================================================

The reader's half of :mod:`io.hdf5` for structures that point elsewhere,
each as HDF5 1.14 resolves it and h5py shows it:

- **serialized selections** (``H5S_SELECT_SERIALIZE``: all, none,
  points, regular and irregular hyperslabs; versions 1-3), which region
  references and virtual datasets share: :func:`selection`;
- **dataset region references** (old style, reference type 1: a global
  heap object holding the target's address and a selection) as
  :class:`RegionReference`, whose ``repr`` is h5py's;
- **external storage** (the external data files message, 0x07: names in
  a local heap, an offset and a size per file; a file shorter than its
  slot reads as zeros): :func:`read_external`;
- **external links** (link type 64) to a dataset in the root group of
  another file: :func:`linked`;
- **virtual datasets** (data layout class 3: a global heap object
  listing each mapping's source file and dataset and its source and
  virtual selections; ``"."`` is the file itself; where no source maps,
  or a source file is missing, the fill value): :func:`read_virtual`.

File names resolve as HDF5 1.14 resolves them, each kind by its own
rules (``H5F_prefix_open_file``, ``H5D__build_file_prefix``):

- external storage: the name joined to ``HDF5_EXTFILE_PREFIX`` where it
  is set (``${ORIGIN}`` at its start is the directory of the file that
  names it), else the name as it is, from the working directory;
- external links and virtual dataset sources: an absolute name as it
  is, then its last part (or a relative name) joined to each entry of
  ``HDF5_EXT_PREFIX`` (links) or ``HDF5_VDS_PREFIX`` (sources; the
  variable also applies whole, ``${ORIGIN}`` expanded), then to the
  directory of the file that names it, then from the working directory,
  then from the directory of that file's real path.

An unlimited mapping takes its source's current extent, and a
printf-style one (``%b`` in a source name) one source per block, as far
as the sources exist in a row (:func:`virtual_plan`).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["RegionReference", "Selection", "selection", "region",
           "parse_external", "read_external", "linked", "virtual_plan",
           "read_virtual"]

_NONE, _POINTS, _HYPER, _ALL = 0, 1, 2, 3
_REGULAR = 0x01


class Selection:
    """A decoded selection: ``kind`` ``"all"``, ``"none"``, ``"points"``
    (``coords`` an ``(n, rank)`` array in the stored order) or
    ``"hyperslab"``: ``blocks`` an ``(n, 2, rank)`` array of inclusive
    starts and ends, or ``regular`` a ``(rank, 4)`` array of start,
    stride, count and block per dimension, -1 for an unlimited count or
    block (:attr:`unlimited` is then that dimension)."""

    __slots__ = ("kind", "coords", "blocks", "regular")

    def __init__(self, kind, coords=None, blocks=None, regular=None):
        self.kind, self.coords, self.blocks = kind, coords, blocks
        self.regular = regular

    @property
    def unlimited(self):
        """The dimension whose count or block is unlimited, or ``None``."""
        if self.regular is None:
            return None
        dims = np.nonzero((self.regular[:, 2:] < 0).any(axis=1))[0]
        return int(dims[0]) if len(dims) else None

    def axes(self, shape):
        """A regular hyperslab's selected indices per dimension, each
        sorted; an unlimited dimension up to ``shape``'s extent (its last
        block cut there, as the library clips it)."""
        out = []
        for (st, sd, c, bl), n in zip(self.regular.tolist(), shape):
            if bl < 0:
                idx = np.arange(st, max(st, n))
            elif c < 0:
                nb = -(-(n - st) // sd) if st < n else 0
                idx = (st + sd * np.arange(nb)[:, None]
                       + np.arange(bl)).reshape(-1)
                idx = idx[idx < n]
            else:
                idx = (st + sd * np.arange(c)[:, None]
                       + np.arange(bl)).reshape(-1)
                if idx.size and idx.max() >= n:
                    raise OSError("a hyperslab outside its dataspace")
            out.append(np.unique(idx))
        return out

    def flat(self, shape):
        """Row-major indices into ``shape`` of the selected elements, in
        the library's order: a point selection as its points are listed,
        a hyperslab in row-major order (overlaps once)."""
        shape = tuple(int(s) for s in shape)
        n = int(np.prod(shape, dtype=np.int64))
        if self.kind == "all":
            return np.arange(n, dtype=np.int64)
        if self.kind == "none":
            return np.zeros(0, np.int64)
        if self.kind == "points":
            c = self.coords
            if c.shape[1] != len(shape) or (c >= np.array(shape)).any():
                raise OSError("a point selection outside its dataspace")
            return np.ravel_multi_index(tuple(c.T), shape).astype(np.int64)
        rank = len(self.regular) if self.regular is not None else \
            self.blocks.shape[2]
        if rank != len(shape):
            raise OSError("a selection of another rank than its dataspace")
        if self.regular is not None:
            return _product(self.axes(shape), shape)
        mask = np.zeros(shape, bool)
        for start, end in self.blocks:
            if any(e >= s for e, s in zip(end, shape)):
                raise OSError("a hyperslab outside its dataspace")
            mask[tuple(slice(a, b + 1) for a, b in zip(start, end))] = True
        return np.flatnonzero(mask)

    def coordinates(self, shape):
        """``(n, rank)`` coordinates of :meth:`flat`."""
        return np.stack(np.unravel_index(self.flat(shape), shape), axis=1)


def _product(axes, shape):
    """Row-major flat indices of the product of per-dimension indices."""
    if not all(len(a) for a in axes):
        return np.zeros(0, np.int64)
    grid = np.meshgrid(*axes, indexing="ij")
    return np.ravel_multi_index(grid, shape).reshape(-1).astype(np.int64)


def _enc(b, p, w):
    return int.from_bytes(b[p:p + w], "little"), p + w


def selection(b, p):
    """The serialized selection at ``b[p:]``: ``(Selection, end)``."""
    kind, ver = struct.unpack_from("<II", b, p)
    p += 8
    if kind in (_ALL, _NONE):
        if ver not in (1, 2):
            raise NotImplementedError(f"selection version {ver}")
        return Selection("all" if kind == _ALL else "none"), p + 8
    if kind == _POINTS:
        if ver == 1:
            w, p = 4, p + 8             # reserved, length
        elif ver == 2:
            w, p = b[p], p + 1
        else:
            raise NotImplementedError(f"point selection version {ver}")
        rank, p = _enc(b, p, 4)
        n, p = _enc(b, p, w)
        c = np.frombuffer(bytes(b[p:p + n * rank * w]), f"<u{w}",
                          n * rank).astype(np.int64).reshape(n, rank)
        return Selection("points", coords=c), p + n * rank * w
    if kind != _HYPER:
        raise NotImplementedError(f"selection type {kind}")
    flags = 0
    if ver == 1:
        w, p = 4, p + 8                 # reserved, length
    elif ver in (2, 3):
        flags = b[p]
        if ver == 3:
            w, p = b[p + 1], p + 2
        else:
            w, p = 8, p + 5             # flags, length
    else:
        raise NotImplementedError(f"hyperslab selection version {ver}")
    if w not in (2, 4, 8):
        raise OSError(f"selection of {w}-byte values")
    unlim = (1 << 8 * w) - 1
    rank, p = _enc(b, p, 4)
    if flags & _REGULAR:                # start, stride, count, block
        v = np.frombuffer(bytes(b[p:p + 4 * rank * w]), f"<u{w}",
                          4 * rank).reshape(rank, 4)
        p += 4 * rank * w
        reg = v.astype(np.int64)
        reg[v == unlim] = -1
        return Selection("hyperslab", regular=reg), p
    n, p = _enc(b, p, w)
    arr = np.frombuffer(bytes(b[p:p + 2 * n * rank * w]), f"<u{w}",
                        2 * n * rank).astype(np.int64).reshape(n, 2, rank)
    return Selection("hyperslab", blocks=arr), p + 2 * n * rank * w


# ---------------------------------------------------------------------------
# region references


class RegionReference:
    """A dataset region reference as read: ``target`` the name of the
    referenced dataset in the root group (``None`` for a null
    reference), ``selection`` its :class:`Selection` and ``shape`` the
    target's shape, so :meth:`coordinates` lists the selected elements.
    Its ``repr`` is h5py's, so a view of the file reads the same
    through either reader; no file stays open behind it."""

    __slots__ = ("target", "selection", "shape")

    def __init__(self, target=None, selection=None, shape=None):
        self.target, self.selection, self.shape = target, selection, shape

    def __bool__(self):
        return self.target is not None

    def __repr__(self):
        # h5py's text, its unclosed parenthesis included
        return "<HDF5 region reference%s>" % ("" if self else " (null")

    def coordinates(self):
        """``(n, rank)`` coordinates of the selected elements, in the
        selection's order."""
        return self.selection.coordinates(self.shape)


def region(f, raw):
    """The :class:`RegionReference` of one stored element ``raw``: a
    global heap collection address and an object index (all zeros for a
    null reference)."""
    so = f._so
    if not any(raw):
        return RegionReference()
    addr = int.from_bytes(raw[:so], "little")
    idx = struct.unpack_from("<I", raw, so)[0]
    obj = bytes(f._heap_object(addr, idx))
    target = int.from_bytes(obj[:so], "little")
    sel, _ = selection(obj, so)
    name = f._names.get(target, f"<object at {target}>")
    return RegionReference(name, sel, f._object(target).shape)


# ---------------------------------------------------------------------------
# file names


def _extpath(f):
    """The directory of the file as it was opened, absolute."""
    return os.path.dirname(os.path.abspath(f.filename))


def _combine(prefix, name):
    if not prefix or os.path.isabs(name):
        return name
    return os.path.join(prefix, name)


def _origin(f, prefix):
    """An environment prefix: ``None`` where unset, empty or ``"."``;
    ``${ORIGIN}`` at its start the directory of ``f``."""
    if not prefix or prefix == ".":
        return None
    if prefix.startswith("${ORIGIN}"):
        return _extpath(f) + os.sep + prefix[len("${ORIGIN}"):]
    return prefix


def _search(f, name, env, prop=None):
    """Candidate paths of ``name`` named in ``f``, in the library's order
    (``H5F_prefix_open_file``)."""
    out = []
    base = name
    if os.path.isabs(name):
        out.append(name)
        base = os.path.basename(name)
    for pre in (os.environ.get(env) or "").split(":"):
        if pre:
            out.append(_combine(pre, base))
    if prop:
        out.append(_combine(prop, base))
    out.append(_combine(_extpath(f), base))
    out.append(base)
    out.append(_combine(os.path.dirname(os.path.realpath(f.filename)), base))
    return out


def _open_other(f, name, env, prop=None):
    """The first candidate of :func:`_search` that opens as HDF5, kept
    open with ``f`` (``None`` where none does)."""
    for path in _search(f, name, env, prop):
        key = os.path.realpath(path)
        if key == os.path.realpath(f.filename):
            return f
        if key in f._others:
            return f._others[key]
        if not os.path.isfile(path):
            continue
        try:
            g = type(f)(path)
        except OSError:
            continue
        f._others[key] = g
        return g
    return None


def _root_member(g, path, what):
    name = path[1:] if path.startswith("/") else path
    if "/" in name.rstrip("/"):
        raise NotImplementedError(
            f"{what} {path!r}: groups below the root group")
    if name not in g._entries:
        raise KeyError(f"{what} {path!r} is not in {g.filename}")
    return g._object(g._entries[name])


def linked(f, file, path):
    """The dataset an external link names: ``path`` in the root group of
    ``file``, found by the external link rules."""
    g = _open_other(f, file, "HDF5_EXT_PREFIX")
    if g is None:
        raise KeyError(f"Unable to open object (can't open file {file!r} "
                       "of an external link)")
    return _root_member(g, path, "external link target")


# ---------------------------------------------------------------------------
# external storage


def parse_external(f, p):
    """The external data files message: ``(local heap address, [(name
    offset, file offset, size)])``."""
    b = f._b
    if b[p] != 1:
        raise NotImplementedError(f"external data files message version "
                                  f"{b[p]}")
    used = struct.unpack_from("<H", b, p + 6)[0]
    heap = f._o(p + 8)
    q, sl, slots = p + 8 + f._so, f._sl, []
    for _ in range(used):
        slots.append((f._l(q), f._l(q + sl), f._l(q + 2 * sl)))
        q += 3 * sl
    return heap, slots


def read_external(f, efl, nbytes):
    """``nbytes`` of raw data from the files of an external data files
    message ``efl``: each slot's bytes in turn, zeros past a file's
    end."""
    heap, slots = efl
    prefix = _origin(f, os.environ.get("HDF5_EXTFILE_PREFIX"))
    out = bytearray(nbytes)
    at = 0
    name_at = f._heap_names(heap)
    for name_off, offset, size in slots:
        if at >= nbytes:
            break
        name = name_at(name_off)
        path = _combine(prefix, name)
        n = min(size, nbytes - at)
        try:
            with open(path, "rb") as fh:
                fh.seek(offset)
                got = fh.read(n)
        except OSError:
            raise OSError(f"Can't read data (unable to open external raw "
                          f"data file {path!r})") from None
        out[at:at + len(got)] = got
        at += n
    if at < nbytes:
        raise OSError("external data files hold fewer bytes than the "
                      "dataset")
    return bytes(out)


# ---------------------------------------------------------------------------
# virtual datasets


def _printf(name):
    return "%b" in name.replace("%%", "")


def _named(name, i=None):
    """A source name with ``%b`` as block ``i`` and ``%%`` as ``%``."""
    parts = name.split("%%")
    if i is not None:
        parts = [q.replace("%b", str(i)) for q in parts]
    return "%".join(parts)


def mappings(f, addr, idx):
    """The mappings of a virtual dataset's global heap object: ``[(source
    file, source dataset, source selection, virtual selection)]``, the
    names as stored, its checksum verified."""
    from .hdf5_v2 import lookup3
    obj = bytes(f._heap_object(addr, idx))
    if len(obj) < 5 or obj[0] != 0:
        raise NotImplementedError(
            f"virtual dataset mapping list version {obj[0] if obj else 0}")
    if lookup3(obj[:-4]) != struct.unpack_from("<I", obj, len(obj) - 4)[0]:
        raise OSError("incorrect metadata checksum in the virtual dataset "
                      "mappings")
    # the number of mappings, then each: source file and dataset names,
    # null-terminated, and the source and virtual selections
    n = int.from_bytes(obj[1:1 + f._sl], "little")
    p = 1 + f._sl
    out = []
    for _ in range(n):
        end = obj.index(b"\0", p)
        file, p = obj[p:end].decode("utf-8"), end + 1
        end = obj.index(b"\0", p)
        dset, p = obj[p:end].decode("utf-8"), end + 1
        src, p = selection(obj, p)
        virt, p = selection(obj, p)
        out.append((file, dset, src, virt))
    return out


def _source(f, file, name, prefix):
    """The source dataset a mapping names, or ``None`` where its file or
    dataset is missing (the library reads the fill value there)."""
    g = f if file == "." else _open_other(f, file, "HDF5_VDS_PREFIX", prefix)
    if g is None:
        return None
    try:
        return _root_member(g, name, "virtual dataset source")
    except KeyError:
        return None


def virtual_plan(dset):
    """A virtual dataset's extent and parts, as the library opens it
    (the view of the last available sources): ``(shape, [(virtual flat
    indices, source dataset or None, source flat indices)])``. An
    unlimited mapping takes the source's current extent: its source
    selection clipped there and its virtual selection cut to as many
    positions; a printf-style one (``%b`` in a name) maps block ``i`` of
    its virtual selection to source ``i``, as far as sources exist in a
    row. The unlimited dimension's extent is the largest such mapping
    reaches, and at least what the bounded mappings reach."""
    f, stored, maxshape = dset._f, dset.shape, dset._maxshape
    prefix = _origin(f, os.environ.get("HDF5_VDS_PREFIX"))
    _, addr, idx = dset._layout
    unlim = [i for i, m in enumerate(maxshape) if m == 0xFFFFFFFFFFFFFFFF]
    parts, reach, bounded = [], [], 0
    for file, name, src_sel, virt_sel in mappings(f, addr, idx):
        u = virt_sel.unlimited
        if u is None:
            parts.append((virt_sel, _source(f, _named(file), _named(name),
                                            prefix), src_sel))
            where = virt_sel.flat(stored) if unlim else ()
            if len(where):
                bounded = max(bounded, int(np.unravel_index(
                    where, stored)[unlim[0]].max()) + 1)
            continue
        st, sd, c, bl = virt_sel.regular[u].tolist()
        if _printf(file) or _printf(name):
            i = 0
            while True:
                src = _source(f, _named(file, i), _named(name, i), prefix)
                if src is None:
                    break
                reg = virt_sel.regular.copy()
                reg[u] = (st + sd * i, 1, 1, bl)
                parts.append((Selection("hyperslab", regular=reg), src,
                              src_sel))
                i += 1
            reach.append(st + sd * (i - 1) + bl if i else 0)
            continue
        src = _source(f, _named(file), _named(name), prefix)
        us = src_sel.unlimited
        if us is None:     # the library refuses to write this mapping
            raise OSError("an unlimited virtual selection over a bounded "
                          "source selection without printf-style names")
        k = len(src_sel.axes(src.shape)[us]) if src is not None else 0
        pos = (st + np.arange(k)) if bl < 0 else (
            st + sd * np.arange(-(-k // bl))[:, None]
            + np.arange(bl)).reshape(-1)[:k]
        reg = virt_sel.regular.copy()
        parts.append((("positions", reg, u, pos), src, src_sel))
        reach.append(int(pos[-1]) + 1 if k else 0)
    shape = list(stored)
    if unlim and reach:
        shape[unlim[0]] = max(max(reach), bounded)
    shape = tuple(shape)
    plan = []
    for virt, src, src_sel in parts:
        if isinstance(virt, tuple):     # cut along its unlimited dimension
            _, reg, u, pos = virt
            sel = Selection("hyperslab", regular=reg)
            axes = sel.axes(shape)
            axes[u] = pos
            where = _product(axes, shape)
        else:
            where = virt.flat(shape)
        pick = src_sel.flat(src.shape) if src is not None else None
        if src is not None and pick.size != where.size:
            raise OSError("a virtual dataset mapping whose selections "
                          "differ in size")
        plan.append((where, src, pick))
    return shape, plan


def read_virtual(dset):
    """The elements of a virtual dataset, in its dtype: the fill value,
    then each mapping's source elements at its virtual selection."""
    t = dset._type
    if t.vlen or t.ref:
        raise NotImplementedError(
            "virtual datasets of variable-length or reference types")
    n = int(np.prod(dset.shape, dtype=np.int64))
    out = np.frombuffer(bytearray(dset._fill_bytes(n)), t.dtype).copy()
    for where, src, pick in dset._plan[1]:
        if src is None or not where.size:
            continue    # a missing source: the fill value
        out[where] = np.asarray(src[...]).reshape(-1)[pick].astype(t.dtype)
    return out.tobytes()
