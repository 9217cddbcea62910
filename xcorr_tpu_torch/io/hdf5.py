r"""
:mod:`io.hdf5` -- the shards' HDF5, in numpy and zlib
=====================================================

A writer and a reader of HDF5 (*HDF5 File Format Specification, Version
3.0*) for netCDF-4 shards and the files other tools write, so the shard
store needs no HDF5 library. The writer writes, and this module reads:

- superblock version 0 (and 1 on read);
- the root group as a symbol table: a version-1 B-tree of ``SNOD`` nodes
  over a local heap;
- version-1 object headers, with continuation blocks on read;
- dataspace, datatype, fill value, data layout (compact, contiguous, and
  chunked with a version-1 B-tree chunk index), filter pipeline (shuffle,
  id 2, and deflate, id 1) and attribute messages;
- fixed-point, floating-point, fixed-length string, enumeration (h5py's
  bool), compound (complex numbers, ``REFERENCE_LIST``), object reference
  and variable-length datatypes, whose strings and sequences live in
  global heap collections (``GCOL``);
- the dimension-scale attributes ``CLASS``, ``NAME``, ``DIMENSION_LIST``
  and ``REFERENCE_LIST``, as h5py's ``make_scale`` and ``attach_scale``
  write them, so netCDF tools and h5py's ``.dims`` see the scales.

The reader also reads what HDF5 1.8 and later write (h5py's newer
``libver`` settings, ``track_order``, every file of the netCDF-C
library), through :mod:`io.hdf5_v2`: superblocks 2 and 3, version-2
object headers, new-style groups (compact and dense links), dense
attributes, the newer message versions (attribute 2-3, datatype 3-4,
fill value 3, filter pipeline 2, data layout 4 with every chunk index).
Groups and attributes list in h5py's order: creation order where the
object tracks it, by name otherwise. Offsets and lengths of 2, 4 or 8
bytes are read wherever they are stored. Chunks are undone by
:mod:`io.hdf5_filters` (deflate, shuffle, fletcher32; szip, scaleoffset
and lzf in the native library; nbit at full precision), each filter
only where the chunk's mask says it was applied, so optional filters a
writer skipped (blosc, zstd, any id) read too. Bitfields read as
unsigned integers, opaque data as ``V<n>`` (h5py's tagged datetimes as
theirs), null dataspaces as :class:`Empty`; region references, external
storage, external links and virtual datasets through
:mod:`io.hdf5_extern`.

A dataset reads whole (``dset[...]``) or by h5py's basic selection
(ints and step-1 slices); a chunked one through :mod:`io.hdf5_chunks`,
into one array; a selection decodes only the chunks it meets, each only
as far as it needs, and a whole read decodes every chunk whole, so it
refuses every chunk the plain read refuses. :data:`FORMS` names the
read's forms whose plain versions (the whole read as it was, then
numpy's index) stay beside them.

The API is the part of h5py's that :mod:`io.netcdf` uses, and values map
to and from numpy as h5py maps them (a ``str`` attribute is a UTF-8
variable-length string, a Python ``int`` an ``int64``, a ``bool`` h5py's
enumeration; a string dataset reads as ``bytes``; chunks are guessed as
h5py guesses them). ``File(path, "w")`` lays the whole file out when it
closes: metadata first, raw data after it, every address known before
any byte is written. A file is never edited in place; the writer writes
only the structures of the list above, as h5py does by default.

A structure outside what is read raises :class:`NotImplementedError`
naming it: shared object header messages (h5py writes no
shared-message table; a message flagged shared without one fails in
h5py too), groups below the root group and the time and array
datatypes (the JAX package fails on each as well), filtered fractal
heaps (no tool here writes one), a chunk that a filter outside the list
above filtered, packed nbit chunks (HDF5 1.14.6 writes none without a
file-integrity setting h5py does not expose), and offsets or lengths of
16 bytes. A file that is not HDF5, is cut short, or fails a checksum
raises :class:`OSError`.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from itertools import product

import numpy as np

from . import hdf5_extern, hdf5_v2
from . import hdf5_chunks as hc
from . import hdf5_filters as hf

__all__ = ["Empty", "File", "string_dtype"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
#: group leaf node K (a ``SNOD`` holds 2K entries) and internal node K of
#: the group B-tree, and the indexed-storage K of the chunk B-trees: the
#: library's defaults, which a version-0 superblock implies for chunks
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32
#: smallest global heap collection (the library reads this much at once)
_GCOL_MIN = 4096
#: the plain chunked read decompresses in threads from this many stored
#: bytes
_PARALLEL_READ_MIN = 4 << 20
_READ_THREADS = 8

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT = 0x6, 0x7, 0x8
_PIPELINE, _ATTRIBUTE, _CONTINUATION = 0xB, 0xC, 0x10
_SYMBOL_TABLE, _ATTR_INFO = 0x11, 0x15

#: a variable-length element as the writer stores it (8-byte addresses)
_VLEN = np.dtype([("n", "<u4"), ("addr", "<u8"), ("idx", "<u4")])

# h5py's chunk guess (``h5py._hl.filters.guess_chunk``)
_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def string_dtype():
    """The dtype of a variable-length UTF-8 string dataset (h5py's
    ``string_dtype()``)."""
    return np.dtype("O", metadata={"vlen": str})


class Empty:
    """A dataset or attribute with a null dataspace: a dtype and no
    shape or data (h5py's ``Empty``, its ``repr`` included, so a view of
    the file reads the same through either reader)."""

    shape = None
    size = None

    def __init__(self, dtype):
        dtype = np.dtype(dtype)
        if dtype.kind == "f" and dtype.metadata is None:
            # h5py's float dtypes name their byte order in their repr
            dtype = dtype.newbyteorder(
                dtype.byteorder if dtype.byteorder in "<>" else "<")
        self.dtype = dtype

    def __eq__(self, other):
        return (type(other).__name__ == "Empty"
                and getattr(other, "dtype", None) == self.dtype)

    __hash__ = None

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def File(path, mode="r"):
    """Open ``path`` for reading (``"r"``), create it (``"w"``: the file
    is written when the returned object closes) or add to it (``"a"``:
    its datasets and attributes are taken over, and the whole file is
    written anew beside it and moved into its place on close; a file
    with a member that would not be written as it was, such as a soft
    or external link, is refused and left as it is)."""
    if mode == "r":
        return _ReadFile(path)
    if mode in ("w", "a"):
        return _WriteFile(path, append=mode == "a")
    raise ValueError(f"mode {mode!r}: the codec reads ('r'), writes ('w') "
                     "or rewrites ('a') files")


def _align8(n):
    return (n + 7) & ~7


def _pad8(b):
    return b + b"\0" * (_align8(len(b)) - len(b))


def _nelem(shape):
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def guess_chunk(shape, typesize):
    """h5py's chunk shape for a dataset created with filters and no
    chunks (its ``guess_chunk``, without maximum shapes)."""
    shape = tuple((x if x != 0 else 1024) for x in shape)
    chunks = np.array(shape, dtype="=f8")
    dset_size = np.prod(chunks) * typesize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target
                < 0.5) and chunk_bytes < _CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _shuffle(buf, size):
    """The shuffle filter: byte planes of ``size``-byte elements; a tail
    shorter than one element stays where it is."""
    if size <= 1 or len(buf) < size:
        return bytes(buf)
    n = len(buf) // size
    a = np.frombuffer(buf, np.uint8, n * size).reshape(n, size)
    return np.ascontiguousarray(a.T).tobytes() + bytes(buf[n * size:])


# ---------------------------------------------------------------------------
# datatypes


class _Type:
    """A decoded datatype. ``dtype`` is the element as stored (the
    descriptor for variable-length types and region references);
    ``vlen`` is ``None``, ``"str"`` or ``"seq"`` (then ``base`` is the
    element type); ``ref`` is ``"object"`` for object references (read
    as addresses) and ``"region"`` for dataset region references;
    ``unreadable`` says why h5py converts no element of the type (an
    opaque type of a foreign tag), where it cannot."""

    __slots__ = ("dtype", "vlen", "base", "ref", "unreadable")

    def __init__(self, dtype, vlen=None, base=None, ref=None,
                 unreadable=None):
        self.dtype, self.vlen, self.base = dtype, vlen, base
        self.ref, self.unreadable = ref, unreadable

    @property
    def out(self):
        """The numpy dtype a reader gets."""
        return np.dtype("O") if self.vlen or self.ref == "region" \
            else self.dtype


def _vlen_dtype(so):
    """A variable-length element on disk: length, global heap collection
    address (``so`` bytes), object index."""
    return np.dtype([("n", "<u4"), ("addr", f"<u{so}"), ("idx", "<u4")])


def _parse_type(f, p):
    """The datatype message at ``f._b[p:]``: ``(_Type, bytes used)``;
    references and variable-length descriptors hold addresses of the
    file's width."""
    b = f._b
    cls, ver = b[p] & 0x0F, b[p] >> 4
    if ver not in (1, 2, 3, 4):
        raise NotImplementedError(f"datatype message version {ver}")
    bits = b[p + 1] | (b[p + 2] << 8) | (b[p + 3] << 16)
    size = struct.unpack_from("<I", b, p + 4)[0]
    q = p + 8
    order = ">" if bits & 1 else "<"
    if cls in (0, 4):    # fixed point; bitfield, which h5py reads as uint
        kind = "i" if cls == 0 and bits & 0x08 else "u"
        return _Type(np.dtype(f"{order}{kind}{size}")), 12
    if cls == 1:    # floating point
        return _Type(np.dtype(f"{order}f{size}")), 20
    if cls == 3:    # fixed-length string
        return _Type(np.dtype(f"S{size}")), 8
    if cls == 5:    # opaque: an ASCII tag, null-padded to 8 bytes
        n = bits & 0xFF
        tag = bytes(b[q:q + n]).rstrip(b"\0")
        if tag.startswith(b"NUMPY:"):   # h5py's opaque_dtype
            dt = np.dtype(tag[6:].decode("ascii"),
                          metadata={"h5py_opaque": True})
            return _Type(dt), 8 + n
        return _Type(np.dtype(f"V{size}"), unreadable=None if not tag else
                     f"no conversion path for the opaque tag {tag!r}"), 8 + n
    if cls == 7:    # reference
        if bits & 0x0F == 1:
            return _Type(np.dtype(f"V{size}"), ref="region"), 8
        if bits & 0x0F != 0:
            raise NotImplementedError(
                f"reference type {bits & 0x0F} (object and dataset region "
                "references only)")
        # an address of the file's width in the first bytes of the
        # element (the library leaves the rest of a wider one undefined)
        return _Type(np.dtype(f"<u{size}"), ref="object"), 8
    if cls == 6:    # compound
        nmemb = bits & 0xFFFF
        names, formats, offsets = [], [], []
        # version 3 on: names unpadded, offsets in the fewest bytes
        owidth = hdf5_v2._enc_size(size) if ver >= 3 else 4
        for _ in range(nmemb):
            end = b.find(b"\0", q)
            names.append(bytes(b[q:end]).decode("utf-8"))
            q += end + 1 - q if ver >= 3 else _align8(end + 1 - q)
            off = int.from_bytes(b[q:q + owidth], "little")
            q += owidth
            if ver == 1:
                if b[q] != 0:
                    raise NotImplementedError(
                        "array members of compound datatypes")
                q += 28
            t, used = _parse_type(f, q)
            if t.vlen or t.ref == "region":
                raise NotImplementedError(
                    "variable-length and region reference members of "
                    "compound datatypes")
            q += used
            formats.append(t.dtype)
            offsets.append(off)
        if (names == ["r", "i"] and offsets == [0, formats[0].itemsize]
                and formats[0] == formats[1] and formats[0].kind == "f"
                and size == 2 * formats[0].itemsize):
            return _Type(np.dtype(
                f"{formats[0].byteorder.replace('=', '<')}"
                f"c{size}")), q - p
        return _Type(np.dtype({"names": names, "formats": formats,
                               "offsets": offsets,
                               "itemsize": size})), q - p
    if cls == 8:    # enumeration
        nmemb = bits & 0xFFFF
        base, used = _parse_type(f, q)
        q += used
        names = []
        for _ in range(nmemb):
            end = b.find(b"\0", q)
            names.append(bytes(b[q:end]))
            q += end + 1 - q if ver >= 3 else _align8(end + 1 - q)
        values = np.frombuffer(bytes(b[q:q + nmemb * base.dtype.itemsize]),
                               base.dtype).tolist()
        q += nmemb * base.dtype.itemsize
        if (base.dtype.itemsize == 1 and
                dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}):
            return _Type(np.dtype(bool)), q - p
        return _Type(base.dtype), q - p
    if cls == 9:    # variable length
        base, used = _parse_type(f, q)
        kind = "str" if bits & 0x0F == 1 else "seq"
        return _Type(_vlen_dtype(f._so), vlen=kind, base=base), 8 + used
    names = {2: "time", 10: "array"}
    raise NotImplementedError(f"{names.get(cls, cls)} datatypes")


def _type_fixed(dt):
    bits = (0x08 if dt.kind == "i" else 0) | (1 if dt.byteorder == ">"
                                              else 0)
    return (struct.pack("<BBBBI", 0x10, bits, 0, 0, dt.itemsize)
            + struct.pack("<HH", 0, 8 * dt.itemsize))


_FLOAT_LAYOUT = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                 8: (63, 52, 11, 0, 52, 1023)}


def _type_float(dt):
    sign, eloc, esize, mloc, msize, bias = _FLOAT_LAYOUT[dt.itemsize]
    bits = 0x20 | (1 if dt.byteorder == ">" else 0)
    return (struct.pack("<BBBBI", 0x11, bits, sign, 0, dt.itemsize)
            + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, mloc,
                          msize, bias))


def _type_string(size, utf8=False, nullterm=True):
    bits = (0 if nullterm else 1) | ((1 if utf8 else 0) << 4)
    return struct.pack("<BBBBI", 0x13, bits, 0, 0, size)


def _type_vlen_str(utf8):
    # the base type is an unsigned byte, as the library writes it
    return (struct.pack("<BBBBI", 0x19, 0x01, 1 if utf8 else 0, 0, 16)
            + _type_fixed(np.dtype("u1")))


_TYPE_REF = struct.pack("<BBBBI", 0x17, 0, 0, 0, 8)
_TYPE_BOOL = (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1)
              + _type_fixed(np.dtype("i1")) + _pad8(b"FALSE\0")
              + _pad8(b"TRUE\0") + b"\x00\x01")
_TYPE_DIMLIST = struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + _TYPE_REF


def _compound(size, members):
    """A version-1 compound type of ``(name, offset, type bytes)``."""
    out = struct.pack("<BBBBI", 0x16, len(members) & 0xFF,
                      len(members) >> 8, 0, size)
    for name, off, t in members:
        out += (_pad8(name.encode() + b"\0") + struct.pack("<I", off)
                + b"\0" * 28 + t)
    return out


#: the dimension-scale library's ``REFERENCE_LIST`` element:
#: ``{hobj_ref_t dataset; unsigned dimension;}`` padded to 16 bytes
_TYPE_REFLIST = _compound(16, [("dataset", 0, _TYPE_REF),
                               ("dimension", 8, _type_fixed(np.dtype("<u4")))])


def _type_of(dt):
    """Datatype message bytes of a numpy dtype, as h5py stores it."""
    if dt.kind in "iu":
        return _type_fixed(dt)
    if dt.kind == "f" and dt.itemsize in _FLOAT_LAYOUT:
        return _type_float(dt)
    if dt.kind == "b":
        return _TYPE_BOOL
    if dt.kind == "c":
        order = dt.byteorder.replace("=", "<")
        half = np.dtype(f"{order}f{dt.itemsize // 2}")
        ft = _type_float(half)
        return _compound(dt.itemsize, [("r", 0, ft),
                                       ("i", half.itemsize, ft)])
    if dt.kind == "S":
        return _type_string(dt.itemsize, nullterm=False)
    if dt.kind == "O":
        return _type_vlen_str(True)
    raise TypeError(f"No conversion path for dtype: {dt!r}")


def _stored(arr):
    """The bytes of a numeric array as stored (bool as int8)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "b":
        arr = arr.view(np.int8)
    return arr.tobytes()


# ---------------------------------------------------------------------------
# dataspaces


def _space(shape):
    """Version-1 dataspace message (scalar for ``()``)."""
    return (struct.pack("<BBBBI", 1, len(shape), 0, 0, 0)
            + b"".join(struct.pack("<Q", int(d)) for d in shape))


def _parse_space(f, p, maxshape=False):
    """``shape`` of the dataspace message at ``p`` (sizes of the file's
    "size of lengths"); ``None`` for a null dataspace. With
    ``maxshape``, ``(shape, maximum shape)``: the shape where none is
    stored, ``_UNDEF`` for an unlimited dimension."""
    b = f._b
    ver, nd = b[p], b[p + 1]
    if ver == 1:
        q = p + 8
    elif ver == 2:
        if b[p + 3] == 2:
            return (None, None) if maxshape else None
        q = p + 4
    else:
        raise NotImplementedError(f"dataspace message version {ver}")
    sl = f._sl
    shape = tuple(f._l(q + i * sl) for i in range(nd))
    if not maxshape:
        return shape
    if b[p + 2] & 0x01 and nd:
        return shape, tuple(f._l(q + (nd + i) * sl) for i in range(nd))
    return shape, shape


# ---------------------------------------------------------------------------
# reading


class _Attrs:
    """Read-only attributes, in h5py's order: creation order where the
    object header tracks it, by name otherwise. ``msgs`` holds ``(name,
    type, shape, data, type bytes, creation order)``."""

    def __init__(self, f, msgs, by_creation=False):
        self._f = f
        key = (lambda m: m[5]) if by_creation else \
            (lambda m: m[0].encode("utf-8"))
        self._raw = {m[0]: m[1:5] for m in sorted(msgs, key=key)}

    def __contains__(self, k):
        return k in self._raw

    def __iter__(self):
        return iter(self._raw)

    def __getitem__(self, k):
        t, shape, data, _ = self._raw[k]
        if shape is None:
            return Empty(t.out)
        arr = self._f._values(t, data, shape)
        if t.vlen == "str":
            arr = np.array([v.decode("utf-8", "surrogateescape")
                            for v in arr.flat], dtype=object
                           ).reshape(arr.shape)
        return arr[()] if arr.ndim == 0 else arr

    def get(self, k, default=None):
        return self[k] if k in self._raw else default

    def items(self):
        return [(k, self[k]) for k in self._raw]


class _DimProxy:
    def __init__(self, dset, i):
        self._dset, self._i = dset, i

    def _scales(self):
        if "DIMENSION_LIST" not in self._dset.attrs:
            return []
        return list(self._dset.attrs["DIMENSION_LIST"][self._i])

    def __len__(self):
        return len(self._scales())

    def keys(self):
        """The ``NAME`` of each scale attached to this dimension."""
        out = []
        for addr in self._scales():
            name = self._dset._f._object(int(addr)).attrs.get("NAME", b"")
            out.append(name.decode("utf-8") if isinstance(name, bytes)
                       else str(name))
        return out


class _ReadDataset:
    """A dataset of a file opened for reading."""

    def __init__(self, f, addr, name):
        self._f, self.name = f, name
        self.shape, self._type, self._layout = None, None, None
        self._filters, self._fill, self._efl = [], None, None
        group = False
        msgs = f._messages(addr)
        for mtype, p, size in msgs:
            b = f._b
            if mtype == _DATASPACE:
                self.shape, self._maxshape = _parse_space(f, p, True)
            elif mtype == _DATATYPE:
                self._type, used = _parse_type(f, p)
                self._tbytes = bytes(b[p:p + used])
            elif mtype == _LAYOUT:
                self._layout = f._parse_layout(p)
            elif mtype == _PIPELINE:
                self._filters = f._parse_pipeline(p)
            elif mtype in (_FILL, _FILL_OLD):
                fill = f._parse_fill(mtype, p)
                if mtype == _FILL or self._fill is None:
                    self._fill = fill
            elif mtype == _EXTERNAL:
                self._efl = hdf5_extern.parse_external(f, p)
            elif mtype in (_SYMBOL_TABLE, _LINK, _LINK_INFO):
                group = True
        if group:
            raise NotImplementedError(
                f"{name!r} is a group: groups below the root group")
        self.attrs = f._attrs(msgs)
        if self._type is None or self._layout is None:
            raise NotImplementedError(
                f"{name!r} is a named object: only datasets in the root "
                "group")
        if self._layout[0] == "virtual":    # its extent may follow sources
            self._plan = hdf5_extern.virtual_plan(self)
            self.shape = self._plan[0]

    @property
    def dtype(self):
        return self._type.out

    @property
    def ndim(self):
        return 0 if self.shape is None else len(self.shape)

    @property
    def size(self):
        """The element count; ``None`` for a null dataspace, as h5py."""
        return None if self.shape is None else _nelem(self.shape)

    @property
    def chunks(self):
        lay = self._layout
        return tuple(lay[1][:-1]) if lay[0] == "chunked" else None

    @property
    def compression(self):
        return "gzip" if any(flt.id == hf.DEFLATE
                             for flt in self._filters) else None

    @property
    def compression_opts(self):
        for flt in self._filters:
            if flt.id == hf.DEFLATE:
                return flt.cd[0] if flt.cd else 0
        return None

    @property
    def shuffle(self):
        return any(flt.id == hf.SHUFFLE for flt in self._filters)

    @property
    def dims(self):
        return [_DimProxy(self, i) for i in range(self.ndim)]

    def __getitem__(self, key):
        """The whole dataset (``...`` or ``()``), or h5py's basic
        selection ``key`` (ints and step-1 slices): of a chunked dataset
        in the file, only the chunks it meets, each decoded only as far
        as it needs (:class:`hdf5_chunks.Chunks`); of any other layout,
        the whole dataset sliced and copied, so that the slice, as
        h5py's, holds no more than its own elements."""
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return self._read_all(self._read_chunked)
        if self.shape is None:
            raise ValueError(f"{self.name!r} has no elements to select "
                             f"with {key!r}")
        box, pick = hc.basic_box(key, self.shape)
        if not self._in_chunks():
            part = self._read_all(self._read_chunked)[tuple(
                a if p == 0 else slice(a, b)
                for (a, b), p in zip(box, pick))]
            return part.copy() if isinstance(part, np.ndarray) else part
        t = self._type
        raw = self._chunk_store().read(box)
        if not raw.size:
            return np.zeros(raw.shape, dtype=t.out)[pick]
        return self._f._values(t, raw, raw.shape)[pick]

    def _getitem_plain(self, key):
        """The plain version of :meth:`__getitem__`: the whole dataset,
        read by :meth:`_read_chunked_plain` where it is chunked, then
        numpy's index."""
        whole = self._read_all(self._read_chunked_plain)
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return whole
        return whole[key]

    def _read_all(self, read_chunked):
        t, shape = self._type, self.shape
        if shape is None:
            return Empty(t.out)
        n = _nelem(shape)
        if n == 0:
            return np.zeros(shape, dtype=t.out)
        lay = self._layout
        esize = t.dtype.itemsize
        if lay[0] == "compact":
            raw = lay[1]
        elif lay[0] == "virtual":
            raw = hdf5_extern.read_virtual(self)
        elif self._efl is not None:
            raw = hdf5_extern.read_external(self._f, self._efl, n * esize)
        elif lay[0] == "contiguous":
            addr = lay[1]
            raw = self._fill_bytes(n) if addr == _UNDEF else \
                self._f._read(addr, n * esize)
        else:
            raw = read_chunked(lay[1], n)
        return self._f._values(t, raw, shape)

    def _in_chunks(self):
        """Whether the elements are chunks of this file."""
        return self._layout[0] == "chunked" and self._efl is None

    def _chunk_store(self):
        """The written chunks, read from the file as they are needed."""
        return hc.Chunks(self.shape, self._type.dtype,
                         self._layout[1][:-1], self._filters,
                         self._fill, self._chunks(), self._f._read)

    def _fill_bytes(self, n):
        esize = self._type.dtype.itemsize
        if self._fill and len(self._fill) == esize:
            return self._fill * n
        return bytes(n * esize)

    def _chunks(self):
        """``[(stored bytes, filter mask, offsets, address)]`` of every
        written chunk, from the layout's chunk index."""
        cdims, index = self._layout[1], self._layout[2]
        if index[0] == 0:   # a version-1 B-tree (layout version 3)
            return [] if index[1] == _UNDEF else \
                self._f._chunk_btree(index[1], len(cdims) - 1)
        return hdf5_v2.chunk_list(self._f, index, cdims[:-1], cdims[-1],
                                  self.shape, self._maxshape,
                                  bool(self._filters))

    def _read_chunked(self, cdims, n):
        """The whole chunked dataset as one array of the stored dtype,
        each chunk decoded into its place (:class:`hdf5_chunks.Chunks`)."""
        return self._chunk_store().read()

    def _read_chunked_plain(self, cdims, n):
        """The plain version of :meth:`_read_chunked`: the stored bytes
        of the whole dataset, filled, then each chunk copied in."""
        f, t, shape = self._f, self._type, self.shape
        chunk = tuple(cdims[:-1])
        esize = t.dtype.itemsize
        out = np.frombuffer(bytearray(self._fill_bytes(n)), t.dtype
                            ).reshape(shape)
        found = self._chunks()
        filters = self._filters
        stored = sum(nb for nb, _, _, _ in found)
        want = _nelem(chunk) * esize

        def load(item):
            # the filters in reverse, each only where the chunk's mask
            # says it was applied
            nbytes, mask, offs, addr = item
            buf = f._read(addr, nbytes)
            for j in range(len(filters) - 1, -1, -1):
                if not mask & (1 << j):
                    exact = all(mask & (1 << i) or filters[i].id
                                in hf.SAME_SIZE for i in range(j))
                    buf = hf.unfilter(filters[j], buf, want, esize, exact)
            return offs, buf

        items = found
        if stored >= _PARALLEL_READ_MIN and len(found) > 1:
            with ThreadPoolExecutor(min(_READ_THREADS, len(found))) as ex:
                loaded = list(ex.map(load, items))
        else:
            loaded = [load(it) for it in items]
        for offs, buf in loaded:
            if len(buf) != want:
                raise OSError(f"chunk at {offs} holds {len(buf)} bytes, "
                              f"not {want}")
            block = np.frombuffer(buf, t.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start)
                                   for d in dst)]
        return out.tobytes()



#: the forms of :class:`_ReadDataset` a caller can swap for their plain
#: versions (``_<name>_plain``; ``getitem`` is ``__getitem__``)
FORMS = ("read_chunked", "getitem")

class _ReadFile:
    """A file opened for reading: the root group's datasets by name."""

    def __init__(self, path):
        self.filename = str(path)
        self._fh = open(path, "rb")
        try:
            self._b = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:     # an empty file
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file ({e})") from None
        self._heaps, self._objects, self._names = {}, {}, {}
        self._others = {}   # files that external links and sources name
        try:
            self._open()
        except NotImplementedError:
            self.close()
            raise
        except (struct.error, IndexError, ValueError, OSError) as e:
            self.close()
            raise OSError(f"{path}: not a readable HDF5 file ({e})") \
                from None

    def _open(self):
        b = self._b
        base = None
        for off in [0] + [512 << i for i in range(24)]:
            if off + 8 > len(b):
                break
            if b[off:off + 8] == _SIGNATURE:
                base = off
                break
        if base is None:
            raise OSError("file signature not found")
        # addresses count from the superblock, wherever a user block puts
        # it (the library moves the stored base address there too)
        self._base = base
        ver = b[base + 8]
        if ver in (2, 3):
            self._root, ext = hdf5_v2.superblock(self, base)
            hdf5_v2.check_extension(self, ext)
        elif ver in (0, 1):
            so = b[base + 13]
            self._sizes(so, b[base + 14])
            # base, free space, end of file and driver info addresses,
            # then the root group's symbol table entry (name offset first)
            root = base + 24 + (4 if ver == 1 else 0) + 4 * so
            self._root = self._o(root + so)
        else:
            raise NotImplementedError(f"superblock version {ver}")
        self._group(self._root)

    # -- low level --------------------------------------------------------

    #: the superblock's "size of offsets" and "size of lengths", and the
    #: largest value of each (the undefined address, an unlimited size)
    _so = _sl = 8
    _omax = _lmax = _UNDEF

    def _sizes(self, so, sl):
        if so not in (2, 4, 8) or sl not in (2, 4, 8):
            raise NotImplementedError(
                f"{so}-byte offsets and {sl}-byte lengths")
        self._so, self._sl = so, sl
        self._omax, self._lmax = (1 << 8 * so) - 1, (1 << 8 * sl) - 1

    def _o(self, p):
        """The address stored at offset ``p`` of the mapping, in the
        file's width: ``_UNDEF`` for the undefined address (all ones)."""
        v = int.from_bytes(self._b[p:p + self._so], "little")
        return _UNDEF if v == self._omax else v

    def _l(self, p):
        """The length stored at ``p``: ``_UNDEF`` for all ones (an
        unlimited dimension)."""
        v = int.from_bytes(self._b[p:p + self._sl], "little")
        return _UNDEF if v == self._lmax else v

    def _addr(self, a):
        return a + self._base

    def _read(self, addr, n):
        a = self._addr(addr)
        if a + n > len(self._b):
            raise OSError("the file is cut short")
        return self._b[a:a + n]

    def _messages(self, addr):
        """``(type, data offset, size)`` of the object header at
        ``addr``, continuation blocks followed, as a
        :class:`hdf5_v2.Messages` (version 2 headers: there)."""
        b = self._b
        a = self._addr(addr)
        if b[a:a + 4] == b"OHDR":
            return hdf5_v2.object_header(self, a)
        if b[a] != 1:
            raise OSError(f"bad object header version {b[a]} at {addr}")
        nmsgs, size = struct.unpack_from("<H", b, a + 2)[0], \
            struct.unpack_from("<I", b, a + 8)[0]
        blocks = [(a + 16, size)]
        out, seen = hdf5_v2.Messages(), 0
        while blocks and seen < nmsgs:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and seen < nmsgs:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                seen += 1
                q = p + 8
                if q + msize > end:
                    raise OSError("object header message overruns its block")
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(self._o(q)),
                                   self._l(q + self._so)))
                elif mtype:
                    if flags & 0x02:
                        raise NotImplementedError(
                            "shared object header messages")
                    out.append((mtype, q, msize))
                p = q + msize
        return out

    def _parse_attribute(self, p):
        """The attribute message at ``p`` (versions 1-3: version 1 pads
        its parts to 8 bytes, version 3 adds a character set)."""
        b = self._b
        ver = b[p]
        if ver not in (1, 2, 3):
            raise NotImplementedError(f"attribute message version {ver}")
        if ver > 1 and b[p + 1] & 0x03:
            raise NotImplementedError("shared object header messages")
        nlen, tlen, slen = struct.unpack_from("<HHH", b, p + 2)
        q = p + 8 + (1 if ver == 3 else 0)
        pad = _align8 if ver == 1 else (lambda n: n)
        name = bytes(b[q:q + nlen]).rstrip(b"\0")
        tq = q + pad(nlen)
        sq = tq + pad(tlen)
        q = sq + pad(slen)
        t, used = _parse_type(self, tq)
        shape = _parse_space(self, sq)
        n = 0 if shape is None else _nelem(shape)
        data = bytes(b[q:q + n * t.dtype.itemsize])
        return name.decode("utf-8"), t, shape, data, bytes(b[tq:tq + used])

    def _attrs(self, msgs):
        """The attributes of an object header: its attribute messages and
        its dense storage (attribute info message)."""
        out = []
        for mtype, q, _ in msgs:
            if mtype == _ATTRIBUTE:
                out.append((*self._parse_attribute(q), msgs.order.get(q, 0)))
            elif mtype == _ATTR_INFO:
                for p, order in hdf5_v2.dense_attrs(
                        self, *hdf5_v2.attr_info(self, q)):
                    out.append((*self._parse_attribute(p), order))
        return _Attrs(self, out, msgs.attrs_by_creation)

    def _group(self, addr):
        """The root group: its attributes and its members' object header
        addresses by name, in h5py's order (by name, or in creation order
        where the group tracks it), from a symbol table or from links
        (compact, or dense in a fractal heap)."""
        b = self._b
        msgs = self._messages(addr)
        table, info, links = None, None, []
        for mtype, q, _ in msgs:
            if mtype == _SYMBOL_TABLE:
                table = (self._o(q), self._o(q + self._so))
            elif mtype == _LINK_INFO:
                info = hdf5_v2.link_info(self, q)
            elif mtype == _LINK:
                links.append(q)
        self.attrs = self._attrs(msgs)
        self._links = set()     # members that are soft or external links
        if table is not None:
            self._entries = dict(sorted(self._group_entries(*table).items(),
                                        key=lambda kv: kv[0].encode("utf-8")))
        elif info is not None:
            tracked, heap, names = info
            found = [hdf5_v2.parse_link(self, q) for q in
                     links + hdf5_v2.dense_links(self, heap, names)]
            found.sort(key=(lambda x: x[1]) if tracked else
                       (lambda x: x[0].encode("utf-8")))
            hard = {n: t for n, _, kind, t in found if kind == "hard"}
            self._entries = {}
            for name, _, kind, target in found:
                if kind != "hard":
                    self._links.add(name)
                if kind == "external":
                    target = ("external", *target)
                elif kind == "soft":
                    target = hard.get(target[1:] if target.startswith("/")
                                      else target)
                    if target is None:
                        raise NotImplementedError(
                            f"soft link {name!r} (only to datasets in the "
                            "root group)")
                self._entries[name] = target
        else:
            raise OSError("the root group has no symbol table or links")
        for name, a in self._entries.items():
            if not isinstance(a, tuple):
                self._names.setdefault(a, name)

    def _parse_layout(self, p):
        b = self._b
        ver, cls = b[p], b[p + 1]
        if ver == 4:
            return hdf5_v2.parse_layout4(self, p)
        if ver != 3:
            raise NotImplementedError(f"data layout message version {ver}")
        if cls == 0:
            n = struct.unpack_from("<H", b, p + 2)[0]
            return ("compact", bytes(b[p + 4:p + 4 + n]))
        if cls == 1:
            return ("contiguous", self._o(p + 2))
        if cls == 2:
            nd = b[p + 2]
            addr = self._o(p + 3)
            dims = struct.unpack_from(f"<{nd}I", b, p + 3 + self._so)
            return ("chunked", tuple(dims), (0, addr, (), 0))
        raise NotImplementedError(f"data layout class {cls}")

    def _parse_pipeline(self, p):
        """The filter pipeline message, versions 1 and 2 (version 2: no
        name below id 256, no padding), as :class:`hdf5_filters.Filter`
        entries. No filter is refused here: a chunk is, where one it
        must undo is not read (``hdf5_filters.unfilter``)."""
        b = self._b
        ver, nf = b[p], b[p + 1]
        if ver not in (1, 2):
            raise NotImplementedError(f"filter pipeline message version {ver}")
        q = p + (8 if ver == 1 else 2)
        out = []
        for _ in range(nf):
            fid = struct.unpack_from("<H", b, q)[0]
            if ver == 1 or fid >= 256:
                nlen, flags, ncd = struct.unpack_from("<HHH", b, q + 2)
                q += 8
            else:
                nlen, (flags, ncd) = 0, struct.unpack_from("<HH", b, q + 2)
                q += 6
            name = bytes(b[q:q + nlen]).split(b"\0")[0].decode(
                "ascii", "replace")
            q += _align8(nlen) if ver == 1 else nlen
            cd = struct.unpack_from(f"<{ncd}I", b, q)
            q += 4 * ncd + (4 * (ncd % 2) if ver == 1 else 0)
            out.append(hf.Filter(fid, cd, flags, name))
        return out

    def _parse_fill(self, mtype, p):
        b = self._b
        if mtype == _FILL_OLD:
            n = struct.unpack_from("<I", b, p)[0]
            return bytes(b[p + 4:p + 4 + n]) or None
        ver = b[p]
        if ver == 3:    # flags: bit 5, a value follows
            if b[p + 1] & 0x20:
                n = struct.unpack_from("<I", b, p + 2)[0]
                return bytes(b[p + 6:p + 6 + n]) or None
            return None
        if ver not in (1, 2):
            raise NotImplementedError(f"fill value message version {ver}")
        if ver == 1 or b[p + 3]:    # version 2 says whether it is defined
            n = struct.unpack_from("<I", b, p + 4)[0]
            return bytes(b[p + 8:p + 8 + n]) or None
        return None

    def _heap_names(self, heap):
        """The names in the local heap at ``heap``: a function of a name's
        offset in the heap's data segment."""
        b = self._b
        h = self._addr(heap)
        if b[h:h + 4] != b"HEAP":
            raise OSError("bad local heap signature")
        data = self._addr(self._o(h + 8 + 2 * self._sl))

        def name_at(off):
            end = b.find(b"\0", data + off)
            return bytes(b[data + off:end]).decode("utf-8")

        return name_at

    def _group_entries(self, btree, heap):
        b = self._b
        so, sl = self._so, self._sl
        name_at = self._heap_names(heap)
        entries = {}

        def walk(addr):
            a = self._addr(addr)
            sig = b[a:a + 4]
            if sig == b"SNOD":
                # entries: name offset, header address, cache type,
                # reserved, scratch pad
                n = struct.unpack_from("<H", b, a + 6)[0]
                for i in range(n):
                    e = a + 8 + (2 * so + 24) * i
                    entries[name_at(self._o(e))] = self._o(e + so)
                return
            if sig != b"TREE" or b[a + 4] != 0:
                raise OSError("bad group B-tree node")
            # after the siblings, key 0 (a heap offset) then child, key
            n = struct.unpack_from("<H", b, a + 6)[0]
            for i in range(n):
                walk(self._o(a + 8 + 2 * so + sl + (sl + so) * i))

        walk(btree)
        return entries

    def _chunk_btree(self, addr, ndim):
        """``(nbytes, filter mask, offsets, address)`` of every chunk."""
        b = self._b
        so = self._so
        ksize = 8 + 8 * (ndim + 1)
        out = []

        def walk(addr):
            a = self._addr(addr)
            if b[a:a + 4] != b"TREE" or b[a + 4] != 1:
                raise OSError("bad chunk B-tree node")
            level = b[a + 5]
            n = struct.unpack_from("<H", b, a + 6)[0]
            p = a + 8 + 2 * so
            for _ in range(n):
                nbytes, mask = struct.unpack_from("<II", b, p)
                offs = struct.unpack_from(f"<{ndim}Q", b, p + 8)
                child = self._o(p + ksize)
                if level:
                    walk(child)
                else:
                    out.append((nbytes, mask, offs, child))
                p += ksize + so

        walk(addr)
        return out

    def _heap_object(self, addr, idx):
        heap = self._heaps.get(addr)
        if heap is None:
            b = self._b
            sl = self._sl
            a = self._addr(addr)
            if b[a:a + 4] != b"GCOL":
                raise OSError("bad global heap collection signature")
            # the header and each object's header (index, reference
            # count, reserved, size) padded to 8 bytes, then its data
            hdr = _align8(8 + sl)
            heap, p, end = {}, a + hdr, a + self._l(a + 8)
            while p + hdr <= end:
                i = struct.unpack_from("<H", b, p)[0]
                if i == 0:
                    break
                n = self._l(p + 8)
                heap[i] = (p + hdr, n)
                p += hdr + _align8(n)
            self._heaps[addr] = heap
        if idx not in heap:
            raise OSError(f"global heap object {idx} not in the collection "
                          f"at {addr}")
        p, n = heap[idx]
        return self._b[p:p + n]

    def _values(self, t, raw, shape):
        """The elements of ``raw`` as a reader gets them: ``raw`` the
        stored bytes, or an array of ``t.dtype`` that the read built,
        which is kept, not copied."""
        n = _nelem(shape)
        if t.unreadable:
            raise OSError(f"Can't read data ({t.unreadable})")
        if isinstance(raw, np.ndarray):
            if not (t.vlen or t.ref == "region"):
                return self._addresses(t, raw.reshape(shape))
            raw = raw.reshape(-1).view(np.uint8)
        if t.ref == "region":
            w = t.dtype.itemsize
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = hdf5_extern.region(self, bytes(raw[i * w:i * w + w]))
            return out.reshape(shape)
        if not t.vlen:
            return self._addresses(t, np.frombuffer(raw, t.dtype, n)
                                   ).reshape(shape).copy()
        desc = np.frombuffer(raw, _vlen_dtype(self._so), n)
        out = np.empty(n, dtype=object)
        for i, (ln, addr, idx) in enumerate(desc.tolist()):
            data = self._heap_object(addr, idx) if addr and ln else b""
            if t.vlen == "str":
                out[i] = bytes(data[:ln])
            else:
                out[i] = self._addresses(
                    t.base, np.frombuffer(data, t.base.dtype, ln)).copy()
        return out.reshape(shape)

    def _addresses(self, t, arr):
        """Object references as the addresses in their first bytes."""
        if t.ref == "object" and arr.dtype.itemsize > self._so:
            return arr & arr.dtype.type(self._omax)
        return arr

    def _object(self, addr):
        if isinstance(addr, tuple):     # an external link: file, path
            return hdf5_extern.linked(self, *addr[1:])
        obj = self._objects.get(addr)
        if obj is None:
            name = self._names.get(addr, f"<object at {addr}>")
            try:
                obj = _ReadDataset(self, addr, name)
            except (struct.error, IndexError) as e:
                raise OSError(f"{self.filename}: object {name!r} is not "
                              f"readable ({e})") from None
            self._objects[addr] = obj
        return obj

    # -- h5py-like API ----------------------------------------------------

    def keys(self):
        return list(self._entries)

    def __iter__(self):
        return iter(self.keys())

    def __getitem__(self, name):
        return self._object(self._entries[name])

    def close(self):
        if self._b is not None:
            self._b.close()
            self._b = None
            self._fh.close()
            for g in self._others.values():
                g.close()
            self._others = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writing


class _WriteAttrs:
    """Attributes of an object being written. ``attrs[k] = v`` converts
    ``v`` as h5py does and raises where h5py raises."""

    def __init__(self):
        self._items = {}

    def __setitem__(self, name, value):
        self._items.pop(name, None)
        self._items[name] = _encode_attr_value(value)

    def __contains__(self, name):
        return name in self._items

    def update(self, values):
        for k, v in values.items():
            self[k] = v

    def _set(self, name, item):
        self._items.pop(name, None)
        self._items[name] = item


def _taken_attrs(attrs):
    """Attributes of a file being rewritten, as stored."""
    out = {}
    for name, (t, shape, data, tbytes) in attrs._raw.items():
        if shape is None or t.vlen == "seq" or t.ref == "region" or name in (
                "DIMENSION_LIST", "REFERENCE_LIST"):
            raise NotImplementedError(
                f"rewriting the attribute {name!r} (null dataspaces, "
                "variable-length sequences, object and region references)")
        if t.vlen:
            out[name] = (tbytes, shape, "vstr",
                         list(attrs._f._values(t, data, shape).reshape(-1)))
        else:
            out[name] = (tbytes, shape, "raw", data)
    return out


def _encode_attr_value(value):
    """``(type bytes, shape, kind, payload)``: kind ``"raw"`` (payload is
    the stored bytes) or ``"vstr"`` (payload is the strings as bytes; the
    type bytes carry the charset)."""
    if isinstance(value, str) and not isinstance(value, np.generic):
        return (_type_vlen_str(True), (), "vstr",
                [value.encode("utf-8", "surrogateescape")])
    if isinstance(value, bytes) and not isinstance(value, np.generic):
        return _type_vlen_str(False), (), "vstr", [value]
    if isinstance(value, (bool, int, float, complex)) and \
            not isinstance(value, np.generic):
        value = np.asarray(value)
    arr = np.asarray(value)
    if arr.dtype.kind == "O":
        items = [v.encode("utf-8", "surrogateescape") if isinstance(v, str)
                 else v for v in arr.reshape(-1)]
        if not all(isinstance(v, bytes) for v in items):
            raise TypeError(f"Object dtype {arr.dtype} has no native HDF5 "
                            "equivalent")
        return _type_vlen_str(True), arr.shape, "vstr", items
    if arr.dtype.kind in "UmMV":
        raise TypeError(f"No conversion path for dtype: {arr.dtype!r}")
    return _type_of(arr.dtype), arr.shape, "raw", _stored(arr)


class _WriteDim:
    def __init__(self, dset, i):
        self._dset, self._i = dset, i

    def attach_scale(self, scale):
        self._dset._attach(scale, self._i)


class _WriteDataset:
    """A dataset being written: its data or its directly written chunks,
    its attributes and its dimension scales."""

    def __init__(self, f, name, shape, dtype, data, chunks, filters):
        self._f, self.name = f, name
        self.shape, self.dtype = tuple(int(s) for s in shape), dtype
        self._data, self.chunks, self._filters = data, chunks, filters
        self._direct = {}
        self._tbytes = None       # a datatype taken over as stored
        self.attrs = _WriteAttrs()
        self.dims = [_WriteDim(self, i) for i in range(len(self.shape))]
        self._dimlist = None      # per dimension, the attached scales
        self._reflist = []        # (dataset, dimension) attached here

    def __setitem__(self, key, value):
        if key is not Ellipsis:
            raise NotImplementedError("the codec writes whole datasets")
        self._data = _as_stored(np.asarray(value, dtype=self.dtype),
                                self.dtype)

    def write_direct_chunk(self, offsets, data, filter_mask=0):
        """Store one chunk as given (already filtered)."""
        self._direct[tuple(int(o) for o in offsets)] = (bytes(data),
                                                        filter_mask)

    def make_scale(self, name=""):
        self.attrs._set("CLASS", (_type_string(16), (), "raw",
                                  b"DIMENSION_SCALE\0"))
        raw = name.encode("utf-8") + b"\0"
        self.attrs._set("NAME", (_type_string(len(raw)), (), "raw", raw))

    def _attach(self, scale, i):
        if scale is self:
            raise ValueError("a dataset cannot be its own dimension scale")
        if self._dimlist is None:
            self._dimlist = [[] for _ in self.shape]
        if scale not in self._dimlist[i]:
            self._dimlist[i].append(scale)
            scale._reflist.append((self, i))

    # -- layout -----------------------------------------------------------

    def _chunk_items(self, data):
        """``[(offsets, stored bytes, filter mask)]`` in B-tree order, of
        the directly written chunks or of ``data`` (the elements as
        stored) cut into chunks and filtered."""
        if self._direct:
            return [(k, *self._direct[k]) for k in sorted(self._direct)]
        if data is None or _nelem(self.shape) == 0:
            return []
        chunks = self.chunks
        esize = data.dtype.itemsize
        out = []
        for off in product(*[range(0, s, c)
                             for s, c in zip(self.shape, chunks)]):
            sl = tuple(slice(o, min(o + c, s))
                       for o, c, s in zip(off, chunks, self.shape))
            block = data[sl]
            if block.shape != tuple(chunks):
                full = np.zeros(chunks, dtype=data.dtype)
                full[tuple(slice(0, d) for d in block.shape)] = block
                block = full
            buf, mask = _stored(block), 0
            for j, flt in enumerate(self._filters):
                if flt.id == hf.SHUFFLE:
                    buf = _shuffle(buf, esize)
                elif flt.id == hf.DEFLATE:
                    buf = zlib.compress(buf, flt.cd[0])
                elif flt.flags & hf.OPTIONAL and flt.id not in hf.UNDONE:
                    # an optional filter neither h5py nor the codec has
                    # (blosc, zstd, an unknown id): skipped and masked,
                    # as the library skips it
                    mask |= 1 << j
                else:
                    raise NotImplementedError(
                        f"writing chunks through the {flt.label} filter")
            out.append((off, buf, mask))
        return out


def _as_stored(arr, dtype):
    """The array as stored: numbers contiguous in ``dtype``; strings as
    bytes objects (their 16-byte descriptors are made when the file is
    laid out, once the heap is placed)."""
    if dtype.kind == "O":
        out = np.empty(arr.shape, dtype=object)
        flat = out.reshape(-1)
        for i, v in enumerate(arr.reshape(-1)):
            if isinstance(v, str):
                v = v.encode("utf-8", "surrogateescape")
            if not isinstance(v, bytes):
                raise TypeError(f"Can't store {type(v).__name__} in a "
                                "variable-length string dataset")
            flat[i] = v
        return out
    return np.ascontiguousarray(arr, dtype=dtype)


def _message(mtype, body, flags=0):
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages):
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _tree_levels(n):
    """Node counts per level of a chunk B-tree over ``n`` chunks."""
    counts = [-(-n // (2 * _CHUNK_K))]
    while counts[-1] > 1:
        counts.append(-(-counts[-1] // (2 * _CHUNK_K)))
    return counts


class _Heap:
    """The global heap collections: objects in the order they are put,
    up to 65535 per collection. An object is bytes, or ``(size, fn)``
    whose ``fn(at)`` gives its bytes once addresses are known."""

    def __init__(self):
        self.collections = [[]]

    def put(self, obj):
        if len(self.collections[-1]) == 0xFFFF:
            self.collections.append([])
        self.collections[-1].append(obj)
        return len(self.collections) - 1, len(self.collections[-1])

    def sizes(self):
        out = []
        for objs in self.collections:
            body = sum(16 + _align8(o[0] if isinstance(o, tuple) else len(o))
                       for o in objs)
            out.append(max(_GCOL_MIN, 16 + body + 16))
        return out

    def blocks(self, at):
        out = []
        for objs, size in zip(self.collections, self.sizes()):
            data = [o if isinstance(o, bytes) else o[1](at) for o in objs]
            body = b"".join(struct.pack("<HHIQ", i + 1, 0, 0, len(o))
                            + _pad8(o) for i, o in enumerate(data))
            free = size - 16 - len(body)
            out.append(b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body
                       + struct.pack("<HHIQ", 0, 0, 0, free)
                       + bytes(free - 16))
        return out


class _WriteFile:
    """A file being created: datasets in the root group, attributes and
    dimension scales, written out by :meth:`close`."""

    def __init__(self, path, append=False):
        self.filename = str(path)
        self.attrs = _WriteAttrs()
        self._dsets = {}
        self._closed = False
        self._append = append and os.path.exists(path)
        if self._append:
            self._take_over()

    def _take_over(self):
        """The existing file's attributes and datasets, to be written
        again: stored chunks and attribute bytes as they are, strings
        decoded (their heap is laid out anew)."""
        with _ReadFile(self.filename) as r:
            self.attrs._items = _taken_attrs(r.attrs)
            for name in r.keys():
                if name in r._links:
                    raise NotImplementedError(
                        f"rewriting {name!r} (soft and external links: "
                        "the writer writes hard links only)")
                src = r[name]
                t = src._type
                if (t.vlen == "seq" or t.ref == "region" or src.shape is None
                        or src._efl is not None
                        or src._layout[0] == "virtual"):
                    raise NotImplementedError(
                        f"rewriting {name!r} (variable-length sequences, "
                        "region references, null dataspaces, external "
                        "storage and virtual datasets)")
                dtype = string_dtype() if t.vlen else t.dtype
                d = _WriteDataset(self, name, src.shape, dtype, None,
                                  src.chunks, list(src._filters))
                d._tbytes = src._tbytes
                if src.chunks and not t.vlen:
                    for nbytes, mask, offs, addr in src._chunks():
                        d._direct[tuple(offs)] = (r._read(addr, nbytes),
                                                  mask)
                elif src.size:
                    d._data = _as_stored(src[...], dtype)
                d.attrs._items = _taken_attrs(src.attrs)
                self._dsets[name] = d

    def create_dataset(self, name, shape=None, dtype=None, data=None,
                       chunks=None, compression=None, compression_opts=None,
                       shuffle=False):
        """A new dataset, with h5py's checks and defaults (filters imply
        chunks, guessed as h5py guesses them; gzip level 4)."""
        if name in self._dsets:
            raise ValueError(f"Unable to create dataset (name already "
                             f"exists): {name!r}")
        if data is not None:
            kind = None if dtype is None else np.dtype(dtype).kind
            data = np.asarray(data, dtype=object if kind == "O" else None)
            shape = data.shape if shape is None else tuple(shape)
            dtype = data.dtype if dtype is None else np.dtype(dtype)
        dtype = np.dtype(dtype if dtype is not None else "f4")
        shape = tuple(int(s) for s in shape)
        _type_of(dtype)     # raises for a dtype without an HDF5 form
        if shape == () and (chunks or compression or compression_opts
                            or shuffle):
            raise TypeError("Scalar datasets don't support chunk/filter "
                            "options")
        if chunks not in (None, True) and len(tuple(chunks)) != len(shape):
            raise ValueError('"chunks" must have same rank as dataset shape')
        level = None
        if compression is not None:
            if compression != "gzip":
                raise ValueError(f'Compression filter "{compression}" is '
                                 "unavailable")
            level = 4 if compression_opts is None else compression_opts
            if level not in range(10):
                raise ValueError("GZIP setting must be an integer from 0-9, "
                                 f"not {compression_opts!r}")
        elif compression_opts is not None:
            raise TypeError("Compression method must be specified")
        if chunks not in (None, True) and any(
                c > s for c, s in zip(chunks, shape)):
            raise ValueError(
                "Chunk shape must not be greater than data shape in any "
                f"dimension. {tuple(chunks)} is not compatible with {shape}")
        if chunks is True or (chunks is None and (shuffle or level
                                                  is not None)):
            chunks = guess_chunk(shape, dtype.itemsize)
        chunks = tuple(int(c) for c in chunks) if chunks else None
        esize = 16 if dtype.kind == "O" else dtype.itemsize
        filters = []
        if shuffle:
            filters.append(hf.Filter(hf.SHUFFLE, (esize,)))
        if level is not None:
            filters.append(hf.Filter(hf.DEFLATE, (int(level),)))
        if data is not None:
            data = _as_stored(data, dtype)
        d = self._dsets[name] = _WriteDataset(self, name, shape, dtype, data,
                                              chunks, filters)
        return d

    def __getitem__(self, name):
        return self._dsets[name]

    def __delitem__(self, name):
        del self._dsets[name]

    def __contains__(self, name):
        return name in self._dsets

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        self._closed = True

    # -- layout -----------------------------------------------------------
    #
    # superblock | global heap collections | root object header | local
    # heap | group B-tree node | SNODs | dataset object headers | chunk
    # B-tree nodes | raw data (contiguous data and chunks, by dataset).
    # The heap's objects are known (in size) before any address, so the
    # collections sit right after the superblock and every string's heap
    # id is known before the chunks that hold it are compressed; the
    # metadata is then serialized twice, first with placeholder addresses
    # to learn each block's length, then with the addresses laid out.

    def close(self):
        if self._closed:
            return
        self._closed = True
        names = sorted(self._dsets, key=lambda k: k.encode("utf-8"))
        if len(names) > 4 * _LEAF_K * _GROUP_K:
            raise NotImplementedError(
                f"{len(names)} datasets in one group (at most "
                f"{4 * _LEAF_K * _GROUP_K})")
        dsets = [self._dsets[n] for n in names]
        for d in dsets:
            if d._dimlist is not None:
                d.attrs._set("DIMENSION_LIST", (
                    _TYPE_DIMLIST, (len(d.shape),), "dimlist", d._dimlist))
            if d._reflist:
                d.attrs._set("REFERENCE_LIST", (
                    _TYPE_REFLIST, (len(d._reflist),), "reflist",
                    list(d._reflist)))
        heap = _Heap()
        ids = {}    # per attribute and string dataset, each element's heap id
        for obj in [self] + dsets:
            for name, (_, _, kind, payload) in obj.attrs._items.items():
                if kind == "vstr":
                    ids[id(obj), name] = [heap.put(v) if v else None
                                          for v in payload]
                elif kind == "dimlist":
                    ids[id(obj), name] = [
                        heap.put((8 * len(sc), lambda at, sc=sc: b"".join(
                            struct.pack("<Q", at(("oh", s.name)))
                            for s in sc))) if sc else None for sc in payload]
            if isinstance(obj, _WriteDataset) and obj.dtype.kind == "O" \
                    and obj._data is not None:
                ids[id(obj), None] = [heap.put(v) if v else None
                                      for v in obj._data.reshape(-1)]
        sb_len = 96
        bases, pos = [], sb_len
        for size in heap.sizes():
            bases.append(pos)
            pos += _align8(size)

        def descriptors(obj, name, lengths):
            out = np.zeros(len(lengths), _VLEN)
            for i, (n, hid) in enumerate(zip(lengths, ids[id(obj), name])):
                if hid is not None:
                    out[i] = (n, bases[hid[0]], hid[1])
            return out

        stored = {}
        for d in dsets:
            if d._data is None:
                continue
            if d.dtype.kind == "O":
                stored[d.name] = descriptors(
                    d, None, [len(v) for v in d._data.reshape(-1)]
                ).reshape(d.shape)
            else:
                stored[d.name] = d._data
        chunked = {d.name: d._chunk_items(stored.get(d.name))
                   for d in dsets if d.chunks}
        raw = []    # (dataset, stored bytes) in file order
        for d in dsets:
            if d.chunks:
                raw += [(d.name, buf) for _, buf, _ in chunked[d.name]]
            elif d.name in stored and _nelem(d.shape):
                raw.append((d.name, _stored(stored[d.name])))

        def serialize(at):
            return self._metadata(dsets, chunked, heap, bases, ids,
                                  descriptors, at)

        first = serialize(lambda key: 0)
        addrs = {}
        for key, blk in first:
            addrs[key] = pos
            pos += _align8(len(blk))
        raw_at = {}
        for name, buf in raw:
            raw_at.setdefault(name, []).append(pos)
            pos += _align8(len(buf))
        addrs["eof"] = pos
        addrs["raw"] = raw_at

        def at(key):
            return addrs[key]

        blocks = serialize(at)
        assert [len(b) for _, b in blocks] == [len(b) for _, b in first]
        sb = (_SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
              + struct.pack("<HHI", _LEAF_K, _GROUP_K, 0)
              + struct.pack("<QQQQ", 0, _UNDEF, pos, _UNDEF)
              + struct.pack("<QQII", 0, at("root"), 1, 0)
              + struct.pack("<QQ", at("btree"), at("lheap")))
        assert len(sb) == sb_len
        target = self.filename
        if self._append:
            target = f"{self.filename}.{os.getpid()}.rewrite"
        with open(target, "wb") as fh:
            fh.write(sb)
            for blk in heap.blocks(at):
                fh.write(_pad8(blk))
            for _, blk in blocks:
                fh.write(_pad8(blk))
            for _, buf in raw:
                fh.write(_pad8(buf))
            if fh.tell() != pos:
                raise AssertionError("layout and file disagree")
        if self._append:
            os.replace(target, self.filename)

    def _metadata(self, dsets, chunked, heap, bases, ids, descriptors, at):
        """Every metadata block after the heap, in file order, as
        ``[(key, bytes)]``, with the addresses ``at(key)``."""
        blocks = []

        def attr_messages(obj):
            msgs = []
            for name, (tbytes, shape, kind, payload) in \
                    obj.attrs._items.items():
                if kind == "raw":
                    data = payload
                elif kind == "vstr":
                    data = descriptors(obj, name,
                                       [len(v) for v in payload]).tobytes()
                elif kind == "dimlist":
                    data = descriptors(obj, name,
                                       [len(sc) for sc in payload]).tobytes()
                else:   # reflist
                    data = b"".join(struct.pack("<QII", at(("oh", ds.name)),
                                                i, 0) for ds, i in payload)
                nm = name.encode("utf-8") + b"\0"
                sp = _space(shape)
                body = (struct.pack("<BBHHH", 1, 0, len(nm), len(tbytes),
                                    len(sp)) + _pad8(nm) + _pad8(tbytes)
                        + _pad8(sp) + data)
                if len(body) > 0xFFF0:
                    raise ValueError(
                        f"Unable to create attribute {name!r} (object "
                        "header message is too large)")
                msgs.append(_message(_ATTRIBUTE, body))
            return msgs

        blocks.append(("root", _object_header(
            [_message(_SYMBOL_TABLE, struct.pack("<QQ", at("btree"),
                                                 at("lheap")))]
            + attr_messages(self))))
        # local heap of the member names: "" at 0, then each name
        names, name_off = bytearray(8), {}
        for d in dsets:
            name_off[d.name] = len(names)
            names += _pad8(d.name.encode("utf-8") + b"\0")
        blocks.append(("lheap", b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(names), 1, at("lheap") + 32) + bytes(names)))
        # the group B-tree: one level-0 node over SNODs of 2K entries; key
        # i + 1 is the last name of SNOD i
        per = 2 * _LEAF_K
        groups = [dsets[i:i + per] for i in range(0, len(dsets), per)] \
            or [[]]
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups), _UNDEF,
                                     _UNDEF) + struct.pack("<Q", 0)
        for gi, g in enumerate(groups):
            node += struct.pack("<QQ", at(("snod", gi)),
                                name_off[g[-1].name] if g else 0)
        node += bytes(24 + (4 * _GROUP_K + 1) * 8 - len(node))
        blocks.append(("btree", node))
        for gi, g in enumerate(groups):
            snod = b"SNOD\x01\0" + struct.pack("<H", len(g))
            for d in g:
                snod += struct.pack("<QQII16x", name_off[d.name],
                                    at(("oh", d.name)), 0, 0)
            snod += bytes(8 + per * 40 - len(snod))
            blocks.append((("snod", gi), snod))
        for d in dsets:
            esize = 16 if d.dtype.kind == "O" else d.dtype.itemsize
            n = _nelem(d.shape)
            msgs = [_message(_DATASPACE, _space(d.shape)),
                    _message(_DATATYPE, d._tbytes or _type_of(d.dtype),
                             flags=1),
                    # version 2: allocation incremental (chunked) or late,
                    # written if set (at allocation for strings), default
                    _message(_FILL, struct.pack(
                        "<BBBBI", 2, 3 if d.chunks else 2,
                        0 if d.dtype.kind == "O" else 2, 1, 0), flags=1)]
            if d.chunks:
                items = chunked[d.name]
                root = ("cbtree", d.name, len(_tree_levels(len(items))) - 1,
                        0)
                lay = struct.pack("<BBBQ", 3, 2, len(d.shape) + 1,
                                  at(root) if items else _UNDEF)
                lay += struct.pack(f"<{len(d.shape) + 1}I", *d.chunks, esize)
            else:
                raw = at("raw")
                addr = (raw[d.name][0] if raw else 0) \
                    if d._data is not None and n else _UNDEF
                lay = struct.pack("<BBQQ", 3, 1, addr, n * esize)
            msgs.append(_message(_LAYOUT, lay))
            if d._filters:
                pl = struct.pack("<BB6x", 1, len(d._filters))
                for fid, cd, flags, name in d._filters:
                    name = hf.NAMES.get(fid, name)
                    nm = _pad8(name.encode() + b"\0") if name else b""
                    pl += struct.pack("<HHHH", fid, len(nm), flags, len(cd))
                    pl += nm + struct.pack(f"<{len(cd)}I", *cd)
                    pl += bytes(4 * (len(cd) % 2))
                msgs.append(_message(_PIPELINE, pl, flags=1))
            msgs += attr_messages(d)
            blocks.append((("oh", d.name), _object_header(msgs)))
        for d in dsets:
            if d.chunks and chunked[d.name]:
                blocks += self._chunk_tree(d, chunked[d.name], at)
        return blocks

    @staticmethod
    def _chunk_tree(d, items, at):
        """The chunk B-tree's nodes, level by level: up to 2K children
        per node, keys of (stored bytes, filter mask, offsets + [0]); a
        node's last key is the corner past its last chunk."""
        nd = len(d.shape)
        raw = at("raw")
        addrs = raw[d.name] if raw else [0] * len(items)

        def key(nbytes, mask, offs):
            return struct.pack("<II", nbytes, mask) + struct.pack(
                f"<{nd + 1}Q", *offs, 0)

        end = tuple(o + c for o, c in zip(items[-1][0], d.chunks))
        # children: (first chunk's key fields, address)
        children = [((len(buf), mask, offs), a)
                    for (offs, buf, mask), a in zip(items, addrs)]
        out, lvl = [], 0
        size = 24 + 2 * _CHUNK_K * 8 + (2 * _CHUNK_K + 1) * (8 + 8 * (nd + 1))
        while True:
            nodes = [children[i:i + 2 * _CHUNK_K]
                     for i in range(0, len(children), 2 * _CHUNK_K)]
            keys = [("cbtree", d.name, lvl, j) for j in range(len(nodes))]
            for j, members in enumerate(nodes):
                left = at(keys[j - 1]) if j else _UNDEF
                right = at(keys[j + 1]) if j + 1 < len(nodes) else _UNDEF
                blk = b"TREE" + struct.pack("<BBHQQ", 1, lvl, len(members),
                                            left, right)
                for kf, child in members:
                    blk += key(*kf) + struct.pack("<Q", child)
                last = nodes[j + 1][0][0][2] if j + 1 < len(nodes) else end
                blk += key(0, 0, last)
                out.append((keys[j], blk + bytes(size - len(blk))))
            if len(nodes) == 1:
                return out
            children = [(m[0][0], at(keys[j])) for j, m in enumerate(nodes)]
            lvl += 1
