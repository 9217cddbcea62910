r"""
:mod:`io.hdf5_v2` -- the HDF5 1.8+ structures, read-only
=========================================================

The reader's half of :mod:`io.hdf5` for files written with the newer
file format (h5py's ``libver="latest"`` or ``("v108", ...)``,
``track_order=True``, and every netCDF-4 file from the netCDF-C
library, which tracks the creation order of links and attributes). Each
structure below is named as in the *HDF5 File Format Specification,
Version 3.0*:

- the **Jenkins lookup3** checksum (``hashlittle``) that every version-2
  metadata structure carries, verified wherever one is stored; a
  mismatch is an :class:`OSError`, as the library reports it;
- **Level 0A, superblock versions 2 and 3**, and the superblock extension
  (its shared-message table is refused, its other messages skipped);
- **Level 2A1, version 2 object headers** (``OHDR`` with ``OCHK``
  continuation blocks, gaps, creation-order fields, stored times and
  attribute phase-change values);
- **Level 2A2 messages**: link info (0x02), link (0x06), group info
  (0x0A), attribute info (0x15), data layout version 4 (0x08) with
  every chunk index (single chunk, implicit, fixed array, extensible
  array, version 2 B-tree; *Appendix C, Types of Indexes for Dataset
  Chunks*);
- **Level 1G, fractal heaps** (``FRHP``, ``FHIB``, ``FHDB``: managed
  objects through the doubling table, tiny objects in the heap ID, huge
  objects through their version-2 B-tree or directly addressed);
- **Level 1A2, version 2 B-trees** (``BTHD``, ``BTIN``, ``BTLF``) with
  record types 1 (huge heap objects), 5 and 6 (dense links), 8 and 9
  (dense attributes), 10 and 11 (chunks);
- **Level 1H, fixed arrays** (``FAHD``, ``FADB`` and its pages) and
  **Level 1I, extensible arrays** (``EAHD``, ``EAIB``, ``EASB``,
  ``EADB`` and their pages) as chunk indexes;
- data layout class 3, **virtual datasets** (their mappings are read by
  :mod:`io.hdf5_extern`), and **external links** in link messages.

The filters of a chunk are undone in :mod:`io.hdf5_filters`.

Nothing here writes: :mod:`io.hdf5` writes only superblock 0, version-1
object headers and version-1 B-trees, as h5py does by default. Every
function takes the reading ``_ReadFile`` (``f._b`` the mapped file,
``f._addr`` an address to an offset in it) and returns offsets into the
mapping, so both header versions feed the same message parsers.
"""

from __future__ import annotations

import struct
from bisect import bisect_right

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_M = 0xFFFFFFFF

# object header message types read here
_CONTINUATION, _SHARED_TABLE = 0x10, 0x0F


# ---------------------------------------------------------------------------
# checksums


def lookup3(data, initval=0):
    """Bob Jenkins' ``hashlittle`` (lookup3.c), as the library's
    ``H5_checksum_lookup3`` computes it over ``data``."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    nb = (n - 1) // 12          # blocks mixed before the last 1-12 bytes
    words = struct.unpack_from(f"<{3 * nb}I", data, 0)
    for i in range(0, 3 * nb, 3):
        a = (a + words[i]) & _M
        b = (b + words[i + 1]) & _M
        c = (c + words[i + 2]) & _M
        a = (a - c) & _M
        a ^= ((c << 4) & _M) | (c >> 28)
        c = (c + b) & _M
        b = (b - a) & _M
        b ^= ((a << 6) & _M) | (a >> 26)
        a = (a + c) & _M
        c = (c - b) & _M
        c ^= ((b << 8) & _M) | (b >> 24)
        b = (b + a) & _M
        a = (a - c) & _M
        a ^= ((c << 16) & _M) | (c >> 16)
        c = (c + b) & _M
        b = (b - a) & _M
        b ^= ((a << 19) & _M) | (a >> 13)
        a = (a + c) & _M
        c = (c - b) & _M
        c ^= ((b << 4) & _M) | (b >> 28)
        b = (b + a) & _M
    ta, tb, tc = struct.unpack("<3I", bytes(data[12 * nb:]).ljust(12, b"\0"))
    a, b, c = (a + ta) & _M, (b + tb) & _M, (c + tc) & _M
    c ^= b
    c = (c - (((b << 14) & _M) | (b >> 18))) & _M
    a ^= c
    a = (a - (((c << 11) & _M) | (c >> 21))) & _M
    b ^= a
    b = (b - (((a << 25) & _M) | (a >> 7))) & _M
    c ^= b
    c = (c - (((b << 16) & _M) | (b >> 16))) & _M
    a ^= c
    a = (a - (((c << 4) & _M) | (c >> 28))) & _M
    b ^= a
    b = (b - (((a << 14) & _M) | (a >> 18))) & _M
    c ^= b
    c = (c - (((b << 24) & _M) | (b >> 8))) & _M
    return c


def verify(b, start, end, what):
    """Hold the checksum stored at ``b[end:end + 4]`` to the one of
    ``b[start:end]``."""
    if end + 4 > len(b):
        raise OSError(f"{what} is cut short")
    stored = struct.unpack_from("<I", b, end)[0]
    if lookup3(b[start:end]) != stored:
        raise OSError(f"incorrect metadata checksum in the {what}")


def _signature(b, a, sig, what):
    if b[a:a + 4] != sig:
        raise OSError(f"bad {what} signature at {a}")


def _uint(b, p, n):
    return int.from_bytes(b[p:p + n], "little")


def _log2(n):
    return int(n).bit_length() - 1


def _enc_size(n):
    """Bytes the library uses to encode values up to ``n``
    (``H5VM_limit_enc_size``)."""
    return _log2(n) // 8 + 1


# ---------------------------------------------------------------------------
# superblock and object headers


def superblock(f, a):
    """Versions 2 and 3 at ``a``: ``(root object header address,
    superblock extension address)``; sets the file's sizes of offsets
    and lengths (``f._sizes``)."""
    b = f._b
    so = b[a + 9]
    f._sizes(so, b[a + 10])
    # base, extension, end of file and root object header addresses
    verify(b, a, a + 12 + 4 * so, "superblock")
    return f._o(a + 12 + 3 * so), f._o(a + 12 + so)


def check_extension(f, ext):
    """The superblock extension's messages: a shared-message table is
    refused; the others (B-tree K values, file space info and the like)
    change nothing the reader does."""
    if ext == UNDEF:
        return
    for mtype, _, _ in f._messages(ext):
        if mtype == _SHARED_TABLE:
            raise NotImplementedError("shared object header messages")


class Messages(list):
    """``[(type, data offset, size)]`` of an object header; ``flags`` is
    a version-2 header's flags byte (0 for version 1) and ``order`` maps
    a message's data offset to its creation order, where the header
    tracks it."""

    flags = 0

    def __init__(self, items=(), flags=0, order=None):
        super().__init__(items)
        self.flags, self.order = flags, order or {}

    @property
    def attrs_by_creation(self):
        """Whether h5py lists the attributes in creation order."""
        return bool(self.flags & 0x04)


def object_header(f, a):
    """The version-2 object header at offset ``a``: its messages,
    continuation blocks (``OCHK``) followed, checksums verified."""
    b = f._b
    if b[a + 4] != 2:
        raise OSError(f"bad version-2 object header version {b[a + 4]}")
    flags = b[a + 5]
    p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    size = _uint(b, p, width)
    p += width
    verify(b, a, p + size, "object header")
    tracked = bool(flags & 0x04)
    head = 6 if tracked else 4
    out = Messages(flags=flags)
    blocks = [(p, p + size)]
    while blocks:
        p, end = blocks.pop(0)
        while p + head <= end:
            mtype, msize, mflags = b[p], b[p + 1] | (b[p + 2] << 8), b[p + 3]
            q = p + head
            if q + msize > end:
                raise OSError("object header message overruns its block")
            if mtype == _CONTINUATION:
                c, c_len = f._addr(f._o(q)), f._l(q + f._so)
                _signature(b, c, b"OCHK", "object header continuation")
                verify(b, c, c + c_len - 4, "object header continuation")
                blocks.append((c + 4, c + c_len - 4))
            elif mtype:
                if mflags & 0x02:
                    raise NotImplementedError(
                        "shared object header messages")
                out.append((mtype, q, msize))
                if tracked:
                    out.order[q] = struct.unpack_from("<H", b, p + 4)[0]
            p = q + msize
    return out


# ---------------------------------------------------------------------------
# version 2 B-trees


def btree2(f, addr, types):
    """Offsets of every record of the version-2 B-tree at ``addr``, in
    the tree's order, and the record size; the tree's type must be one
    of ``types``."""
    b = f._b
    so = f._so
    a = f._addr(addr)
    _signature(b, a, b"BTHD", "version 2 B-tree header")
    btype = b[a + 5]
    if btype not in types:
        raise OSError(f"version 2 B-tree of type {btype}, not {types}")
    node, rec, depth = struct.unpack_from("<IHH", b, a + 6)
    # split and merge percents, root node address, its records, total
    root = f._o(a + 16)
    nroot = struct.unpack_from("<H", b, a + 16 + so)[0]
    verify(b, a, a + 18 + so + f._sl, "version 2 B-tree header")
    # records per node and the widths of the child pointers' counts
    # (H5B2__hdr_init)
    max_nrec = [(node - 10) // rec]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _enc_size(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node - 10) // (rec + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_enc_size(cum[d]))
    out = []

    def walk(addr, nrec, d):
        a = f._addr(addr)
        if d == 0:
            _signature(b, a, b"BTLF", "version 2 B-tree leaf")
            verify(b, a, a + 6 + nrec * rec, "version 2 B-tree leaf")
            out.extend(a + 6 + i * rec for i in range(nrec))
            return
        _signature(b, a, b"BTIN", "version 2 B-tree internal node")
        p = a + 6 + nrec * rec
        kids = []
        for _ in range(nrec + 1):
            kids.append((f._o(p), _uint(b, p + so, nrec_size)))
            p += so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        verify(b, a, p, "version 2 B-tree internal node")
        for i, (child, n) in enumerate(kids):
            walk(child, n, d - 1)
            if i < nrec:
                out.append(a + 6 + i * rec)

    if root != UNDEF and nroot:
        walk(root, nroot, depth)
    return out, rec


# ---------------------------------------------------------------------------
# fractal heaps


class FractalHeap:
    """The fractal heap at ``addr``: :meth:`object` finds an object from
    its heap ID."""

    def __init__(self, f, addr):
        self._f = f
        b = f._b
        so, sl = f._so, f._sl
        a = f._addr(addr)
        _signature(b, a, b"FRHP", "fractal heap header")
        self.id_len, filt, self.flags, self.max_man = struct.unpack_from(
            "<HHBI", b, a + 5)
        # the next huge object ID, the huge objects' B-tree, then nine
        # lengths and the free-space manager's address (free space and
        # object counts), then the doubling table
        p = a + 14
        self.huge_btree = f._o(p + sl)
        p += 10 * sl + 2 * so
        self.width = struct.unpack_from("<H", b, p)[0]
        self.start, self.max_direct = f._l(p + 2), f._l(p + 2 + sl)
        p += 2 + 2 * sl
        self.max_bits = struct.unpack_from("<H", b, p)[0]
        self.root = f._o(p + 4)
        self.rows = struct.unpack_from("<H", b, p + 4 + so)[0]
        p += 6 + so
        if filt:
            raise NotImplementedError("filtered fractal heaps")
        verify(b, a, p, "fractal heap header")
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8,
                            _enc_size(self.max_man))
        self.direct_rows = _log2(self.max_direct) - _log2(self.start) + 2
        self._blocks, self._huge = None, None
        self._checked = set()

    def _row_size(self, r):
        return self.start if r == 0 else self.start << (r - 1)

    def _direct(self):
        """``(heap offsets, sizes, file offsets)`` of every direct block,
        in heap order."""
        if self._blocks is not None:
            return self._blocks
        out = []
        if self.root != UNDEF:
            if self.rows == 0:
                out.append((0, self.start, self._f._addr(self.root)))
            else:
                self._indirect(self.root, self.rows, out)
        out.sort()
        self._blocks = ([o for o, _, _ in out], out)
        return self._blocks

    def _indirect(self, addr, nrows, out):
        b = self._f._b
        a = self._f._addr(addr)
        _signature(b, a, b"FHIB", "fractal heap indirect block")
        so = self._f._so
        off = _uint(b, a + 5 + so, self.off_size)
        p = a + 5 + so + self.off_size
        children = []
        for r in range(nrows):
            size = self._row_size(r)
            for _ in range(self.width):
                child = self._f._o(p)
                p += so
                if child != UNDEF:
                    children.append((r, off, size, child))
                off += size
        verify(b, a, p, "fractal heap indirect block")
        first = _log2(self.start * self.width)
        for r, o, size, child in children:
            if r < self.direct_rows:
                out.append((o, size, self._f._addr(child)))
            else:
                self._indirect(child, _log2(size) - first + 1, out)

    def object(self, p):
        """``(file offset, size)`` of the object whose heap ID is at file
        offset ``p``."""
        b = self._f._b
        kind = (b[p] >> 4) & 0x03
        if b[p] >> 6:
            raise OSError(f"fractal heap ID version {b[p] >> 6}")
        if kind == 0:       # managed: offset and length in the heap
            off = _uint(b, p + 1, self.off_size)
            n = _uint(b, p + 1 + self.off_size, self.len_size)
            offs, blocks = self._direct()
            i = bisect_right(offs, off) - 1
            if i < 0 or off + n > blocks[i][0] + blocks[i][1]:
                raise OSError(f"fractal heap offset {off} in no block")
            o, size, at = blocks[i]
            self._check_direct(o, size, at)
            return at + off - o, n
        if kind == 1:       # huge: directly addressed, or by its B-tree
            f = self._f
            if self.id_len - 1 >= f._so + f._sl:
                return f._addr(f._o(p + 1)), f._l(p + 1 + f._so)
            key = _uint(b, p + 1, min(self.id_len - 1, 8))
            if self._huge is None:      # object ID -> (address, length)
                recs, _ = btree2(self._f, self.huge_btree, (1,))
                self._huge = {}
                for r in recs:   # address, length, object ID
                    n = f._l(r + f._so)
                    self._huge[f._l(r + f._so + f._sl)] = (
                        f._addr(f._o(r)), n)
            if key not in self._huge:
                raise OSError(f"huge fractal heap object {key} not found")
            return self._huge[key]
        if kind == 2:       # tiny: the object is in the ID
            if self.id_len <= 18:
                return p + 1, (b[p] & 0x0F) + 1
            return p + 2, (((b[p] & 0x0F) << 8) | b[p + 1]) + 1
        raise OSError(f"fractal heap ID type {kind}")

    def _check_direct(self, o, size, at):
        if not self.flags & 0x02 or o in self._checked:
            return
        b = self._f._b
        _signature(b, at, b"FHDB", "fractal heap direct block")
        q = at + 5 + self._f._so + self.off_size
        block = bytearray(b[at:at + size])
        stored = struct.unpack_from("<I", block, q - at)[0]
        block[q - at:q - at + 4] = b"\0\0\0\0"
        if lookup3(block) != stored:
            raise OSError("incorrect metadata checksum in the fractal heap "
                          "direct block")
        self._checked.add(o)


# ---------------------------------------------------------------------------
# links and dense attributes


def link_info(f, p):
    """The link info message: ``(creation order tracked, fractal heap
    address, name index B-tree address)``."""
    flags = f._b[p + 1]
    q = p + 2 + (8 if flags & 0x01 else 0)
    return bool(flags & 0x01), f._o(q), f._o(q + f._so)


def parse_link(f, p):
    """The link message at ``p``: ``(name, creation order, kind,
    target)`` with kind ``"hard"`` (target an address), ``"soft"``
    (target a path) or ``"external"`` (target ``(file name, path)``)."""
    b = f._b
    flags = b[p + 1]
    q = p + 2
    ltype = 0
    if flags & 0x08:
        ltype, q = b[q], q + 1
    order = None
    if flags & 0x04:
        order, q = struct.unpack_from("<q", b, q)[0], q + 8
    if flags & 0x10:
        q += 1
    w = 1 << (flags & 0x03)
    n = _uint(b, q, w)
    q += w
    name = bytes(b[q:q + n]).decode("utf-8")
    q += n
    if ltype == 0:
        return name, order, "hard", f._o(q)
    if ltype == 1:
        n = struct.unpack_from("<H", b, q)[0]
        return name, order, "soft", bytes(b[q + 2:q + 2 + n]).decode("utf-8")
    if ltype == 64:     # version and flags, then two null-ended strings
        n = struct.unpack_from("<H", b, q)[0]
        if b[q + 2] & 0xF0 or b[q + 2] & 0x0F:
            raise NotImplementedError(
                f"external link {name!r} of version {b[q + 2] >> 4}, "
                f"flags {b[q + 2] & 0x0F}")
        file, path = bytes(b[q + 3:q + 2 + n]).split(b"\0")[:2]
        return name, order, "external", (file.decode("utf-8"),
                                         path.decode("utf-8"))
    raise NotImplementedError(f"link type {ltype} ({name!r})")


def dense_links(f, heap, names):
    """Link message offsets of a group's dense storage: its fractal heap
    through the name index (record type 5: name hash, heap ID)."""
    if heap == UNDEF:
        return []
    h = FractalHeap(f, heap)
    recs, _ = btree2(f, names, (5,))
    return [h.object(r + 4)[0] for r in recs]


def attr_info(f, p):
    """The attribute info message: ``(fractal heap address, name index
    B-tree address)``."""
    flags = f._b[p + 1]
    q = p + 2 + (2 if flags & 0x01 else 0)
    return f._o(q), f._o(q + f._so)


def dense_attrs(f, heap, names):
    """``[(attribute message offset, creation order)]`` of an object's
    dense attribute storage, through its name index (record type 8:
    heap ID, message flags, creation order, name hash)."""
    if heap == UNDEF:
        return []
    h = FractalHeap(f, heap)
    recs, _ = btree2(f, names, (8,))
    out = []
    for r in recs:
        mflags, order = struct.unpack_from("<BI", f._b, r + 8)
        if mflags & 0x02:
            raise NotImplementedError("shared object header messages")
        out.append((h.object(r)[0], order))
    return out


# ---------------------------------------------------------------------------
# data layout version 4 and its chunk indexes

#: bytes of a version-4 layout's index parameters: implicit, fixed array,
#: extensible array, version 2 B-tree
_INDEX_PARAMS = {2: 0, 3: 1, 4: 5, 5: 6}


def parse_layout4(f, p):
    """A version-4 data layout message: ``("compact", bytes)``,
    ``("contiguous", address)``, ``("virtual", global heap address,
    object index)`` or ``("chunked", dims, index)`` with ``dims`` the
    chunk's dimensions and element size and ``index`` ``(kind, address,
    info, flags)``: ``info`` a filtered single chunk's ``(size, filter
    mask)``, else ``()``."""
    b = f._b
    cls = b[p + 1]
    if cls == 0:
        n = struct.unpack_from("<H", b, p + 2)[0]
        return ("compact", bytes(b[p + 4:p + 4 + n]))
    if cls == 1:
        return ("contiguous", f._o(p + 2))
    if cls == 3:
        return ("virtual", f._o(p + 2),
                struct.unpack_from("<I", b, p + 2 + f._so)[0])
    if cls != 2:
        raise NotImplementedError(f"data layout class {cls}")
    flags, nd, w = b[p + 2], b[p + 3], b[p + 4]
    q = p + 5
    dims = tuple(_uint(b, q + i * w, w) for i in range(nd))
    q += nd * w
    kind = b[q]
    q += 1
    info = ()
    if kind == 1 and flags & 0x02:      # a filtered single chunk's size, mask
        info = (f._l(q), struct.unpack_from("<I", b, q + f._sl)[0])
        q += f._sl + 4
    elif kind in _INDEX_PARAMS:
        # the arrays' and the B-tree's own headers repeat their parameters
        q += _INDEX_PARAMS[kind]
    elif kind != 1:
        raise NotImplementedError(f"chunk index type {kind}")
    return ("chunked", dims, (kind, f._o(q), info, flags))


def _grid(shape, maxshape, chunk):
    """Chunks per dimension of the index's linear order: over the
    maximum shape where it is fixed."""
    return [-(-(m if m != UNDEF else s) // c)
            for s, m, c in zip(shape, maxshape, chunk)]


def _entries(raw, n, esize, filtered, so):
    """Fixed- and extensible-array chunk entries: ``(addresses, stored
    sizes, filter masks)``, of ``n`` entries of ``esize`` bytes whose
    addresses take ``so`` bytes (the undefined one :data:`UNDEF`)."""
    a = np.frombuffer(raw, np.uint8, n * esize).reshape(n, esize)
    wide = np.zeros((n, 8), np.uint8)
    wide[:, :so] = a[:, :so]
    addr = wide.view("<u8").reshape(-1)
    addr[addr == (1 << 8 * so) - 1] = UNDEF
    if not filtered:
        return addr, None, None
    w = esize - so - 4
    size = np.zeros((n, 8), np.uint8)
    size[:, :w] = a[:, so:so + w]
    mask = a[:, so + w:].copy().view("<u4").reshape(-1)
    return addr, size.view("<u8").reshape(-1), mask


def _bit(bitmap, i):
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def chunk_list(f, index, chunk, esize, shape, maxshape, filtered):
    """``[(stored bytes, filter mask, offsets, address)]`` of every
    written chunk under a version-4 index; ``chunk`` excludes the
    element size. Partial edge chunks of a layout flagged "don't filter
    partial edge chunks" come with every filter masked."""
    kind, addr, info, flags = index
    nd = len(chunk)
    nbytes = int(np.prod(chunk, dtype=np.int64)) * esize
    out = []
    if addr == UNDEF:
        return out
    if kind == 1:
        size, mask = info if info else (nbytes, 0)
        out.append((size, mask, (0,) * nd, addr))
    elif kind == 2:
        grid = _grid(shape, maxshape, chunk)
        for i, scaled in enumerate(np.ndindex(*grid)):
            if all(s * c < d for s, c, d in zip(scaled, chunk, shape)):
                out.append((nbytes, 0, scaled, addr + i * nbytes))
    elif kind == 3:
        out = _fixed_array(f, addr, chunk, shape, maxshape, nbytes)
    elif kind == 4:
        out = _extensible_array(f, addr, chunk, shape, maxshape, nbytes)
    else:
        recs, rec = btree2(f, addr, (10, 11))
        b = f._b
        so = f._so
        for r in recs:
            a = f._o(r)
            if rec == so + 8 * nd:
                size, mask, q = nbytes, 0, r + so
            else:
                w = rec - so - 4 - 8 * nd
                size = _uint(b, r + so, w)
                mask = struct.unpack_from("<I", b, r + so + w)[0]
                q = r + so + 4 + w
            scaled = struct.unpack_from(f"<{nd}Q", b, q)
            out.append((size, mask, scaled, a))
    res = []
    for size, mask, scaled, a in out:
        offs = tuple(int(s) * c for s, c in zip(scaled, chunk))
        if flags & 0x01 and filtered and any(
                o + c > d for o, c, d in zip(offs, chunk, shape)):
            size, mask = nbytes, 0xFFFFFFFF
        res.append((int(size), int(mask), offs, int(a)))
    return res


def _fixed_array(f, addr, chunk, shape, maxshape, nbytes):
    b = f._b
    a = f._addr(addr)
    _signature(b, a, b"FAHD", "fixed array header")
    client, esize, page_bits = b[a + 5], b[a + 6], b[a + 7]
    so, sl = f._so, f._sl
    n, dblk = f._l(a + 8), f._o(a + 8 + sl)
    verify(b, a, a + 8 + sl + so, "fixed array header")
    if dblk == UNDEF:
        return []
    d = f._addr(dblk)
    _signature(b, d, b"FADB", "fixed array data block")
    page = 1 << page_bits
    p = d + 6 + so
    raw = []
    if n > page:
        npages = -(-n // page)
        bitmap = bytes(b[p:p + (npages + 7) // 8])
        p += len(bitmap)
        verify(b, d, p, "fixed array data block")
        p += 4
        for i in range(npages):
            cnt = min(page, n - i * page)
            if _bit(bitmap, i):
                verify(b, p, p + cnt * esize, "fixed array data block page")
                raw.append((i * page, cnt, b[p:p + cnt * esize]))
            p += cnt * esize + 4
    else:
        verify(b, d, p + n * esize, "fixed array data block")
        raw.append((0, n, b[p:p + n * esize]))
    grid = _grid(shape, maxshape, chunk)
    out = []
    for first, cnt, buf in raw:
        addrs, sizes, masks = _entries(buf, cnt, esize, client == 1, so)
        for j in np.nonzero(addrs != UNDEF)[0]:
            scaled = np.unravel_index(first + int(j), grid)
            out.append((nbytes if sizes is None else sizes[j],
                        0 if masks is None else masks[j], scaled, addrs[j]))
    return out


def _extensible_array(f, addr, chunk, shape, maxshape, nbytes):
    b = f._b
    a = f._addr(addr)
    _signature(b, a, b"EAHD", "extensible array header")
    (client, esize, max_bits, iblk_n, dblk_min, sblk_min,
     page_bits) = b[a + 5:a + 12]
    so, sl = f._so, f._sl
    # six lengths (block counts and sizes), then the index block
    iblk = f._o(a + 12 + 6 * sl)
    verify(b, a, a + 12 + 6 * sl + so, "extensible array header")
    if iblk == UNDEF:
        return []
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    # super blocks: data blocks each and elements per data block
    nsblks = 1 + max_bits - _log2(dblk_min)
    sblk = [(1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min)
            for u in range(nsblks)]
    in_iblk = 2 * _log2(sblk_min)
    ndblk = 2 * (sblk_min - 1)
    i0 = f._addr(iblk)
    _signature(b, i0, b"EAIB", "extensible array index block")
    p = i0 + 6 + so
    raw = [(0, iblk_n, b[p:p + iblk_n * esize])]
    p += iblk_n * esize
    dblks = [f._o(p + so * i) for i in range(ndblk)]
    p += so * ndblk
    sblks = [f._o(p + so * i) for i in range(nsblks - in_iblk)]
    p += so * (nsblks - in_iblk)
    verify(b, i0, p, "extensible array index block")

    def data_block(at, first, cnt, bitmap):
        d = f._addr(at)
        _signature(b, d, b"EADB", "extensible array data block")
        q = d + 6 + so + off_size
        if cnt <= page:
            verify(b, d, q + cnt * esize, "extensible array data block")
            raw.append((first, cnt, b[q:q + cnt * esize]))
            return
        verify(b, d, q, "extensible array data block")
        q += 4
        for k in range(cnt // page):
            if _bit(bitmap, k):
                verify(b, q, q + page * esize,
                       "extensible array data block page")
                raw.append((first + k * page, page,
                            b[q:q + page * esize]))
            q += page * esize + 4

    # the index block's data blocks are those of its super blocks
    sizes = [cnt for nd, cnt in sblk[:in_iblk] for _ in range(nd)]
    first = iblk_n
    for at, cnt in zip(dblks, sizes):
        if at != UNDEF:
            data_block(at, first, cnt, b"")
        first += cnt
    for s, at in enumerate(sblks):
        u = in_iblk + s
        nd, cnt = sblk[u]
        if at == UNDEF:
            first += nd * cnt
            continue
        q = f._addr(at)
        _signature(b, q, b"EASB", "extensible array super block")
        q += 6 + so + off_size
        npages = cnt // page if cnt > page else 0
        bm = (npages + 7) // 8
        bitmaps = [bytes(b[q + k * bm:q + (k + 1) * bm]) for k in range(nd)]
        q += nd * bm
        addrs = [f._o(q + so * k) for k in range(nd)]
        verify(b, f._addr(at), q + so * nd, "extensible array super block")
        for k, da in enumerate(addrs):
            if da != UNDEF:
                data_block(da, first, cnt, bitmaps[k])
            first += cnt
    # the linear order: the unlimited dimension first, then the others
    unlim = [i for i, m in enumerate(maxshape) if m == UNDEF]
    u0 = unlim[0] if unlim else 0
    order = [u0] + [i for i in range(len(chunk)) if i != u0]
    grid = _grid(shape, maxshape, chunk)
    sgrid = [grid[i] for i in order]
    rest = int(np.prod(sgrid[1:], dtype=np.int64))
    out = []
    for first, cnt, buf in raw:
        addrs, sizes, masks = _entries(buf, cnt, esize, client == 1, so)
        for j in np.nonzero(addrs != UNDEF)[0]:
            k = first + int(j)
            sw = (k // rest,) + np.unravel_index(k % rest, sgrid[1:])
            scaled = [0] * len(chunk)
            for i, v in zip(order, sw):
                scaled[i] = int(v)
            out.append((nbytes if sizes is None else sizes[j],
                        0 if masks is None else masks[j], scaled, addrs[j]))
    return out
