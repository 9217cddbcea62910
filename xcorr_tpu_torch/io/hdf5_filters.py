r"""
:mod:`io.hdf5_filters` -- the filter pipeline of a chunk, undone
================================================================

:func:`unfilter` undoes one filter of a dataset's pipeline on one stored
chunk, as the HDF5 library does on read: deflate (zlib), shuffle and
fletcher32 here in Python; szip, scaleoffset and lzf in the native
library (``native/h5filters.cpp``, built with ``g++`` on first use by
:mod:`..native._cxx`; a failed build raises, and nothing falls back to
Python). The library's calls release the interpreter lock, so the
reader's threads (the read pool of ``io/hdf5_chunks.py``, and those of
``io/hdf5.py``'s plain chunked read) decode chunks in parallel. :func:`inflate` can stop at the bytes a read needs, and
:func:`unshuffle_into` writes a chunk's selected elements from their
byte planes into their place in the reader's array (``io/hdf5_chunks.py``).
nbit is read where the library stored the chunk as it was
(the type's full precision, which ``H5Z_set_local_nbit`` flags in its
second parameter); a packed nbit chunk is refused.

A filter is undone only where the chunk's filter mask says it was
applied: an optional filter the writer lacked (blosc, zstd, an unknown
id) is skipped there, as h5py skips it. A chunk that a filter outside
this list really filtered raises :class:`NotImplementedError` naming
the filter; a chunk that does not decode raises :class:`OSError`.

:func:`unlzf_plain` is the Python form of the lzf decoder, the native
one's reference in the tests.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import NamedTuple

import numpy as np

__all__ = ["Filter", "unfilter", "unlzf", "unlzf_plain", "unszip",
           "unscaleoffset", "unshuffle_into", "inflate", "NAMES",
           "OPTIONAL", "UNDONE"]

DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET = 1, 2, 3, 4, 5, 6
LZF = 32000
#: the library's names, written into a version-1 pipeline message
NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
         6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32015: "zstd"}
#: the filters :func:`unfilter` undoes
UNDONE = frozenset((DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET,
                    LZF))
#: the filters whose output is as long as their input
SAME_SIZE = frozenset((SHUFFLE, NBIT))
#: a filter's flag bit: the library may skip it where it cannot apply it
OPTIONAL = 0x0001


class Filter(NamedTuple):
    """One entry of a pipeline message: id, client data, flags and the
    stored name ("" where none is stored)."""
    id: int
    cd: tuple
    flags: int = OPTIONAL
    name: str = ""

    @property
    def label(self):
        return NAMES.get(self.id, self.name or str(self.id))


_SOURCES = ("h5filters.cpp",)
_lib = None
_lock = threading.Lock()
_u8 = ctypes.POINTER(ctypes.c_uint8)
_ERRORS = {-1: "corrupt or cut short", -2: "of another size than the chunk",
           -3: "of parameters the decoder does not take"}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from ..native import _cxx
            lib = ctypes.CDLL(_cxx.build("libxch5filters", _SOURCES))
            i64 = ctypes.c_int64
            lib.xch_unlzf.argtypes = [ctypes.c_char_p, i64, _u8, i64]
            lib.xch_unszip.argtypes = [ctypes.c_char_p, i64, _u8, i64] + \
                [ctypes.c_uint32] * 4
            lib.xch_unscaleoffset.argtypes = [
                ctypes.c_char_p, i64, _u8, i64,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32]
            for fn in (lib.xch_unlzf, lib.xch_unszip, lib.xch_unscaleoffset):
                fn.restype = i64
            _lib = lib
    return _lib


def _call(name, fn, src, want, *args):
    src = bytes(src)
    out = bytearray(want)
    view = (ctypes.c_uint8 * want).from_buffer(out) if want else None
    rc = fn(src, len(src), ctypes.cast(view, _u8), want, *args)
    if rc < 0:
        raise OSError(f"{name} chunk {_ERRORS.get(rc, rc)}")
    return out


def unlzf(src, want):
    """liblzf's ``lzf_decompress`` of ``src`` into ``want`` bytes (the
    stream h5py's lzf filter stores, without a header)."""
    return _call("lzf", _load().xch_unlzf, src, want)


def unszip(src, cd, want=None):
    """HDF5's szip filter undone: ``cd`` its client data (options mask,
    pixels per block, bits per pixel, pixels per scanline). ``want`` is
    the size the output must have where the caller knows it; else the
    size in the stream's header is taken."""
    if len(src) < 4 or len(cd) < 4:
        raise OSError("szip chunk cut short")
    if want is None:
        want = struct.unpack_from("<I", bytes(src[:4]))[0]
    mask, ppb, bpp, pps = cd[:4]
    return _call("szip", _load().xch_unszip, src, want, mask, bpp, ppb, pps)


def unscaleoffset(src, cd):
    """HDF5's scaleoffset filter undone (integer, and floating point by
    D-scaling)."""
    if len(cd) < 8:
        raise OSError("scaleoffset filter with short client data")
    arr = (ctypes.c_uint32 * len(cd))(*cd)
    return _call("scaleoffset", _load().xch_unscaleoffset, src,
                 int(cd[2]) * int(cd[4]), arr, len(cd))


def unlzf_plain(src, want):
    """:func:`unlzf` in Python, the native decoder's reference."""
    src = bytes(src)
    out = bytearray(want)
    ip = op = 0
    n = len(src)
    while ip < n:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:                       # a literal run
            ln = ctrl + 1
            if op + ln > want or ip + ln > n:
                raise OSError("lzf chunk corrupt or cut short")
            out[op:op + ln] = src[ip:ip + ln]
            ip += ln
            op += ln
            continue
        ln = ctrl >> 5                      # a back reference
        ref = op - ((ctrl & 0x1F) << 8) - 1
        if ln == 7:
            if ip >= n:
                raise OSError("lzf chunk corrupt or cut short")
            ln += src[ip]
            ip += 1
        if ip >= n:
            raise OSError("lzf chunk corrupt or cut short")
        ref -= src[ip]
        ip += 1
        ln += 2
        if ref < 0 or op + ln > want:
            raise OSError("lzf chunk corrupt or cut short")
        dist = op - ref
        if dist >= ln:
            out[op:op + ln] = out[ref:ref + ln]
        else:                               # overlapping: a repeated run
            out[op:op + ln] = (out[ref:op] * (ln // dist + 1))[:ln]
        op += ln
    if op != want:
        raise OSError("lzf chunk of another size than the chunk")
    return out


def unshuffle(buf, size):
    """The shuffle filter undone: ``size``-byte elements from their byte
    planes; a tail shorter than one element stays where it is."""
    if size <= 1 or len(buf) < size:
        return bytes(buf)
    n = len(buf) // size
    a = np.frombuffer(buf, np.uint8, n * size).reshape(size, n)
    return np.ascontiguousarray(a.T).tobytes() + bytes(buf[n * size:])


def unshuffle_into(buf, chunk, sel, dst):
    """The shuffle filter undone straight into ``dst``: ``buf`` holds a
    chunk of shape ``chunk`` as the byte planes of its elements (the last
    plane at least up to the last byte ``sel`` needs), ``sel`` is a
    slice per axis of the chunk, and ``dst`` an array of the chunk's
    elements of ``sel``'s shape, which receives them. Only the selected
    columns of each plane are read; each plane is one strided copy."""
    size = dst.dtype.itemsize
    n = 1
    strides = []
    for c in reversed(chunk):
        strides.insert(0, n)
        n *= c
    start = sum(s.start * st for s, st in zip(sel, strides))
    shape = tuple(s.stop - s.start for s in sel)
    out = dst[..., None].view(np.uint8)
    for k in range(size):
        out[..., k] = np.ndarray(shape, np.uint8, buf, k * n + start,
                                 tuple(strides))


def inflate(buf, want, need=None):
    """Deflate undone on ``buf``, a chunk of ``want`` bytes: all of it
    (``bufsize`` its size), or only its first ``need`` bytes. A stream
    that does not decode, or holds fewer bytes than are needed, raises
    :class:`OSError`; the bytes past ``need`` are not read, so damage
    there goes unseen."""
    try:
        if need is None or need >= want:
            return zlib.decompress(buf, bufsize=want)
        out = zlib.decompressobj().decompress(buf, need)
    except zlib.error as e:
        raise OSError(f"corrupt deflate chunk: {e}") from None
    if len(out) < need:
        raise OSError(f"deflate chunk cut short: {len(out)} of the {need} "
                      f"bytes needed")
    return out


def fletcher32(buf):
    """The library's ``H5_checksum_fletcher32`` of ``buf``: sums of
    big-endian 16-bit words (an odd byte is the high byte of a last
    word), each folded into 1..65535 (0 only for all zeros)."""
    n = len(buf)
    w = np.frombuffer(buf, ">u2", n // 2).astype(np.int64)
    if n % 2:
        w = np.append(w, np.int64(buf[-1]) << 8)
    m = len(w)
    s1 = int(w.sum())
    s2 = int((w * (np.arange(m, 0, -1, dtype=np.int64) % 65535)).sum())

    def fold(x):
        return 0 if x == 0 else (x - 1) % 65535 + 1

    return (fold(s2) << 16) | fold(s1)


def unfletcher32(buf):
    """The chunk without its trailing checksum, which must match (or
    match byte-swapped, as the library accepts for old files)."""
    if len(buf) < 4:
        raise OSError("fletcher32 chunk shorter than its checksum")
    data = buf[:-4]
    stored = struct.unpack("<I", bytes(buf[-4:]))[0]
    want = fletcher32(data)
    swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
    if stored not in (want, swapped):
        raise OSError("data error detected by fletcher32 checksum")
    return data


def unfilter(flt, buf, want, esize, exact=False):
    """Filter ``flt`` undone on ``buf``, a chunk of ``want`` bytes of
    ``esize``-byte elements once every filter is undone; ``exact`` where
    no applied filter left to undo changes a chunk's size, so that this
    one's output must be ``want`` bytes."""
    fid, cd = flt.id, flt.cd
    if fid == DEFLATE:
        try:
            return zlib.decompress(buf)
        except zlib.error as e:
            raise OSError(f"corrupt deflate chunk: {e}") from None
    if fid == SHUFFLE:
        return unshuffle(buf, cd[0] if cd else esize)
    if fid == FLETCHER32:
        return unfletcher32(buf)
    if fid == LZF:
        return unlzf(buf, cd[2] if len(cd) > 2 and cd[2] else want)
    if fid == SZIP:
        return unszip(buf, cd, want if exact else None)
    if fid == SCALEOFFSET:
        return unscaleoffset(buf, cd)
    if fid == NBIT:
        if len(cd) > 1 and cd[1]:   # stored at full precision, as it was
            return buf
        raise NotImplementedError(
            "filter nbit (id 5): packed nbit chunks (only chunks at the "
            "type's full precision)")
    raise NotImplementedError(
        f"filter {flt.label} (id {fid}): a chunk was filtered by it "
        "(only shuffle, deflate, fletcher32, lzf, szip, scaleoffset and "
        "unpacked nbit are undone)")
