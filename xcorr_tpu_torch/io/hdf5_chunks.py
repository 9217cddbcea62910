r"""
:mod:`io.hdf5_chunks` -- a chunked dataset read into one array
==============================================================

:class:`Chunks` holds a chunked dataset's written chunks (their stored
bytes read from the file as they are needed) and reads a box of the
dataset, the whole of it or the box of a basic selection
(:func:`basic_box`), into one array of the stored dtype:

- the array is allocated once, and the fill value is written only where
  no written chunk covers the box (over the whole box, before the
  chunks, where more than :data:`FEW_MISSING` chunks are unwritten);
- a chunk whose applied filters are shuffle then deflate (with or
  without fletcher32 over the stored bytes) is inflated, by a selection,
  only up to the last byte the box needs of its last byte plane (by the
  whole read, whole), and only the box's columns of each plane are
  unshuffled, straight into the array (:func:`hdf5_filters.inflate`,
  :func:`hdf5_filters.unshuffle_into`);
- any other chain is undone on the whole chunk, each filter only where
  the chunk's mask says it was applied (:func:`hdf5_filters.unfilter`),
  and the box's part is unshuffled or copied into place.

A shuffled float32 chunk keeps byte ``k`` of its elements in plane
``k``, so a box still inflates at least three quarters of each chunk it
meets. A partial inflate reads no byte past what the box needs, so a
stream damaged only past them reads as the bytes before the damage; the
whole read inflates every chunk to its end and checks it, so it refuses
every chunk that the plain read (and h5py) refuses.

Chunks decode on the process's read pool (:data:`THREADS` threads, made
on first use, anew in a process of another pid) where the box meets
more than one chunk and at least :data:`PARALLEL_MIN` stored bytes (on
8 threads, the card's host inflates a shard's 8 chunks 6x faster than
serially: ``PERF.md``); a task decodes one chunk and submits nothing,
and a read made on a thread of the pool decodes on that thread, so no
task of the pool waits on the pool. :data:`COUNTS` counts chunks and
bytes (:func:`counts`, :func:`reset_counts`).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from itertools import product

import numpy as np

from . import hdf5_filters as hf

__all__ = ["Chunks", "basic_box", "counts", "reset_counts", "THREADS",
           "PARALLEL_MIN"]

#: the read pool's threads; 1 decodes every chunk on the calling thread
THREADS = 8
#: a read decodes on the pool from this many stored bytes
PARALLEL_MIN = 4 << 20
#: unwritten chunks a read fills one by one; more, and it fills the
#: whole box before the written chunks go in
FEW_MISSING = 8

_POOL, _POOL_PID = None, None
_POOL_LOCK = threading.Lock()

_COUNTS_LOCK = threading.Lock()
#: chunks decoded, their stored bytes, the bytes their filters produced,
#: and the bytes written into the arrays read
COUNTS = {"chunks": 0, "stored": 0, "inflated": 0, "written": 0}


def counts():
    """A copy of :data:`COUNTS`."""
    with _COUNTS_LOCK:
        return dict(COUNTS)


def reset_counts():
    with _COUNTS_LOCK:
        for k in COUNTS:
            COUNTS[k] = 0


def _count(stored, inflated, written):
    with _COUNTS_LOCK:
        COUNTS["chunks"] += 1
        COUNTS["stored"] += stored
        COUNTS["inflated"] += inflated
        COUNTS["written"] += written


def _read_pool():
    """The process's read pool, made on first use (anew in a forked
    child, which has none of its parent's threads)."""
    global _POOL, _POOL_PID
    with _POOL_LOCK:
        if _POOL is None or _POOL_PID != os.getpid():
            _POOL = ThreadPoolExecutor(max_workers=THREADS,
                                       thread_name_prefix="xcorr-h5read")
            _POOL_PID = os.getpid()
        return _POOL


def basic_box(key, shape):
    """The box of h5py's basic selection ``key`` on ``shape``: ``((start,
    stop) per axis, pick)``, where ``pick`` indexes the box's array to
    the selection's (0 on an axis an int drops, ``slice(None)``
    elsewhere). Ints and step-1 slices, with one ``Ellipsis``, under
    Python's rules for negative and ``None`` bounds; any other key
    raises :class:`NotImplementedError` naming it."""
    keys = key if isinstance(key, tuple) else (key,)
    refuse = NotImplementedError(
        f"the codec reads ints and step-1 slices, not {key!r}")
    ellipses = sum(k is Ellipsis for k in keys)
    if ellipses > 1:
        raise refuse
    if ellipses:
        i = next(j for j, k in enumerate(keys) if k is Ellipsis)
        fill = len(shape) - (len(keys) - 1)
        if fill < 0:
            raise ValueError(f"{len(keys) - 1} indices for "
                             f"{len(shape)} dimensions")
        keys = keys[:i] + (slice(None),) * fill + keys[i + 1:]
    if len(keys) > len(shape):
        raise ValueError(f"{len(keys)} indices for {len(shape)} dimensions")
    keys = keys + (slice(None),) * (len(shape) - len(keys))
    box, pick = [], []
    for k, n in zip(keys, shape):
        if isinstance(k, slice):
            if k.step not in (None, 1):
                raise refuse
            a, b, _ = k.indices(n)
            box.append((a, max(a, b)))
            pick.append(slice(None))
        elif isinstance(k, (int, np.integer)) and not isinstance(
                k, (bool, np.bool_)):
            i = int(k) + n if k < 0 else int(k)
            if not 0 <= i < n:
                raise IndexError(f"index {int(k)} out of range for "
                                 f"(0-{n - 1})")
            box.append((i, i + 1))
            pick.append(0)
        else:
            raise refuse
    return tuple(box), tuple(pick)


class Chunks:
    """A chunked dataset's written chunks: ``shape``, the stored
    ``dtype``, the ``chunk`` shape, the pipeline's ``filters``, the fill
    value's bytes (or ``None``: zeros) and ``found``, ``(stored bytes,
    filter mask, offsets, address)`` per chunk; ``fetch(address,
    nbytes)`` reads a chunk's stored bytes. A chunk listed twice counts
    as its last entry; one outside the dataset is never read."""

    def __init__(self, shape, dtype, chunk, filters, fill, found, fetch):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)
        self.chunk, self.filters = tuple(chunk), list(filters)
        self.fill, self._fetch = fill, fetch
        last = {}
        for item in found:
            if all(o < s for o, s in zip(item[2], self.shape)):
                last[tuple(item[2])] = item
        self.items = list(last.values())

    @property
    def stored(self):
        """The stored bytes of the written chunks."""
        return sum(item[0] for item in self.items)

    def read(self, box=None):
        """The dataset's elements in ``box`` (``(start, stop)`` per axis;
        the whole dataset by default) as one array of the stored dtype,
        C-ordered. The whole read inflates each chunk whole."""
        whole = box is None
        if whole:
            box = tuple((0, s) for s in self.shape)
        out = np.empty(tuple(b - a for a, b in box), self.dtype)
        if not out.size:
            return out
        work, seen = [], set()
        for item in self.items:
            offs = item[2]
            lo = tuple(max(a, o) for (a, _), o in zip(box, offs))
            hi = tuple(min(b, o + c) for (_, b), o, c in
                       zip(box, offs, self.chunk))
            if all(a < b for a, b in zip(lo, hi)):
                work.append((item, lo, hi))
                seen.add(tuple(offs))
        self._fill_missing(out, box, seen)
        stored = sum(item[0] for item, _, _ in work)
        if THREADS > 1 and len(work) > 1 and stored >= PARALLEL_MIN \
                and not threading.current_thread().name.startswith(
                    "xcorr-h5read"):
            pool = _read_pool()
            futures = [pool.submit(self._decode, w, out, box, whole)
                       for w in work]
            try:
                for f in futures:
                    f.result()
            finally:
                for f in futures:
                    f.cancel()
                wait(futures)
        else:
            for w in work:
                self._decode(w, out, box, whole)
        return out

    def _fill_missing(self, out, box, seen):
        """The fill value where no written chunk meets ``box``: cell by
        cell where a few are missing, else over the whole box first."""
        grid = [range(a - a % c, b, c) for (a, b), c in zip(box, self.chunk)]
        missing = int(np.prod([len(g) for g in grid])) - len(seen)
        if not missing:
            return
        esize = self.dtype.itemsize
        fill = self.fill if self.fill and len(self.fill) == esize \
            else bytes(esize)
        value = np.frombuffer(fill, self.dtype, 1).reshape(
            (1,) * out.ndim)
        if missing > FEW_MISSING:
            np.copyto(out, value)
            return
        for offs in product(*grid):
            if offs not in seen:
                np.copyto(out[tuple(
                    slice(max(a, o) - a, min(b, o + c) - a)
                    for (a, b), o, c in zip(box, offs, self.chunk))], value)

    def _decode(self, work, out, box, whole):
        """One chunk's part of ``box`` undone into ``out`` (the chunk
        inflated whole where ``whole``)."""
        (nbytes, mask, offs, addr), lo, hi = work
        filters, esize = self.filters, self.dtype.itemsize
        n = int(np.prod(self.chunk))
        want = n * esize
        sel = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, offs))
        dst = out[tuple(slice(a - s, b - s)
                        for a, b, (s, _) in zip(lo, hi, box))]
        applied = [j for j in range(len(filters)) if not mask & (1 << j)]
        shuffled = bool(applied) and filters[applied[0]].id == hf.SHUFFLE \
            and esize > 1 and (filters[applied[0]].cd or (esize,))[0] == esize
        rest = applied[1:] if shuffled else applied
        ids = [filters[j].id for j in rest]
        buf, need = self._fetch(addr, nbytes), want
        if shuffled and ids in ([hf.DEFLATE], [hf.DEFLATE, hf.FLETCHER32]):
            if len(ids) == 2:
                buf = hf.unfletcher32(buf)
            if not whole:
                # up to the last byte of the last plane that the box needs
                last, stride = 0, 1
                for s, c in zip(reversed(sel), reversed(self.chunk)):
                    last += (s.stop - 1) * stride
                    stride *= c
                need = (esize - 1) * n + last + 1
            buf = hf.inflate(buf, want, need)
        else:
            for j in reversed(rest):
                exact = all(mask & (1 << i) or filters[i].id
                            in hf.SAME_SIZE for i in range(j))
                buf = hf.unfilter(filters[j], buf, want, esize, exact)
        if len(buf) != need:
            raise OSError(f"chunk at {offs} holds {len(buf)} bytes, "
                          f"not {want}")
        if shuffled:
            hf.unshuffle_into(buf, self.chunk, sel, dst)
        else:
            dst[...] = np.frombuffer(buf, self.dtype, n).reshape(
                self.chunk)[sel]
        _count(nbytes, len(buf), dst.nbytes)
