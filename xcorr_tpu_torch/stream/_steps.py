r"""
:mod:`stream._steps` -- the host chain's steps without the copies they drop
==========================================================================

The carried steps of ``stream/trace.py`` copy before they compute and
allocate the result anew: ``detrend`` casts a float64 window to float64
(a copy) and then allocates ``x - x.mean()``; ``filter`` and ``decimate``
cast before ``sosfilt``, which copies its input again; ``decimate``'s
``[::factor]`` keeps the filtered parent alive behind a strided view; the
chain's ``merge`` copies a window that the fetch has already merged;
``remove_sensitivity`` allocates its quotient. At 250 Hz every such copy
is 190 MB, and under the campaign's 8 fetch threads a new array costs
more than its copy: its pages come fresh from the kernel. The forms here
give the same bits (IEEE elementwise operations round alike in place or
not; ``sosfilt``'s loop runs over the chain's array instead of over the
copy it would make) without those copies.

A step works in place only on an array that the chain itself allocated:
the window merge's output (:func:`._window.merge_window`) or an earlier
step's, while :func:`chain` is open, that is inside
``Client.get_processed_waveforms`` (the fetch and its chain, in one
thread). :func:`own` records such an array and :func:`owns` asks for it.
A caller's array, a read-only view of the day-file cache, or any array
outside a chain is never written: called on their own, the steps return
new arrays, as the carried steps do.

Two forms go further than the carried expressions. :func:`sosfilt` on
the chain's own float64 window runs the native library's loop over it
(:func:`._sosfilt.sosfilt_inplace`), scipy's loop as a wavefront over
the sections, bit for bit. :func:`window_array`, the window merge's
output, is inside a chain the buffer that the calling thread keeps for
its windows where that fits the window exactly: a window's array is dead
once ``decimate`` has copied out every fifth sample, and a fresh 190 MB
array costs the first touch of its pages under the fetch threads. The
buffer goes back to the thread when the chain's scope closes only if
nothing else holds it (:func:`chain`), so no output, no view of the
day-file cache and no caller's array ever shares memory with a buffer
that is handed out again.

Each form has its plain version, ``_<name>_plain``: the carried
expression, or for :func:`sosfilt_inplace` and :func:`window_array` the
form before them (scipy's loop over the window, a fresh array);
:data:`FORMS` names the forms, so that a caller can put the plain
versions in their place (``chip_smoke.plain_host_path``).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import weakref

import numpy as np
import scipy.signal as sp_signal

from ._sosfilt import sosfilt_inplace

try:  # the loop ``sosfilt`` runs over the copy it makes of its input
    from scipy.signal._sosfilt import _sosfilt as _scipy_loop
except ImportError:
    _scipy_loop = None

__all__ = ["chain", "chained", "own", "owns", "window_array", "FORMS"]

_local = threading.local()


def _refcounts(arrays):
    """Each array of the list ``arrays``, which this empties, with its
    reference count as this function reads it: where nothing but this
    function's own name holds the array, the count :data:`_ALONE` is."""
    out = []
    while arrays:
        a = arrays.pop()
        out.append((a, sys.getrefcount(a)))
    return out


def _probe():
    """The count :func:`_refcounts` gives an array that nothing else
    reaches, or None where it gives an array that a view also holds no
    more than that. The count is the interpreter's own (a version may
    borrow a name's reference for a call), so it is measured, not
    assumed; where it cannot tell the two apart, no buffer is reused."""
    arrays = [np.empty(1), np.empty(1)]
    view = arrays[0][:]
    (_, alone), (_, viewed) = _refcounts(arrays)
    del view
    return alone if viewed > alone else None


#: what :func:`_refcounts` reads for an array nothing else reaches, or
#: None: then no buffer goes back to a thread
_ALONE = _probe()


@contextlib.contextmanager
def chain():
    """The scope of one fetch and its chain in this thread: the arrays
    :func:`own` records in it are the chain's own. When it closes, the
    largest of the buffers that :func:`window_array` handed out in it and
    that nothing else reaches any more becomes this thread's buffer, if
    it is larger than the one the thread keeps."""
    outer = getattr(_local, "owned", None), getattr(_local, "taken", None)
    _local.owned, _local.taken = weakref.WeakValueDictionary(), []
    try:
        yield
    finally:
        taken = _local.taken
        _local.owned, _local.taken = outer
        _give_back(taken)


def _give_back(taken):
    """Keep as this thread's buffer the largest array of ``taken``
    (emptied) that nothing else reaches: numpy points every view, and
    the buffer protocol every export, at the array that owns the memory,
    so an array referenced from nowhere but here has no view and no
    export left."""
    if _ALONE is None:
        return
    for buf, refs in _refcounts(taken):
        keep = getattr(_local, "buf", None)
        if refs == _ALONE and (keep is None or buf.nbytes > keep.nbytes):
            _local.buf = buf


def chained(method):
    """``method`` run inside :func:`chain`."""
    @functools.wraps(method)
    def run(*args, **kwargs):
        with chain():
            return method(*args, **kwargs)
    return run


def own(x):
    """Record ``x``, just allocated by the chain, as the chain's own;
    returns ``x``. Outside a chain it records nothing."""
    owned = getattr(_local, "owned", None)
    if owned is not None:
        owned[id(x)] = x
    return x


def owns(x):
    """Whether the open chain allocated ``x`` (this very array, not a view
    of it) and may write it."""
    owned = getattr(_local, "owned", None)
    return (owned is not None and owned.get(id(x)) is x
            and x.flags.writeable)


def _in_place(x):
    """Whether a float64 step may write its result over ``x``."""
    return x.dtype == np.float64 and owns(x)


def as_float64(x):
    """``x.astype(np.float64)`` without the copy of a float64 ``x``: ``x``
    itself, which the callers only read or write where :func:`owns`
    allows."""
    return x if x.dtype == np.float64 else own(x.astype(np.float64))


def demean(x):
    """``x - x.mean()`` of a float64 ``x``, over ``x`` where it is the
    chain's own."""
    if _in_place(x):
        return np.subtract(x, x.mean(), out=x)
    return own(x - x.mean())


def divide(x, s):
    """``x / s``, over ``x`` where it is the chain's own float64."""
    if _in_place(x):
        return np.divide(x, s, out=x)
    return own(x / s)


def sosfilt(sos, x):
    """``sp_signal.sosfilt(sos, x.astype(np.float64))``: ``sosfilt``
    copies its input itself, so a float64 ``x`` goes in as it is; where
    the chain owns a non-empty ``x``, scipy's loop runs over ``x`` instead
    of a copy, in the native library (:func:`sosfilt_inplace`). An empty
    ``x`` takes scipy's path, which may raise on it."""
    sos = np.asarray(sos)
    if (_in_place(x) and x.ndim == 1 and x.size > 0
            and x.flags.c_contiguous and sos.dtype == np.float64
            and sos.ndim == 2 and sos.shape[0] > 0 and sos.shape[1] == 6
            and bool(np.all(sos[:, 3] == 1))):
        return sosfilt_inplace(sos, x)
    return own(sp_signal.sosfilt(sos, as_float64(x)))


def sosfiltfilt(sos, x):
    """``sp_signal.sosfiltfilt(sos, x.astype(np.float64))``, without the
    cast of a float64 ``x`` (the filter only reads it)."""
    return own(sp_signal.sosfiltfilt(sos, as_float64(x)))


def every(x, factor):
    """``x[::factor]``; a contiguous copy where ``x`` is the chain's own,
    so that ``x`` is freed instead of kept alive behind a strided view."""
    if owns(x):
        return own(x[::factor].copy())
    return x[::factor]


def window_array(npts, dtype):
    """``np.empty(npts, dtype)`` for the window merge to fill, recorded
    by :func:`own`. Inside a chain it is the buffer this thread keeps,
    where that has exactly ``npts`` samples of ``dtype``; the chain hands
    it back when it closes (:func:`chain`). The buffer lives as long as
    its thread."""
    taken = getattr(_local, "taken", None)
    if taken is None:
        return np.empty(npts, dtype=dtype)
    buf = getattr(_local, "buf", None)
    if buf is not None and buf.shape == (npts,) and buf.dtype == dtype:
        _local.buf = None
    else:
        buf = np.empty(npts, dtype=dtype)
    taken.append(buf)
    return own(buf)


def merged(traces, spans, npts, dtype):
    """``Stream.merge``'s buffer of one id: ``traces`` written at ``spans``
    into ``np.zeros(npts, dtype)``, later traces over earlier ones. A
    group of one trace that fills the buffer exactly, in ``dtype``, is
    that trace's array where the chain owns it (the window merge's
    output): the copy would be the same bits."""
    if len(traces) == 1 and spans[0] == 0:
        x = traces[0].data
        if x.size == npts and x.dtype == dtype and owns(x):
            return x
    return own(_merged_plain(traces, spans, npts, dtype))


def _as_float64_plain(x):
    return x.astype(np.float64)


def _demean_plain(x):
    return x - x.mean()


def _divide_plain(x, s):
    return x / s


def _sosfilt_plain(sos, x):
    return sp_signal.sosfilt(sos, x.astype(np.float64))


def _sosfilt_inplace_plain(sos, x):
    if _scipy_loop is None:
        x[...] = sp_signal.sosfilt(sos, x)
    else:
        _scipy_loop(np.ascontiguousarray(sos), x.reshape(1, -1),
                    np.zeros((1, sos.shape[0], 2)))
    return x


def _window_array_plain(npts, dtype):
    return own(np.empty(npts, dtype=dtype))


def _sosfiltfilt_plain(sos, x):
    return sp_signal.sosfiltfilt(sos, x.astype(np.float64))


def _every_plain(x, factor):
    return x[::factor]


def _merged_plain(traces, spans, npts, dtype):
    data = np.zeros(npts, dtype=dtype)
    for i0, t in zip(spans, traces):
        data[i0:i0 + t.stats.npts] = t.data
    return data


#: the forms that the host chain calls (``stream/trace.py``,
#: :func:`._window.merge_window` and :func:`sosfilt`), each with its plain
#: version ``_<name>_plain``
FORMS = ("as_float64", "demean", "divide", "sosfilt", "sosfilt_inplace",
         "sosfiltfilt", "every", "merged", "window_array")
