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

Three forms go further than the carried expressions. :func:`sosfilt` on
the chain's own float64 window runs the native library's loop over it
(:func:`._sosfilt.sosfilt_inplace`), scipy's loop as a wavefront over
the sections, bit for bit. :func:`window_array`, the window merge's
output, and the inverse transform of :func:`deconvolve`
(``remove_response``'s division) are inside a chain arrays that the
calling thread keeps (:func:`buffer`): a window's array is dead once
``decimate`` has copied out every fifth sample or ``remove_response``
has transformed it, the division's output once ``interpolate`` has read
it, and a fresh array of 30-190 MB costs the first touch of its pages
under the fetch threads. A thread keeps at most one array per key, the
key being the shape, the dtype and the array's rank among those of that
shape and dtype that the chain holds at once (the BHR chain's BH1, BH2
and BHZ windows are three), and at most :data:`KEEP_BYTES` in all. An
array goes back to the thread when the chain's scope closes only if
nothing else holds it (:func:`chain`), so no output, no view of the
day-file cache and no caller's array ever shares memory with an array
that is handed out again. :func:`deconvolve`'s spectrum is a scratch
array of the thread (:func:`scratch`), which nothing outside the form
ever sees.

Each form has its plain version, ``_<name>_plain``: the carried
expression, or for :func:`sosfilt_inplace` and :func:`window_array` the
form before them (scipy's loop over the window, a fresh array);
:data:`FORMS` names the forms, so that a caller can put the plain
versions in their place (``chip_smoke.plain_host_path``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
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

__all__ = ["chain", "chained", "own", "owns", "buffer", "scratch",
           "window_array", "deconvolve", "FORMS", "KEEP_BYTES"]

_local = threading.local()

#: the most bytes of arrays that a thread keeps between its chains; past
#: it the array least recently kept goes first. A production fetch thread
#: keeps about 470 MB: a 250 Hz window of 23,760,001 float64 samples
#: (190.1 MB) and, for the BHR chain, three 40 Hz windows of 3,801,601
#: (30.4 MB each) and ``remove_response``'s two outputs and its spectrum
#: at nfft = 7,864,320 (62.9 MB each)
KEEP_BYTES = 512 << 20

#: whether ``np.fft.rfft`` and ``np.fft.irfft`` take ``out=`` (numpy 2.0
#: on); without it :func:`deconvolve` is its plain version
_FFT_OUT = all("out" in inspect.signature(f).parameters
               for f in (np.fft.rfft, np.fft.irfft))


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
    :func:`own` records in it are the chain's own. When it closes, each
    array that :func:`buffer` handed out in it and that nothing else
    reaches any more is kept by this thread for its key."""
    outer = (getattr(_local, "owned", None), getattr(_local, "taken", None),
             getattr(_local, "keys", None))
    _local.owned, _local.taken, _local.keys = \
        weakref.WeakValueDictionary(), [], []
    try:
        yield
    finally:
        taken, keys = _local.taken, _local.keys
        _local.owned, _local.taken, _local.keys = outer
        _give_back(taken, keys)


def _kept():
    """This thread's kept arrays by key, the least recently kept first."""
    kept = getattr(_local, "kept", None)
    if kept is None:
        kept = _local.kept = collections.OrderedDict()
    return kept


def _keep(key, buf):
    """Keep ``buf`` as this thread's array of ``key``, then drop the
    arrays least recently kept while the thread keeps more than
    :data:`KEEP_BYTES`; an array larger than that is not kept, and none
    where :data:`_ALONE` is None."""
    if _ALONE is None or buf.nbytes > KEEP_BYTES:
        return
    kept = _kept()
    kept.pop(key, None)
    kept[key] = buf
    total = sum(a.nbytes for a in kept.values())
    while total > KEEP_BYTES:
        total -= kept.popitem(last=False)[1].nbytes


def _give_back(taken, keys):
    """Keep each array of ``taken`` (emptied), handed out for the key of
    the same place in ``keys``, that nothing else reaches: numpy points
    every view, and the buffer protocol every export, at the array that
    owns the memory, so an array referenced from nowhere but here has no
    view and no export left."""
    for key, (buf, refs) in zip(keys[::-1], _refcounts(taken)):
        if refs == _ALONE:
            _keep(key, buf)


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


def buffer(shape, dtype):
    """``np.empty(shape, dtype)``, recorded by :func:`own`. Inside a chain
    it is the array this thread keeps for its key (``shape``, ``dtype``
    and the number of arrays of that shape and dtype that the chain took
    before it), else a fresh one; the chain keeps it when it closes if
    nothing else reaches it then (:func:`chain`). Kept arrays live as
    long as their thread."""
    taken = getattr(_local, "taken", None)
    if taken is None:
        return np.empty(shape, dtype=dtype)
    shape, dtype = tuple(shape), np.dtype(dtype)
    keys = _local.keys
    key = (shape, dtype.str,
           sum(k[:2] == (shape, dtype.str) for k in keys))
    buf = _kept().pop(key, None)
    if buf is None:
        buf = np.empty(shape, dtype=dtype)
    taken.append(buf)
    keys.append(key)
    return own(buf)


@contextlib.contextmanager
def scratch(shape, dtype):
    """An array for a step's own use while the ``with`` block runs,
    handed to nothing that outlives it: inside a chain the one this
    thread keeps for ``shape`` and ``dtype``, kept again once the block
    is done (not where it raises: a traceback may hold it), else a fresh
    one."""
    if getattr(_local, "taken", None) is None:
        yield np.empty(shape, dtype=dtype)
        return
    key = (tuple(shape), np.dtype(dtype).str, "scratch")
    buf = _kept().pop(key, None)
    if buf is None:
        buf = np.empty(shape, dtype=dtype)
    yield buf
    _keep(key, buf)


def window_array(npts, dtype):
    """``np.empty(npts, dtype)`` for the window merge to fill, recorded
    by :func:`own`: inside a chain the array this thread keeps for a
    window of ``npts`` samples of ``dtype`` (:func:`buffer`)."""
    return buffer((npts,), dtype)


def deconvolve(x, n, nfft, inv_r, taper):
    """``remove_response``'s division: ``np.fft.irfft(spec * inv_r,
    nfft)[:n]`` of ``spec = np.fft.rfft(x.astype(np.float64), nfft)``,
    times ``taper`` first where it is not None. The cast only where ``x``
    is not float64 (``rfft`` reads its input), the spectrum in this
    thread's scratch (:func:`scratch`), both products in place on it, the
    inverse into a :func:`buffer` whose first ``n`` samples come out as
    the chain's own, so the steps after it may write them in place; the
    buffer goes back only once nothing reaches them. Without ``out=`` in
    ``np.fft`` (numpy before 2.0), and for an empty ``x``, which ``rfft``
    refuses, the carried expressions."""
    if not _FFT_OUT or x.ndim != 1 or x.size == 0:
        return _deconvolve_plain(x, n, nfft, inv_r, taper)
    x = as_float64(x)
    with scratch((nfft // 2 + 1,), np.complex128) as spec:
        np.fft.rfft(x, nfft, out=spec)
        if taper is not None:
            np.multiply(spec, taper, out=spec)
        np.multiply(spec, inv_r, out=spec)
        out = np.fft.irfft(spec, nfft, out=buffer((nfft,), np.float64))
    return own(out[:n])


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


def _deconvolve_plain(x, n, nfft, inv_r, taper):
    spec = np.fft.rfft(x.astype(np.float64), nfft)
    if taper is not None:
        spec *= taper
    return np.fft.irfft(spec * inv_r, nfft)[:n]


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
         "sosfiltfilt", "every", "merged", "window_array", "deconvolve")
