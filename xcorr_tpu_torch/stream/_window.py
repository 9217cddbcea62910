r"""
:mod:`stream._window` -- one window of an SDS archive, its span alone
=====================================================================

:meth:`Client._get_sds_waveforms` asks each archive for the exact window
of a receiver: 24 h plus two buffers at the production geometry, which
touch two or three day files. The carried read (:func:`_read_window_plain`)
copies every day file it touches out of the day-file cache, merges them
over their whole union (``Stream.merge(method=1,
fill_value="interpolate")``, float64 for integer samples) and only then
trims to the window. :func:`read_window` gives the same Traces, bit for
bit: it takes the cache's read-only arrays without a copy
(:meth:`._daycache.DayCache.views`) and :func:`merge_window` allocates and
fills only the window's span of each id, each sample written once (no
zeroing pass first). The window's arrays are the fetch's own
(:func:`._steps.window_array`): the chain's first steps may work in
them, and inside a chain they are the buffer that the fetch thread keeps
for its windows where it fits.
"""

from __future__ import annotations

from glob import glob

import numpy as np

from ..util.time import get_dates
from . import _daycache, _steps, sds
from .trace import Stream, Trace, UTCDateTime

__all__ = ["read_window", "merge_window", "day_views"]


def day_views(archive, seed_id, time):
    """The Traces of the day files covering ``time`` for ``seed_id``, as
    ``archive.read`` finds them (wildcards, the day files' shared locks),
    their samples the day-file cache's read-only arrays."""
    net, sta, loc, cha = seed_id.split(".")
    pattern = archive.path(net, sta, loc, cha, time)
    traces = []
    for path in sorted(glob(pattern)):
        with sds._day_lock(path, exclusive=False):
            traces.extend(_daycache.DAYS.views(path, sds._decode_dayfile))
    return traces


def read_window(archive, receiver, start, end):
    """``receiver``'s Traces in ``archive`` over ``[start, end]``: what
    :func:`_read_window_plain` returns, without copying a day file."""
    traces = []
    for day in get_dates(start, end):
        traces.extend(day_views(archive, receiver, day))
    return merge_window(traces, start, end)


def _read_window_plain(archive, receiver, start, end):
    """The carried read of one archive in ``Client._get_sds_waveforms``:
    the plain version of :func:`read_window`."""
    traces = []
    for day in get_dates(start, end):
        st = archive.read(receiver, day)
        traces.extend(st.traces)
    if not traces:
        return Stream()
    st = Stream(traces).merge(method=1, fill_value="interpolate")
    st.trim(start, end)
    return st


def merge_window(traces, start, end):
    """``Stream(traces).merge(method=1, fill_value="interpolate")
    .trim(start, end)``, bit for bit, allocating only the trimmed span of
    each id. The carried rules (``Stream.merge``, ``Trace.trim``):

    - traces group by ``(id, sampling_rate)``, each group sorted stably by
      start; a group spans its first start to its latest end on the first
      trace's grid, each trace at ``round((start - t0) * fs)``, a later
      trace overwriting an earlier one where they overlap;
    - the samples are ``np.result_type`` of the group's, float64 for
      integer samples;
    - a gap takes ``np.interp`` between the samples on either side of it,
      outside the window where the gap crosses its edge (``np.interp``
      evaluates each index on its own, so the window's indices alone give
      the same bits);
    - the window's ends round to the nearest sample and clip to the data,
      and the window is the union's slice between them (an end before the
      union counts from its end, as a Python slice does);
    - the Traces come out in ``Stream.sort``'s order, their Stats copies
      of each group's first trace's.

    The input arrays are only read: they may be read-only views."""
    start, end = UTCDateTime(start), UTCDateTime(end)
    by_id = {}
    for t in traces:
        by_id.setdefault((t.id, t.stats.sampling_rate), []).append(t)
    out = []
    for (_, fs), group in by_id.items():
        group.sort(key=lambda t: t.stats.starttime.ns)
        t0 = group[0].stats.starttime
        t1 = max(t.stats.endtime for t in group)
        npts = int(round((t1 - t0) * fs)) + 1
        dtype = np.result_type(*(t.data.dtype for t in group))
        if not np.issubdtype(dtype, np.floating):
            dtype = np.dtype(np.float64)
        spans, gaps, cov_end = [], [], 0
        for t in group:
            i0 = int(round((t.stats.starttime - t0) * fs))
            if i0 + t.stats.npts > npts:
                # where the carried merge's slice assignment fails
                raise ValueError(
                    f"could not broadcast input array from shape "
                    f"({t.stats.npts},) into shape "
                    f"({max(npts - i0, 0)},)")
            if i0 > cov_end:
                gaps.append((cov_end, i0))
            cov_end = max(cov_end, i0 + t.stats.npts)
            spans.append(i0)
        k0 = max(int(round((start - t0) * fs)), 0)
        # the union's slice [k0:k1], a negative k1 counting from its end
        w0, w1, _ = slice(k0, min(int(round((end - t0) * fs)) + 1,
                                  npts)).indices(npts)
        # every sample is written below, by a trace, a gap or the zeros
        # of what neither covers: no zeroing pass before the fill, so a
        # buffer the chain reuses serves as well as a fresh array
        data = _steps.window_array(max(w1 - w0, 0), dtype)
        for i0, t in zip(spans, group):
            a, b = max(i0, w0), min(i0 + t.stats.npts, w1)
            if a < b:
                data[a - w0:b - w0] = t.data[a - i0:b - i0]
        covered = sorted([(i0, i0 + t.stats.npts)
                          for i0, t in zip(spans, group)] + gaps)
        k = w0
        for a, b in covered + [(w1, w1)]:
            if k < min(a, w1):
                data[k - w0:min(a, w1) - w0] = 0
            k = max(k, b)

        def sample(i):
            """Sample ``i`` of the carried merge's union, last writer
            first."""
            for i0, t in zip(reversed(spans), reversed(group)):
                if i0 <= i < i0 + t.stats.npts:
                    return float(dtype.type(t.data[i - i0]))

        for g0, g1 in gaps:
            a, b = max(g0, w0), min(g1, w1)
            if a < b:
                data[a - w0:b - w0] = np.interp(
                    np.arange(a, b), [g0 - 1, g1],
                    [sample(g0 - 1), sample(g1)])
        stats = group[0].stats.copy()
        stats.starttime = t0 + k0 / fs
        out.append(Trace(data, stats))
    return Stream(out).sort()
