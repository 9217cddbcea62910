r"""
:mod:`stream._daycache` -- decoded SDS day files, once per process
==================================================================

The host engine fetches a pair-day's windows in parallel threads, and each
window reads the two or three day files it spans, so one day file is asked
for several times at once and again by the next window. :class:`DayCache`
decodes each file once: process-wide, thread-safe, single-flight (a thread
that asks for a file another thread is decoding waits for that decode),
bounded by :data:`MAX_BYTES` of decoded samples with the least recently
used file evicted first.

A file is known by ``(realpath, st_ino, st_size, st_mtime_ns)``, taken when
it is asked for: a file rewritten in place (another inode, size or time)
is decoded again. :meth:`DayCache.invalidate` drops a path outright, for a
writer of this process whose rewrite the stat might not tell apart.

Every read hands out copies (:meth:`Trace.copy`): the chain's steps write
their Traces, and a cached array must never change under a later reader.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import Future

__all__ = ["DayCache", "DAYS", "MAX_BYTES"]

#: decoded samples the process keeps: 24 day files at 250 Hz in int32
#: (86.4 MB each), more than a pair-day's windows span
MAX_BYTES = 2 << 30


def _nbytes(traces):
    return sum(tr.data.nbytes for tr in traces)


class DayCache:
    """Decoded day files by path and stat; see the module."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = OrderedDict()   # key -> (traces, nbytes)
        self._flights = {}           # key -> Future of the decode
        self._bytes = 0

    def read(self, path, decode):
        """The Traces of ``path``, ``decode(path)`` run at most once while
        the file is unchanged and cached; every caller gets its own
        copies."""
        st = os.stat(path)
        key = (os.path.realpath(path), st.st_ino, st.st_size,
               st.st_mtime_ns)
        with self._lock:
            done = self._done.get(key)
            if done is not None:
                self._done.move_to_end(key)
                return [tr.copy() for tr in done[0]]
            flight = self._flights.get(key)
            owner = flight is None
            if owner:
                flight = self._flights[key] = Future()
        if not owner:
            return [tr.copy() for tr in flight.result()]
        try:
            traces = decode(path)
        except BaseException as error:
            with self._lock:
                if self._flights.get(key) is flight:
                    del self._flights[key]
            flight.set_exception(error)
            raise
        with self._lock:
            # a path invalidated meanwhile keeps its flight out
            if self._flights.get(key) is flight:
                del self._flights[key]
                self._keep(key, traces)
        flight.set_result(traces)
        return [tr.copy() for tr in traces]

    def _keep(self, key, traces):
        nbytes = _nbytes(traces)
        if nbytes > MAX_BYTES:
            return
        self._done[key] = (traces, nbytes)
        self._bytes += nbytes
        while self._bytes > MAX_BYTES:
            _, (_, evicted) = self._done.popitem(last=False)
            self._bytes -= evicted

    def invalidate(self, path):
        """Forget every decode of ``path``, done or under way."""
        real = os.path.realpath(path)
        with self._lock:
            for key in [k for k in self._done if k[0] == real]:
                self._bytes -= self._done.pop(key)[1]
            for key in [k for k in self._flights if k[0] == real]:
                del self._flights[key]

    def clear(self):
        """Forget every decode."""
        with self._lock:
            self._done.clear()
            self._flights.clear()
            self._bytes = 0

    @property
    def nbytes(self):
        """Bytes of decoded samples kept."""
        return self._bytes


#: the process's day files
DAYS = DayCache()
