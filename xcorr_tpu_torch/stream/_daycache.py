r"""
:mod:`stream._daycache` -- decoded SDS day files, once per process
==================================================================

The host engine fetches a pair-day's windows in parallel threads, and each
window reads the two or three day files it spans, so one day file is asked
for several times at once and again by the next window. :class:`DayCache`
decodes each file once: process-wide, thread-safe, single-flight (a thread
that asks for a file another thread is decoding waits for that decode),
bounded by :data:`MAX_BYTES` of decoded samples with the least recently
used file evicted first (:class:`OnceCache`, which the host chain's
response cache, :mod:`._response`, shares).

A file is known by ``(realpath, st_ino, st_size, st_mtime_ns)``, taken when
it is asked for: a file rewritten in place (another inode, size or time)
is decoded again. :meth:`DayCache.invalidate` drops a path outright, for a
writer of this process whose rewrite the stat might not tell apart.

A decoded file's arrays are read-only: every reader shares them.
:meth:`DayCache.read` hands out copies (:meth:`Trace.copy`), which the
chain's steps may write; :meth:`DayCache.views` hands out the shared
arrays themselves, for a reader that copies only the span it needs
(:mod:`._window`), and a write into one raises.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import Future

from .trace import Trace

__all__ = ["OnceCache", "DayCache", "DAYS", "MAX_BYTES"]

#: decoded samples the process keeps: 24 day files at 250 Hz in int32
#: (86.4 MB each), more than a pair-day's windows span
MAX_BYTES = 2 << 30


class OnceCache:
    """Values by key, each computed at most once while it is kept:
    thread-safe, single-flight, bounded by :meth:`limit` bytes of the
    values' arrays (:meth:`arrays`) with the least recently used value
    evicted first. The arrays are made read-only before any caller sees
    them, since every caller shares them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = OrderedDict()   # key -> (value, nbytes)
        self._flights = {}           # key -> Future of the computation
        self._bytes = 0

    def limit(self):
        """Bytes the cache may keep."""
        raise NotImplementedError

    def arrays(self, value):
        """The numpy arrays of ``value``."""
        raise NotImplementedError

    def get(self, key, compute):
        """The value of ``key``, ``compute()`` run at most once while the
        key is cached; every caller gets the same read-only value."""
        with self._lock:
            done = self._done.get(key)
            if done is not None:
                self._done.move_to_end(key)
            else:
                flight = self._flights.get(key)
                owner = flight is None
                if owner:
                    flight = self._flights[key] = Future()
        if done is not None:
            self._served("hit")
            return done[0]
        if not owner:
            self._served("wait")
            return flight.result()
        try:
            value = compute()
            arrays = self.arrays(value)
            for a in arrays:
                a.flags.writeable = False
        except BaseException as error:
            with self._lock:
                if self._flights.get(key) is flight:
                    del self._flights[key]
            flight.set_exception(error)
            raise
        with self._lock:
            # a key dropped meanwhile keeps its flight out
            if self._flights.get(key) is flight:
                del self._flights[key]
                self._keep(key, value, sum(a.nbytes for a in arrays))
        flight.set_result(value)
        return value

    def _served(self, how):
        """Called by :meth:`get` where it does not compute: with ``"hit"``
        where the value was kept, ``"wait"`` where another caller's
        computation was under way."""

    def _keep(self, key, value, nbytes):
        limit = self.limit()
        if nbytes > limit:
            return
        self._done[key] = (value, nbytes)
        self._bytes += nbytes
        while self._bytes > limit:
            _, (_, evicted) = self._done.popitem(last=False)
            self._bytes -= evicted

    def drop(self, match):
        """Forget every value, done or under way, whose key ``match``
        accepts."""
        with self._lock:
            for key in [k for k in self._done if match(k)]:
                self._bytes -= self._done.pop(key)[1]
            for key in [k for k in self._flights if match(k)]:
                del self._flights[key]

    def clear(self):
        """Forget every value."""
        self.drop(lambda key: True)

    @property
    def nbytes(self):
        """Bytes of the arrays kept."""
        return self._bytes


class DayCache(OnceCache):
    """Decoded day files by path and stat; see the module."""

    def limit(self):
        return MAX_BYTES

    def arrays(self, traces):
        return [tr.data for tr in traces]

    def _traces(self, path, decode):
        st = os.stat(path)
        key = (os.path.realpath(path), st.st_ino, st.st_size,
               st.st_mtime_ns)
        return self.get(key, lambda: decode(path))

    def read(self, path, decode):
        """The Traces of ``path``, ``decode(path)`` run at most once while
        the file is unchanged and cached; every caller gets its own
        copies."""
        return [tr.copy() for tr in self._traces(path, decode)]

    def views(self, path, decode):
        """The Traces of ``path`` as :meth:`read` finds them, without a
        copy: their samples the cache's read-only arrays, their Stats the
        caller's own."""
        return [Trace(tr.data, tr.stats.copy())
                for tr in self._traces(path, decode)]

    def invalidate(self, path):
        """Forget every decode of ``path``, done or under way."""
        real = os.path.realpath(path)
        self.drop(lambda key: key[0] == real)


#: the process's day files
DAYS = DayCache()
