r"""
:mod:`stream._shared` -- a campaign's processed windows, once per receiver
=========================================================================

A receiver's processed window depends on the receiver, the window and the
chain's settings, not on the pair it is correlated in: in the production
campaign ``IM.H10N1..EDH`` is in four pairs, and the host engine's pair
fetch (``Client.get_pair_processed_waveforms``) runs its chain once for
each. :class:`WindowScope` is a campaign's scope of processed windows:
``lazy_process`` opens it around its host-engine fan-out with a plan,
for each (receiver, day), of the pair-days of this process that read it,
and runs the pair-days day by day, so the pairs of one day meet each
receiver's windows while they are kept.

Inside the scope :func:`pair_windows` takes each receiver's window from
the scope (:meth:`WindowScope.window`): a :class:`._daycache.OnceCache`,
so thread-safe and single-flight (a fetch that asks for a window another
fetch thread is processing waits for it; the leader is a fetch that runs,
so waiters on the fetch pool cannot hold it up). The key is the receiver
and the plan's day, the client and the inventory objects, the window's
time, and every other argument of ``get_processed_waveforms`` (the
channel's operations by their hash); where one cannot be hashed, or the
(receiver, day) has no pair-day left in the plan, or the client's pair
fetch is not ``Client``'s (the concatenation below would not be it), the
call goes to the client as outside a scope (``bypassed``). Both
receivers' streams, concatenated, are ``get_pair_processed_waveforms``'s
result trace for trace.

What is kept: a non-empty result, while the scope holds at most
:data:`CACHE_BYTES` (past it a window is not kept, and each consumer
computes its own, the same bits). An empty result (missing data, or the
sampling-rate or sample-count warning) is not kept, and a consumer that
waited for it runs the chain itself, so that it warns as it would alone;
a chain that raises is not kept, and its waiters raise what it raised.
Each consumer gets Traces of its own: the Stats copied, the samples a
read-only view of the kept array (a write into one raises, and
``_steps.owns`` is false for it).

The fetch threads' buffers (:mod:`._steps`): a chain gives an array back
to its thread when its scope closes only where nothing else reaches the
array then (``_steps._give_back``). A window this scope keeps, or a view
of it, is still held by the chain's result when the chain closes, so its
array is never given back, then or later: no array a thread keeps shares
memory with a window handed out here.

Each pair-day releases its (pair, day) when it ends (``lazy``'s task, in
a ``finally``); once a (receiver, day) has no pair-day left, its windows
are dropped. Closing the scope drops everything. :data:`COUNTS` holds,
over every scope of the process since :func:`reset_counts`: ``chains``
run through a scope, ``hits`` (a kept window served), ``waits`` (a
window served from another fetch's flight), ``bypassed`` calls,
``over_cap`` (windows not kept for :data:`CACHE_BYTES`), ``empty``
(results not kept for being empty) and ``peak_bytes`` held.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

from ..util.hasher import hash_obj
from ..util.receiver import split_pair
from ._daycache import OnceCache
from .client import Client
from .trace import Stream, Trace

__all__ = ["WindowScope", "pair_windows", "current", "CACHE_BYTES",
           "COUNTS", "reset_counts", "counts"]

#: the bytes of processed windows a scope keeps: a production day holds
#: 9 receivers x 8 windows of 4,320,000 float64 samples (34.6 MB), 2.5 GB
CACHE_BYTES = 4 << 30

#: the scopes' counts (see the module)
COUNTS = dict.fromkeys(("chains", "hits", "waits", "bypassed", "over_cap",
                        "empty", "peak_bytes"), 0)
_COUNT_LOCK = threading.Lock()

_local = threading.local()


def reset_counts():
    """Set every count of :data:`COUNTS` to 0."""
    with _COUNT_LOCK:
        for k in COUNTS:
            COUNTS[k] = 0


def counts():
    """A copy of :data:`COUNTS`."""
    with _COUNT_LOCK:
        return dict(COUNTS)


def _count(name, n=1):
    with _COUNT_LOCK:
        COUNTS[name] += n


def current():
    """The (scope, day) of the pair-day that this thread runs
    (:meth:`WindowScope.pair_day`), or None."""
    return getattr(_local, "pair_day", None)


class _Same:
    """An object in a key by its identity."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _receivers(pair):
    """The distinct receivers a pair's chains are keyed by."""
    return sorted(set(split_pair(pair)))


class WindowScope(OnceCache):
    """A campaign's processed windows (see the module). ``plan`` maps
    each (receiver, day) to the number of pair-days that read it; a
    ``with`` block closes the scope at its end."""

    def __init__(self, plan):
        super().__init__()
        self._plan = Counter(plan)

    @classmethod
    def of(cls, pair_days):
        """The scope planned for ``pair_days``, a list of (pair, day)."""
        return cls(Counter((r, day) for pair, day in pair_days
                           for r in _receivers(pair)))

    def limit(self):
        return CACHE_BYTES

    def arrays(self, st):
        return [tr.data for tr in st]

    def _served(self, how):
        _count(how + "s")

    def _keep(self, key, value, nbytes):
        if not len(value):
            _count("empty")
            return
        if self._bytes + nbytes > self.limit():
            _count("over_cap")
            return
        self._done[key] = (value, nbytes)
        self._bytes += nbytes
        with _COUNT_LOCK:
            COUNTS["peak_bytes"] = max(COUNTS["peak_bytes"], self._bytes)

    def planned(self):
        """The (receiver, day)s with pair-days left, and how many."""
        with self._lock:
            return {k: n for k, n in self._plan.items() if n > 0}

    def release(self, pair, day):
        """The pair-day (``pair``, ``day``) has ended: each of its
        receivers' windows of ``day`` are dropped once no pair-day is
        left that reads them."""
        gone = []
        with self._lock:
            for r in _receivers(pair):
                if self._plan[(r, day)] > 0:
                    self._plan[(r, day)] -= 1
                    if not self._plan[(r, day)]:
                        gone.append((r, day))
        for tag in gone:
            self.drop(lambda key, tag=tag: key[:2] == tag)

    def close(self):
        """Drop every window and the plan."""
        with self._lock:
            self._plan.clear()
        self.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @contextlib.contextmanager
    def pair_day(self, pair, day):
        """A context in which this thread runs the pair-day (``pair``,
        ``day``) of the plan (:func:`current`); the pair-day is released
        at its end, whatever the end."""
        outer = current()
        _local.pair_day = (self, day)
        try:
            yield self
        finally:
            _local.pair_day = outer
            self.release(pair, day)

    def _key(self, day, client, receiver, time, operations, kwargs):
        """The window's key, or None where none can be formed."""
        with self._lock:
            if self._plan.get((receiver, day), 0) <= 0:
                return None
        try:
            cha = receiver.split(".")[3]
            ops = hash_obj({cha: operations[cha]}) \
                if cha in operations else None
            key = (receiver, day, _Same(client), time, ops,
                   _Same(kwargs.pop("inventory", None)),
                   tuple(sorted(kwargs.items())))
            hash(key)
        except Exception:
            return None
        return key

    def window(self, day, client, receiver, time, operations, **kwargs):
        """``client.get_processed_waveforms(receiver, time, operations,
        **kwargs)`` from the scope (see the module)."""
        def run():
            _count("chains")
            return client.get_processed_waveforms(receiver, time,
                                                  operations, **kwargs)

        key = self._key(day, client, receiver, time, operations,
                        dict(kwargs))
        if key is None:
            _count("bypassed")
            return client.get_processed_waveforms(receiver, time,
                                                  operations, **kwargs)
        ran = []

        def lead():
            ran.append(True)
            return run()

        st = self.get(key, lead)
        if not len(st) and not ran:  # a flight that ended empty: as alone
            return run()
        return Stream([Trace(tr.data.view(), tr.stats.copy()) for tr in st])


def pair_windows(shared, client, pair, time, operations, **kwargs):
    """``client.get_pair_processed_waveforms(pair=pair, time=time,
    operations=operations, **kwargs)``, each receiver's window from the
    scope of ``shared`` (:func:`current`, taken in the thread that runs
    the pair-day) where it is not None and ``client``'s pair fetch is
    ``Client``'s."""
    if shared is None or getattr(type(client), "get_pair_processed_"
                                 "waveforms", None) is not \
            Client.get_pair_processed_waveforms:
        if shared is not None:
            _count("bypassed")
        return client.get_pair_processed_waveforms(
            pair=pair, time=time, operations=operations, **kwargs)
    scope, day = shared
    st = Stream()
    for receiver in split_pair(pair):
        st += scope.window(day, client, receiver, time, operations,
                           **kwargs)
    return st
