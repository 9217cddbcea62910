r"""
:mod:`stream._live` -- the fetched components that a chain reads
================================================================

An R or T receiver fetches its three raw components
(``Client.get_processed_waveforms``, ``three_components="12Z"``) and runs
its chain over all of them. In the production BHR chain
(``scripts/cc.py``) ``rotate ->ZNE`` only renames 1 to N and 2 to E,
``NE->RT`` reads N and E, and ``select BHR`` drops the rest: every step
run on BHZ (merge, filters, demean, ``remove_response``) is thrown away.

:func:`live_channels` walks a chain backwards and names the fetched
channels that some later operation reads: of BH1, BH2 and BHZ the
production BHR chain (and ``example_process_dict``'s, the same list)
reads BH1 and BH2, a T chain the same two; the BHZ and EDH chains have
no ``select`` and read all they fetch (their own channel alone).
:func:`drop_unread` drops the
others before the chain runs, where it can show that none of the steps
they would have run raises (a step that raises fails the whole window:
``process`` warns and returns None). Otherwise it drops nothing, so a
window that fails on the carried path fails the same way, with the same
warning. The live traces run the same steps in the same order, so the
chain's output is the same bits. The fetch itself is unchanged: a read
that raises still raises.

Every way a step of the carried ``stream/trace.py`` can raise on a trace
that would be dropped, and the check that covers it (any other step on
its way, and any exception in the checks, drops nothing):

- all steps: samples that are not real numbers (``astype`` warns on
  complex ones), none (a mean of nothing warns, ``normalize``'s ``max``
  raises), or not finite or too large (a step may warn of an invalid or
  overflowing value) -- checked once on the fetched samples;
- ``merge``: gaps with ``method=0`` and no ``fill_value``, a trace that
  overruns its group's grid, a bad ``dtype`` -- the trace must be the
  only one of its id and rate, fill its grid exactly (so its length does
  not change), and ``dtype`` be unset;
- ``filter``: an unknown type, a missing frequency, a cutoff at or above
  the trace's Nyquist or a bad order (``scipy.signal.butter`` raises),
  ``sosfiltfilt`` on a trace shorter than its pad -- the sections are
  designed for the trace's rate as the step designs them, and a
  zero-phase filter drops nothing;
- ``detrend``: an unknown type -- the type is checked;
- ``taper``: no length given, an unknown window -- the length is worked
  out as the step works it out, and a window other than cosine or hann
  drops nothing;
- ``remove_response``: no inventory entry for the trace
  (``Inventory.get_response`` raises ``KeyError``), an unknown output, a
  bad water level or ``pre_filt`` -- the response is looked up and its
  inverse made (``_response.inverse_response``: cached, and shared with
  the other components where their responses are equal);
- ``remove_sensitivity``: no inventory, or no entry (``KeyError``), a
  sensitivity that is not a number, zero, or so small or large that the
  quotient may overflow -- the sensitivity is looked up and bounded;
- ``normalize``: no samples -- checked with the samples;
- ``rotate`` and ``select``: what raises there (no back azimuth, an
  unknown method, a bad pattern) raises whatever the dropped traces;
- ``trim``, ``decimate``, ``interpolate``, ``resample``, ``simulate``,
  ``attach_response``, ``running_rms`` and callables: not checked, so a
  trace that would run one of them is not dropped.
"""

from __future__ import annotations

import inspect
from fnmatch import fnmatch

import numpy as np
import scipy.signal as sp_signal

from ._fftlen import next_fast_len
from .process import is_operation
from .trace import Stream, Trace

__all__ = ["live_channels", "drop_unread"]

#: operations that act trace by trace, each trace's channel unchanged
PER_TRACE = frozenset({
    "merge", "filter", "detrend", "taper", "trim", "decimate",
    "interpolate", "remove_response", "remove_sensitivity", "resample",
    "normalize"})

#: the largest sample or sensitivity magnitude at which no step of a
#: dropped trace can overflow
_BOUND = 1e100


def _everything(name):
    return True


def live_channels(ops, channel, fetched):
    """The channels of ``fetched`` that the chain ``ops`` of ``channel``
    reads: walked backwards from the stream the chain returns (every
    channel that no ``select`` removes), by these rules:

    - ``select(channel=...)`` keeps what it matches;
    - ``rotate ->ZNE`` maps N back to 1 and E back to 2, as its rename
      does;
    - ``rotate NE->RT`` makes R and T read both N and E of their base;
    - the operations of :data:`PER_TRACE` pass the set through;
    - any other operation, a callable or an unknown rotation keeps every
      channel.

    ``channel`` itself, the receiver's own channel, is always live."""
    live = _everything
    for op in reversed(list(ops)):
        live = _before(op, live)
    return {c for c in fetched if c == channel or live(c)}


def _before(op, live):
    """The channels live before ``op`` where ``live`` are live after it."""
    if not (isinstance(op, (tuple, list)) and len(op) == 2):
        return _everything
    name, params = op
    if not isinstance(params, dict) or not isinstance(name, str):
        return _everything
    if name in PER_TRACE:
        return live
    if name == "select":
        pattern = params.get("channel")
        if pattern is None:
            return live
        if not isinstance(pattern, str):
            return _everything
        return lambda c: live(c) and fnmatch(c, pattern)
    if name == "rotate" and params.get("method") == "->ZNE":
        return lambda c: live(c[:-1] + {"1": "N", "2": "E"}.get(
            c[-1:], c[-1:]))
    if name == "rotate" and params.get("method") == "NE->RT":
        return lambda c: live(c) or (c[-1:] in ("N", "E") and (
            live(c[:-1] + "R") or live(c[:-1] + "T")))
    return _everything


def drop_unread(st, ops, channel, inventory=None):
    """``st`` without the traces whose channels the chain ``ops`` of
    ``channel`` never reads (:func:`live_channels`), where every step
    they would have run is shown not to raise; else ``st`` itself."""
    try:
        live = live_channels(ops, channel, [t.stats.channel for t in st])
        dropped = [t for t in st if t.stats.channel not in live]
        if not dropped or len(dropped) == len(st):
            return st
        for t in dropped:
            steps = _steps_run(t, st, ops)
            if steps is None or not _samples_ok(t) or not all(
                    _never_raises(t, st, op, inventory) for op in steps):
                return st
    except Exception:  # a check that cannot decide drops nothing
        return st
    return Stream([t for t in st if t not in dropped])


def _steps_run(t, st, ops):
    """The operations of ``ops`` that run on ``t`` before a ``select``
    removes it (``process`` order; the malformed and unknown ones it
    skips are left out), or None where ``t`` reaches the chain's end.
    Follows every trace's channel through the renames of ``rotate``."""
    traces = [[u.stats.network, u.stats.station, u.stats.location,
               u.stats.channel, u.stats.sampling_rate, u is t] for u in st]
    run = []
    for op in ops:
        if not (isinstance(op, (tuple, list)) and len(op) == 2):
            continue
        name, params = op
        if not (callable(name) or is_operation(name)):
            continue
        if name == "select":
            traces = [e for e in traces if _selects(e, **params)]
            if not any(e[5] for e in traces):
                return run
        elif name == "merge":
            seen = set()
            traces = [e for e in traces if not (
                tuple(e[:5]) in seen or seen.add(tuple(e[:5])))]
        elif name == "rotate" and params.get("method") == "->ZNE":
            for e in traces:
                e[3] = e[3][:-1] + {"1": "N", "2": "E"}.get(e[3][-1:],
                                                            e[3][-1:])
        elif name == "rotate" and params.get("method") == "NE->RT":
            for base in {e[3][:-1] for e in traces}:
                n = [e for e in traces if e[3] == base + "N"]
                e_ = [e for e in traces if e[3] == base + "E"]
                if len(n) == 1 and len(e_) == 1:
                    n[0][3], e_[0][3] = base + "R", base + "T"
        run.append(op)
    return None


def _selects(e, network=None, station=None, location=None, channel=None,
             **kw):
    """Whether ``Stream.select`` keeps the trace ``e``."""
    return all(p is None or fnmatch(v, p) for v, p in zip(
        e[:4], (network, station, location, channel)))


def _samples_ok(t):
    """Real, present, finite and bounded samples."""
    x = t.data
    if x.dtype.kind not in "biuf" or x.size == 0 or t.stats.npts < 1:
        return False
    m = float(np.abs(x).max())
    return bool(np.isfinite(m)) and m < _BOUND


def _bind(method, t, params, inventory=None, inject=False):
    """``params`` bound to ``method``'s signature as ``apply_operation``
    calls it (the inventory injected where the operation takes one),
    defaults applied."""
    kw = {**params, "inventory": inventory} if inject else params
    bound = inspect.signature(method).bind(t, **kw)
    bound.apply_defaults()
    return bound.arguments


def _never_raises(t, st, op, inventory):
    """Whether the step ``op`` cannot raise on ``t`` (see the module)."""
    name, params = op
    if name in ("select", "rotate"):
        return True
    check = _CHECKS.get(name) if isinstance(name, str) else None
    return bool(check and check(t, st, params, inventory))


def _merge(t, st, params, inventory):
    a = _bind(Stream.merge, st, params)
    fs = t.stats.sampling_rate
    same = [u for u in st if u.id == t.id and u.stats.sampling_rate == fs]
    return (a["dtype"] is None and same == [t] and np.isfinite(fs)
            and fs > 0 and int(round((t.stats.endtime - t.stats.starttime)
                                     * fs)) + 1 == t.stats.npts)


def _filter(t, st, params, inventory):
    a = _bind(Trace.filter, t, params)
    kind, options, corners = a["type"], a["options"], a["corners"]
    if a["zerophase"]:
        return False
    nyq = 0.5 * t.stats.sampling_rate
    if kind in ("bandpass", "bandstop"):
        sp_signal.butter(corners, [options["freqmin"] / nyq,
                                   options["freqmax"] / nyq],
                         btype=kind, output="sos")
    elif kind in ("highpass", "lowpass"):
        sp_signal.butter(corners, options["freq"] / nyq, btype=kind,
                         output="sos")
    else:
        return False
    return True


def _detrend(t, st, params, inventory):
    return _bind(Trace.detrend, t, params)["type"] in (
        "demean", "constant", "linear", "simple")


def _taper(t, st, params, inventory):
    a = _bind(Trace.taper, t, params)
    fs = t.stats.sampling_rate
    if a["max_percentage"] is None:
        wlen = int(a["max_length"] * fs)
    else:
        wlen = int(t.stats.npts * float(a["max_percentage"]))
        if a["max_length"] is not None:
            wlen = min(wlen, int(a["max_length"] * fs))
    return min(wlen, t.stats.npts // 2) < 1 or a["type"] in ("cosine",
                                                             "hann")


def _remove_response(t, st, params, inventory):
    from . import _response
    from .inventory import flat_response
    a = _bind(Trace.remove_response, t, params, inventory, inject=True)
    resp = (a["inventory"].get_response(t.id, t.stats.starttime)
            if a["inventory"] is not None else flat_response())
    _response.inverse_response(resp, next_fast_len(2 * t.stats.npts),
                               t.stats.delta, a["output"],
                               a["water_level"], a["pre_filt"])
    return True


def _remove_sensitivity(t, st, params, inventory):
    a = _bind(Trace.remove_sensitivity, t, params, inventory, inject=True)
    sens = abs(float(a["inventory"].get_sensitivity(t.id,
                                                    t.stats.starttime)))
    return 1.0 / _BOUND < sens < _BOUND


def _normalize(t, st, params, inventory):
    return True


_CHECKS = {"merge": _merge, "filter": _filter, "detrend": _detrend,
           "taper": _taper, "remove_response": _remove_response,
           "remove_sensitivity": _remove_sensitivity,
           "normalize": _normalize}


def _drop_unread_plain(st, ops, channel, inventory=None):
    """The carried chain's input: every fetched trace."""
    return st
