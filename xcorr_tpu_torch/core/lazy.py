r"""
:mod:`core.lazy` -- Batch orchestration over (pair, day)
========================================================

Batch production (spec: ``xcorr/core/lazy.py:26-369``; port of
``xcorr_tpu/core/lazy.py``'s host engine): a host thread pool runs one
(pair, day) shard at a time through :func:`..core.process.process`, whose
windows correlate as one dense batch on the torch device. Resume
semantics are identical: a shard whose ``status`` flags are all 1 is
skipped, fetch failures are flagged -1 and retried on the next run.

The device-preprocess engine (``engine='device'``) is not ported yet.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from .. import util
from ..io.filesystem import ncfile
from ..io.read import read
from ..io.write import write
from .init import init as core_init
from .process import process as core_process

__all__ = ["single_threaded_process", "lazy_processes", "lazy_process"]


def _check_engine(engine: str):
    if engine == "device":
        raise NotImplementedError("device engine: ROADMAP slice 2")
    if engine != "host":
        raise ValueError(f"engine={engine!r}: expected 'host'")


def single_threaded_process(pair: str, time, init_args: dict,
                            client, inventory, root: str,
                            force_fresh: bool = False, verb: int = 0,
                            engine: str = "host", **kwargs):
    """Read-or-init -> process -> write one (pair, day) shard; returns
    True when the shard is complete (reference
    ``xcorr/core/lazy.py:26-82``). ``kwargs`` go to
    :func:`..core.process.process` (e.g. ``device``)."""
    _check_engine(engine)
    data = None
    time = util.time.to_datetime(time)
    nc = ncfile(pair, time, root)
    if not force_fresh:
        # resume fast-exit from a header-only read (status + metadata,
        # no cc decompression); partial shards re-read payloads below
        data = read(nc, fast=True, verb=verb, header_only=True)
        if data is not None and np.all(data["status"].values == 1):
            return True
        if data is not None:
            data = read(nc, fast=True, verb=verb)
    if data is None:
        # the caller's inventory feeds init too (pair distance) unless
        # init_args overrides it — reference passes it explicitly
        # (xcorr/core/lazy.py:60-66); without it distance is silently 0
        data = core_init(
            pair=pair,
            starttime=time,
            endtime=time + pd.Timedelta("1D"),
            **{"inventory": inventory, **init_args},
        )
    core_process(data, client=client, inventory=inventory,
                 retry_missing=True, verb=verb, **kwargs)
    if np.any(data["status"].values == 1):
        write(data, nc, verb=verb)
    return bool(np.all(data["status"].values == 1))


def gated_pair_days(pairs: list, times, availability=None,
                    preprocessing=None, verb: int = 0):
    """The gated (pair, day) work list: pairs whose receivers passed the
    availability scan (per day) and the preprocess preflight (reference
    gating, ``xcorr/core/lazy.py:85-194``).

    Documented divergence: the reference gates each window on any fully
    available day within ``[time - wl/2, time + 3wl/2]`` (an extended
    ±1-day scan, since windows straddle day boundaries); here the gate
    is the exact-day availability flag per receiver. The engine's
    grid-canonical spans make the difference benign — a window whose
    tail reaches into a missing neighbouring day processes against the
    zero-filled grid and is flagged missing per-window rather than
    dropping the whole day up front."""
    out = []
    for pair in pairs:
        receivers = util.receiver.split_pair(pair, substitute=True)
        for time in pd.DatetimeIndex(np.asarray(times)):
            if availability is not None:
                ok = True
                for r in receivers:
                    try:
                        flag = availability.sel(receiver=r, time=time)
                        ok &= int(np.asarray(flag.values)) == 1
                    except KeyError:
                        ok = False
                if not ok:
                    if verb > 0:
                        print(f"{pair} {time}: not available. Skip.")
                    continue
            if preprocessing is not None:
                ok = True
                # the preprocess status grid is keyed by UNSUBSTITUTED
                # receiver names (the ops-chain channel, e.g. ..BHR)
                for r in util.receiver.split_pair(pair, substitute=False):
                    try:
                        flag = preprocessing.sel(receiver=r)
                        ok &= int(np.asarray(flag.values).ravel()[0]) == 1
                    except KeyError:
                        ok = False
                if not ok:
                    if verb > 0:
                        print(f"{pair} {time}: preprocessing failed. Skip.")
                    continue
            out.append((pair, time))
    return out


def _make_task(pair, time, init_args, client, inventory, root,
               verb: int = 0, **kwargs):
    """Zero-arg callable running one (pair, day) shard with error
    isolation (an exception fails the task, not the campaign)."""
    def task():
        try:
            return single_threaded_process(
                pair, time, init_args or {}, client, inventory,
                root, verb=verb, **kwargs)
        except Exception as error:
            warnings.warn(f"{pair} {time} failed: {error}", UserWarning)
            return False
    return task


def lazy_processes(pairs: list, times, availability=None, preprocessing=None,
                   init_args: dict = None, client=None, inventory=None,
                   root: str = None, verb: int = 0, **kwargs):
    """Build the gated (pair, day) task list: each item is a zero-arg
    callable (reference builds dask.delayed objects,
    ``xcorr/core/lazy.py:85-194``)."""
    return [_make_task(pair, time, init_args, client, inventory, root,
                       verb=verb, **kwargs)
            for pair, time in gated_pair_days(pairs, times,
                                              availability=availability,
                                              preprocessing=preprocessing,
                                              verb=verb)]


def lazy_process(pairs: list, times, init_args: dict, client_args: dict,
                 inventory=None, root: str = None, nworkers: int = None,
                 download: bool = True, verb: int = 1, **kwargs):
    """End-to-end batch run (reference ``xcorr/core/lazy.py:197-369``):
    availability scan -> preprocess verification on one day -> gated
    (pair, day) fan-out over a thread pool. ``kwargs`` go to
    :func:`single_threaded_process` and on to
    :func:`..core.process.process` (``device`` defaults to ``'cuda'``).
    Multi-host and multi-GPU campaigns are not ported yet."""
    from ..stream.client import Client

    _check_engine(kwargs.get("engine", "host"))
    client = client_args if hasattr(client_args, "get_waveforms") else \
        Client(**client_args)

    times = pd.DatetimeIndex(np.asarray(times))
    pairs = list(pairs)

    # receivers of all pairs. Availability scans the SUBSTITUTED names
    # (an R/T channel needs its raw 1/2/Z components in the archive);
    # preprocess verification runs on the UNSUBSTITUTED names (the ops
    # dict is keyed by the pair's channel, e.g. 'BHR', and
    # get_processed_waveforms substitutes internally) — matching the
    # reference split at xcorr/core/lazy.py:134-141.
    receivers = []
    receivers_chain = []
    for p in pairs:
        for r in util.receiver.split_pair(p, substitute=True):
            if r not in receivers:
                receivers.append(r)
        for r in util.receiver.split_pair(p, substitute=False):
            if r not in receivers_chain:
                receivers_chain.append(r)

    # 1. availability scan (parallel host IO)
    if verb > 0:
        print(f"Verify waveform availability for {len(receivers)} "
              f"receivers x {len(times)} days")
    availability = client.verify_waveform_availability(
        receivers, times, substitute=False, parallel=True,
        download=download, verb=verb)

    # 2. preprocess verification on one fully-available day; no such
    # day means at least one receiver has no usable data at all — fail
    # fast like the reference (xcorr/core/lazy.py:322-344) instead of
    # scheduling a campaign with an unvalidated preprocess chain
    av = availability.values
    full_days = np.nonzero((av == 1).all(axis=0))[0]
    if not full_days.size:
        missing = [str(r) for r, flags in zip(receivers, av == 1)
                   if not flags.any()]
        raise RuntimeError(
            "no day with full waveform availability to verify "
            "preprocessing on" + (f"; receivers with no available "
                                  f"data: {missing}" if missing else ""))
    day = times[int(full_days[0])] + pd.Timedelta("12h")
    if verb > 0:
        print(f"Verify waveform preprocessing on {day}")
    preprocessing = client.verify_waveform_processing(
        receivers_chain, day,
        operations=init_args["preprocess"],
        inventory=inventory,
        sampling_rate=init_args.get("sampling_rate"),
        duration=init_args.get("window_length", 86400.0),
        parallel=True, verb=verb)

    # 3. gated fan-out
    pair_days = gated_pair_days(pairs, times, availability=availability,
                                preprocessing=preprocessing,
                                verb=verb - 1 if verb else 0)
    if not pair_days:
        # an empty GLOBAL work list is a misconfiguration (wrong roots,
        # everything gated out) — fail loudly like the reference
        # (xcorr/core/lazy.py:346-350) rather than reporting a clean
        # "0 of 0" success to automation
        raise RuntimeError(
            "no (pair, day) tasks to schedule: availability and "
            "preprocess gating removed the entire campaign")
    if verb > 0:
        print(f"Scheduling {len(pair_days)} pair-day tasks")
    tasks = [_make_task(pair, time, init_args, client, inventory,
                        root, verb=verb - 1 if verb else 0, **kwargs)
             for pair, time in pair_days]
    nworkers = nworkers or 4
    if nworkers > 1:
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            results = list(ex.map(lambda t: t(), tasks))
    else:
        results = [t() for t in tasks]

    completed = sum(bool(r) for r in results)
    if verb > 0:
        pct = 100.0 * completed / len(results) if results else 100.0
        print(f"Completed {completed} of {len(results)} ({pct:.1f}%)")
    return results
