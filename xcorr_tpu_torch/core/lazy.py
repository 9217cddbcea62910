r"""
:mod:`core.lazy` -- Batch orchestration over (pair, day)
========================================================

Batch production (spec: ``xcorr/core/lazy.py:26-369``; port of
``xcorr_tpu/core/lazy.py``). Two engines:

* ``engine='host'`` (default): a host thread pool runs one (pair, day)
  shard at a time through :func:`..core.process.process`, whose windows
  correlate as one dense batch on the torch device;
* ``engine='device'``: chunks of ``days_per_launch`` (pair, day) tasks go
  through :func:`..parallel.engine.device_process_bulk` (raw spans
  shipped once, preprocessing and correlation on the device, up to 32
  windows per launch), while a writer thread overlaps chunk N's readback
  and shard writes with chunk N+1's fetches and launches.

On the host engine this process's pair-days run day by day, the pairs of
a day in the order of ``pairs``, inside a campaign scope
(:class:`..stream._shared.WindowScope`) that runs each receiver's chain
once per window for the pair-days that read it; the results keep the
gated list's order.

Resume semantics are identical: a shard whose ``status`` flags are all 1
is skipped, fetch failures are flagged -1 and retried on the next run.
In a multi-process group (:func:`..parallel.distributed.initialize`)
each process takes its :func:`..parallel.distributed.host_slice` of the
gated (pair, day) list and writes its own shards. ``mesh=`` splits the
device engine's launches over a :class:`..parallel.mesh.Mesh`. Not
ported: the JAX package's compile cache.
"""

from __future__ import annotations

import contextlib
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from .. import util
from ..io.filesystem import ncfile
from ..io.read import read
from ..io.write import write
from ..stream._shared import WindowScope
from .init import init as core_init
from .process import process as core_process, resolve_device

__all__ = ["single_threaded_process", "lazy_processes", "lazy_process"]


def _check_engine(engine: str):
    if engine not in ("host", "device"):
        raise ValueError(f"engine={engine!r}: expected 'host' or 'device'")


def single_threaded_process(pair: str, time, init_args: dict,
                            client, inventory, root: str,
                            force_fresh: bool = False, verb: int = 0,
                            engine: str = "host", mesh=None, **kwargs):
    """Read-or-init -> process -> write one (pair, day) shard; returns
    True when the shard is complete (reference
    ``xcorr/core/lazy.py:26-82``). ``kwargs`` go to
    :func:`..core.process.process` or, with ``engine='device'``, to
    :func:`..parallel.engine.device_process` (e.g. ``device``, and
    ``mesh``); a chain the device engine cannot run goes to the host
    engine, as in the JAX package."""
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
    if engine == "device":
        from ..parallel.engine import device_process
        try:
            device_process(data, client=client, inventory=inventory,
                           retry_missing=True, verb=verb, mesh=mesh,
                           **kwargs)
        except NotImplementedError:  # chain not device-compilable
            core_process(data, client=client, inventory=inventory,
                         retry_missing=True, verb=verb, **kwargs)
    else:
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
               verb: int = 0, scope=None, **kwargs):
    """Zero-arg callable running one (pair, day) shard with error
    isolation (an exception fails the task, not the campaign); with a
    :class:`..stream._shared.WindowScope`, inside its pair-day, which it
    releases when it ends, whatever the end."""
    def task():
        try:
            with (scope.pair_day(pair, time) if scope is not None
                  else contextlib.nullcontext()):
                return single_threaded_process(
                    pair, time, init_args or {}, client, inventory,
                    root, verb=verb, **kwargs)
        except Exception as error:
            warnings.warn(f"{pair} {time} failed: {error}", UserWarning)
            return False
    return task


def day_major(pair_days, pairs):
    """The places of ``pair_days`` in the order they run: by day, then by
    the pair's place in ``pairs``."""
    rank = {}
    for i, p in enumerate(pairs):
        rank.setdefault(p, i)
    return sorted(range(len(pair_days)),
                  key=lambda i: (pair_days[i][1], rank[pair_days[i][0]]))


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


def _device_bulk_run(pair_days, init_args, client, inventory, root,
                     days_per_launch: int, verb: int, timer,
                     force_fresh=False, mesh=None, **kwargs):
    """Chunked multi-day device orchestration: every ``days_per_launch``
    gated (pair, day) tasks batch into shared device launches (packed to
    the engine's 32-window cap), while a writer thread overlaps the
    readback + shard writes of chunk N with the archive fetches and
    device launches of chunk N+1."""
    from ..parallel.engine import device_process_bulk

    results = {}
    pending = []
    chunks = [pair_days[i:i + days_per_launch]
              for i in range(0, len(pair_days), days_per_launch)]
    with ThreadPoolExecutor(max_workers=2) as writer:
        for chunk in chunks:
            try:
                items = []
                with timer("init-shards"):
                    for pair, time in chunk:
                        # per-TASK isolation: a corrupt existing shard (or
                        # any read/init error) fails only its own (pair,
                        # day), not its chunk-mates
                        try:
                            nc = ncfile(pair, time, root)
                            # header-only resume fast-exit (no cc
                            # decompression); partial shards re-read
                            data = None if force_fresh else read(
                                nc, fast=True, verb=0, header_only=True)
                            if data is not None and \
                                    np.all(data["status"].values == 1):
                                results[(pair, time)] = True
                                continue
                            if data is not None:
                                data = read(nc, fast=True, verb=0)
                            if data is None:
                                data = core_init(
                                    pair=pair, starttime=time,
                                    endtime=time + pd.Timedelta("1D"),
                                    **{"inventory": inventory,
                                       **init_args})
                        except Exception as error:
                            warnings.warn(f"{pair} {time} failed: {error}",
                                          UserWarning)
                            results[(pair, time)] = False
                            continue
                        items.append((pair, time, data, nc))
                if not items:
                    continue
                finalize, fallback = device_process_bulk(
                    [d for _, _, d, _ in items], client,
                    inventory=inventory, retry_missing=True, timer=timer,
                    verb=verb - 1 if verb else 0, mesh=mesh, **kwargs)
                fb_ids = {id(d) for d in fallback}
                for pair, time, data, nc in items:
                    if id(data) not in fb_ids:
                        continue
                    # host fallback (chain not device-compilable), with
                    # per-item isolation: one raising fallback task must
                    # not discard the launches of its chunk-mates
                    try:
                        core_process(data, client=client,
                                     inventory=inventory,
                                     retry_missing=True, verb=0, **kwargs)
                        if np.any(data["status"].values == 1):
                            write(data, nc, verb=0)
                        results[(pair, time)] = bool(
                            np.all(data["status"].values == 1))
                    except Exception as error:
                        warnings.warn(f"{pair} {time} failed: {error}",
                                      UserWarning)
                        results[(pair, time)] = False
                dev_items = [it for it in items if id(it[2]) not in fb_ids]

                def flush(finalize=finalize, dev_items=dev_items):
                    out = {}
                    by_id = {id(d): (pair, time, d, nc)
                             for pair, time, d, nc in dev_items}
                    written = set()

                    def write_one(pair, time, data, nc):
                        # per-shard isolation: one failed write (disk
                        # full, transient IO) fails only its own shard.
                        # Runs in the writer thread, so its wall overlaps
                        # readbacks
                        try:
                            with timer("shard-write"):
                                if np.any(data["status"].values == 1):
                                    write(data, nc, verb=0)
                            out[(pair, time)] = bool(
                                np.all(data["status"].values == 1))
                        except Exception as error:
                            warnings.warn(f"write {nc} failed: {error}",
                                          UserWarning)
                            out[(pair, time)] = False

                    # each completed shard goes to a dedicated write
                    # thread the moment its last rows are read back, so
                    # the write overlaps the remaining readbacks
                    with ThreadPoolExecutor(max_workers=1) as wpool:
                        wjobs = []

                        def on_complete(data):
                            hit = by_id.get(id(data))
                            if hit is None:
                                return
                            written.add(id(data))
                            wjobs.append(wpool.submit(write_one, *hit))

                        finalize(on_complete=on_complete)
                        for f in wjobs:
                            f.result()
                    for pair, time, data, nc in dev_items:
                        if id(data) not in written:
                            write_one(pair, time, data, nc)
                    return out

                if dev_items:
                    # backpressure: each queued flush holds its chunk's
                    # device results until read back; drain the oldest
                    # before producing more, so at most ~2 chunks wait
                    while len(pending) >= 2:
                        f = pending.pop(0)
                        try:
                            results.update(f.result())
                        except Exception as error:
                            warnings.warn(f"finalize/write failed: "
                                          f"{error}", UserWarning)
                    pending.append(writer.submit(flush))
            except Exception as error:
                warnings.warn(f"chunk {chunk[0]}..{chunk[-1]} failed: "
                              f"{error}", UserWarning)
        for f in pending:
            try:
                results.update(f.result())
            except Exception as error:
                warnings.warn(f"finalize/write failed: {error}",
                              UserWarning)
    return [results.get(pd_, False) for pd_ in pair_days]


def lazy_process(pairs: list, times, init_args: dict, client_args: dict,
                 inventory=None, root: str = None, nworkers: int = None,
                 download: bool = True, distributed: bool = None,
                 days_per_launch: int = 8, verb: int = 1, mesh=None,
                 **kwargs):
    """End-to-end batch run (reference ``xcorr/core/lazy.py:197-369``):
    availability scan -> preprocess verification on one day -> gated
    (pair, day) fan-out. ``kwargs`` go to :func:`single_threaded_process`
    and on to :func:`..core.process.process` (``device`` defaults to
    ``'cuda'`` and raises here, before any work, when torch sees no
    card); with ``engine='device'`` and ``days_per_launch > 1``,
    chunks of that many (pair, day) tasks run through
    :func:`_device_bulk_run` instead. ``timer`` (a
    :class:`..util.profiler.StageTimer`) receives the campaign's stages.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`, ``engine='device'`` only)
    splits each device launch over the mesh's devices. Multi-process
    runs: in a ``torch.distributed`` group of more than one process
    (:func:`..parallel.distributed.initialize`, the analogue of the
    reference's Dask scheduler-file cluster,
    ``xcorr/scripts/utils.py:50-79``), each process takes its contiguous
    :func:`~..parallel.distributed.host_slice` of the gated (pair, day)
    list and writes its own shards: the filesystem stays the data plane.
    ``distributed`` forces the behaviour; None detects the group."""
    from ..stream.client import Client
    from ..util.sysmem import malloc_heap_reuse

    malloc_heap_reuse()  # large-buffer heap reuse (see util.sysmem)
    _check_engine(kwargs.get("engine", "host"))
    if mesh is not None and kwargs.get("engine") != "device":
        raise ValueError("mesh= splits the device engine's launches; "
                         "pass engine='device'")
    # a campaign without its device fails here, not task by task
    resolve_device(kwargs.get("device", "cuda"))
    timer = kwargs.pop("timer", None) or util.profiler.StageTimer()
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
    with timer("availability-scan"):
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
    with timer("preprocess-verify"):
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
    if distributed is None:
        import torch.distributed as dist
        distributed = (dist.is_available() and dist.is_initialized()
                       and dist.get_world_size() > 1)
    if distributed:
        from ..parallel.distributed import _group, host_slice
        rank, size = _group()
        ntotal = len(pair_days)
        pair_days = host_slice(pair_days)
        if verb > 0:
            print(f"Host {rank}/{size}: {len(pair_days)} of {ntotal} "
                  "pair-day tasks")

    if verb > 0:
        print(f"Scheduling {len(pair_days)} pair-day tasks")
    if mesh is not None:
        kwargs["mesh"] = mesh
    if kwargs.get("engine") == "device" and days_per_launch > 1:
        bulk_kwargs = {k: v for k, v in kwargs.items() if k != "engine"}
        results = _device_bulk_run(
            pair_days, init_args or {}, client, inventory, root,
            days_per_launch, verb - 1 if verb else 0, timer, **bulk_kwargs)
    else:
        # day by day, each receiver's processed windows shared by the
        # pair-days of the day that read them; results in the slice's order
        order = day_major(pair_days, pairs)
        with WindowScope.of(pair_days) as scope:
            tasks = [_make_task(*pair_days[i], init_args, client,
                                inventory, root,
                                verb=verb - 1 if verb else 0, scope=scope,
                                **kwargs)
                     for i in order]
            nworkers = nworkers or 4
            if nworkers > 1:
                with ThreadPoolExecutor(max_workers=nworkers) as ex:
                    done = list(ex.map(lambda t: t(), tasks))
            else:
                done = [t() for t in tasks]
        results = [None] * len(pair_days)
        for i, r in zip(order, done):
            results[i] = r

    completed = sum(bool(r) for r in results)
    if verb > 0:
        pct = 100.0 * completed / len(results) if results else 100.0
        print(f"Completed {completed} of {len(results)} ({pct:.1f}%)")
    return results
