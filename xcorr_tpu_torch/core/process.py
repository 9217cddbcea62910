r"""
:mod:`core.process` -- Batched correlation of a CCF dataset
===========================================================

The correlation loop (spec: ``xcorr/core/process.py:23-185``; port of
``xcorr_tpu/core/process.py``, the host engine): windows are fetched and
preprocessed on the host (optionally with a thread pool), stacked into
one dense ``(batch, npts)`` block, moved to ``device`` and correlated
there by :func:`xcorr_tpu_torch.ops.cc.correlate`; the CCFs come back
with ``.cpu()``.

The fetch threads outlive the call: :func:`fetch_all` runs a call's
fetches on the one pool of :data:`FETCH_THREADS` threads that the
process keeps, made on first use, so each thread's arrays (the window
merge's buffer and ``remove_response``'s, :mod:`..stream._steps`) serve
every later pair-day instead of taking fresh pages for each. Pair-days
that run at once (``lazy_process``'s workers) share its threads, each
call with at most its own ``nworkers`` fetches at once;
:func:`shutdown_fetch_pool` ends the threads and with them what they
keep. The plain version of :func:`fetch_all`, ``_fetch_all_plain``, is a
pool per call, as in the reference (:data:`FORMS`).

A pair-day that ``lazy_process`` runs on the host engine takes each
receiver's processed window from the campaign's scope
(:func:`..stream._shared.pair_windows`), which runs each receiver's chain
once per window for the pair-days of this process that read it. Outside
such a scope, and on the plain version ``_pair_windows_plain``, the pair
fetch is the client's ``get_pair_processed_waveforms``, as in the
reference.

Status/offset/hash bookkeeping, ops-hash validation and the
``retry_missing``/``test_run`` semantics match the reference exactly.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pandas as pd
import torch

from .. import ops, stream as stream_mod, util
from ..signal.unbias import unbias
from ..stream import _shared
from ..stream._shared import pair_windows

__all__ = ["process", "resolve_device", "shutdown_fetch_pool"]

#: the threads of the process's fetch pool; a call that asks for more
#: fetches at once runs on a pool of its own
FETCH_THREADS = 8

#: the fetch pool and the process that made it
_POOL, _POOL_PID = None, None
_POOL_LOCK = threading.Lock()


def _fetch_pool():
    """The process's fetch pool, made on first use (anew in a forked
    child, which has none of its parent's threads)."""
    global _POOL, _POOL_PID
    with _POOL_LOCK:
        if _POOL is None or _POOL_PID != os.getpid():
            _POOL = ThreadPoolExecutor(max_workers=FETCH_THREADS,
                                       thread_name_prefix="xcorr-fetch")
            _POOL_PID = os.getpid()
        return _POOL


def shutdown_fetch_pool():
    """End the fetch pool's threads, waiting for their tasks: what each
    thread keeps goes with it. The next :func:`process` makes a new
    pool."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


def fetch_all(fetch, work, nworkers):
    """``[fetch(w) for w in work]`` on the process's fetch pool, at most
    ``nworkers`` at once, in ``work``'s order (more than
    :data:`FETCH_THREADS`: on a pool of its own). A fetch that raises
    raises here, and the call submits no fetch after it; before this
    returns or raises, the fetches that had not started are cancelled
    and those running have ended."""
    if nworkers > FETCH_THREADS:
        return _fetch_all_plain(fetch, work, nworkers)
    pool, slots, failed = _fetch_pool(), threading.Semaphore(nworkers), []

    def task(w):
        try:
            return fetch(w)
        except BaseException:
            failed.append(w)
            raise
        finally:
            slots.release()

    futures = []
    try:
        for w in work:
            slots.acquire()
            if failed:
                break
            futures.append(pool.submit(task, w))
        return [f.result() for f in futures]
    finally:
        for f in futures:
            f.cancel()
        wait(futures)


def _fetch_all_plain(fetch, work, nworkers):
    with ThreadPoolExecutor(max_workers=nworkers) as ex:
        return list(ex.map(fetch, work))


def _pair_windows_plain(shared, client, pair, time, operations, **kwargs):
    return client.get_pair_processed_waveforms(
        pair=pair, time=time, operations=operations, **kwargs)


#: the forms :func:`process` calls, each with its plain version
#: ``_<name>_plain``
FORMS = ("fetch_all", "pair_windows")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises when torch
    sees none (no silent route to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; "
            "pass device='cpu' to correlate on the host")
    return device


def process(dataset, client, inventory=None, retry_missing: bool = False,
            test_run: bool = False, hash_waveforms: bool = True,
            metadata_hash: str = None, verb: int = 1,
            batch_size: int = None, prefetch_workers: int = None,
            device="cuda", **kwargs):
    """Correlate every unprocessed (pair, time) window of ``dataset`` on
    the torch ``device``.

    ``batch_size`` limits the device batch (default: all pending windows at
    once); ``prefetch_workers`` parallelizes the host waveform gathering.
    ``device`` defaults to ``'cuda'`` and raises when no CUDA device is
    present; pass ``device='cpu'`` to correlate on the host.
    """
    device = resolve_device(device)
    dataset.attrs["history"] = (
        dataset.attrs.get("history", "") +
        f", Process started @ {pd.to_datetime('now')}")

    # validate preprocess operations (hash-verified config-as-data)
    pre = dataset.coords["pair"].attrs["preprocess"]
    if isinstance(pre, dict):
        o = pre
        stream_mod.process.check_operations_hash(o, raise_error=True)
    else:
        o = stream_mod.process.operations_to_dict(pre)

    util.time.update_lag_indices(dataset.coords["lag"])
    lag_attrs = dataset.coords["lag"].attrs
    npts = int(lag_attrs["npts"])
    imin, imax = int(lag_attrs["index_min"]), int(lag_attrs["index_max"])
    sampling_rate = float(lag_attrs["sampling_rate"])

    hash_waveforms = hash_waveforms and "hash" in dataset.variables

    pairs = dataset.coords["pair"].values
    times = pd.DatetimeIndex(dataset.coords["time"].values)
    window_length = float(dataset.coords["time"].attrs["window_length"])
    status = dataset["status"].values

    # build the work list with the reference's status gating
    work = []
    for ip, p in enumerate(pairs):
        for it, t in enumerate(times):
            flag = status[ip, it]
            if flag != 0 and not (retry_missing and flag == -1):
                if verb > 1:
                    print(f'{p} {t}: has status "{flag}". Skip.')
                continue
            work.append((ip, it))
            if test_run:
                # reference semantics: one window PER PAIR (only the
                # time loop breaks, xcorr/core/process.py:120-125)
                break
    if not work:
        _finalize(dataset, verb)
        return dataset

    shared = _shared.current()

    def fetch(item):
        ip, it = item
        p, t = pairs[ip], times[it]
        if verb > 0:
            print(str(p), str(t)[:19], end=": Waveforms. ")
        st = pair_windows(
            shared, client, pair=str(p), time=t, operations=o,
            duration=window_length, inventory=inventory,
            sampling_rate=sampling_rate, verb=verb - 1 if verb else 0,
            strict=True, **kwargs)
        if not isinstance(st, stream_mod.Stream) or len(st) != 2:
            if verb > 0:
                print('Missing data. Set status "-1" and skip.')
            return item, None
        if verb > 0:
            print("Done.")
        return item, st

    nworkers = prefetch_workers or min(8, max(1, len(work)))
    if nworkers > 1 and len(work) > 1:
        fetched = fetch_all(fetch, work, nworkers)
    else:
        fetched = [fetch(w) for w in work]

    # bookkeeping + dense stacking
    good, xs_, ys_ = [], [], []
    for (ip, it), st in fetched:
        if st is None:
            status[ip, it] = -1
            continue
        t = times[it]
        pair_offset = (pd.Timestamp(st[0].stats.starttime.ns)
                       - pd.Timestamp(st[1].stats.starttime.ns)
                       ) / pd.Timedelta("1s")
        time_offset = (pd.Timestamp(st[0].stats.starttime.ns)
                       + pd.to_timedelta(window_length / 2, unit="s")
                       - t) / pd.Timedelta("1s")
        dataset["pair_offset"].values[ip, it] = pair_offset
        dataset["time_offset"].values[ip, it] = time_offset
        if hash_waveforms:
            if verb > 0:
                print("Hash", end=". ")
            dataset["hash"].values[ip, it] = util.hash_Stream(st)
        good.append((ip, it))
        xs_.append(st[0].data[:npts])
        ys_.append(st[1].data[:npts])

    if good:
        dtype = dataset["cc"].dtype
        x = np.stack(xs_).astype(dtype)
        y = np.stack(ys_).astype(dtype)
        normalize = dataset["cc"].attrs.get("normalize", 1) == 1
        bsz = batch_size or x.shape[0]
        if verb > 0:
            print(f"CC batch of {x.shape[0]} windows "
                  f"({x.shape[0] * npts * 4 / 1e6:.0f} MB)", end=". ")
        out = np.empty((x.shape[0], imax - imin), dtype=dtype)
        for i in range(0, x.shape[0], bsz):
            blk = ops.cc.correlate(
                torch.from_numpy(x[i:i + bsz]).to(device),
                torch.from_numpy(y[i:i + bsz]).to(device),
                normalize=normalize, index_min=imin, index_max=imax,
                unbiased=False)  # bias correction dataset-wide, like ref
            out[i:i + bsz] = blk.cpu().numpy()
        for b, (ip, it) in enumerate(good):
            dataset["cc"].values[ip, it] = out[b]
            status[ip, it] = 1
        if verb > 0:
            print("Done.")

    _finalize(dataset, verb)
    return dataset


def _finalize(dataset, verb):
    dataset.attrs["history"] += \
        f", Process ended @ {pd.to_datetime('now')}"
    if dataset["cc"].attrs.get("bias_correct", 0) == 1:
        dataset["cc"] = unbias(dataset["cc"])
        dataset.attrs["history"] += \
            f", Unbiased CC @ {pd.to_datetime('now')}"
    dataset.attrs["sha256_hash_metadata"] = util.hasher.hash_Dataset(
        dataset, metadata_only=True)
