r"""
:mod:`util.profiler` -- Stage timing and device traces
======================================================

Port of ``xcorr_tpu/util/profiler.py``:

* :class:`StageTimer`, the stage sink that the device engine
  (:mod:`..parallel.engine`) and the batch runner (:mod:`..core.lazy`)
  report into: nested wall-clock, thread-CPU and byte/item counters per
  pipeline stage, with a one-line report;
* :func:`trace`: ``torch.profiler`` around a block, written as a chrome
  trace ``*.trace.json.gz`` under a directory;
* :func:`parse_device_trace`: device-busy seconds and device operations
  from the newest such trace;
* :func:`device_memory`: ``torch.cuda.memory_stats`` per device.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time
from collections import defaultdict

__all__ = ["StageTimer", "trace", "device_memory", "parse_device_trace"]


class StageTimer:
    """Accumulate per-stage wall time and optional byte/item throughput.

    >>> timer = StageTimer()
    >>> with timer("ingest", nbytes=123456):
    ...     pass
    >>> print(timer.report())
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._wall = defaultdict(float)
        self._cpu = defaultdict(float)
        self._pcpu = defaultdict(float)
        self._bytes = defaultdict(int)
        self._items = defaultdict(int)
        self._calls = defaultdict(int)
        self._last_end = {}

    @contextlib.contextmanager
    def __call__(self, stage: str, nbytes: int = 0, items: int = 0):
        # thread CPU beside wall: on a contended host wall >> cpu, and the
        # cpu number is what a dedicated core would pay. Stages timed from
        # different threads each measure their own thread; a stage that
        # fans work out to a pool shows cpu ~0 here, and process_cpu_s
        # (the whole process's CPU delta) covers it.
        t0 = time.perf_counter()
        c0 = time.thread_time()
        p0 = time.process_time()
        try:
            yield self
        finally:
            with self._lock:  # stages may be timed from pool threads
                self._wall[stage] += time.perf_counter() - t0
                self._cpu[stage] += time.thread_time() - c0
                self._pcpu[stage] += time.process_time() - p0
                self._bytes[stage] += nbytes
                self._items[stage] += items
                self._calls[stage] += 1
                self._last_end[stage] = time.perf_counter()

    def add(self, stage: str, seconds: float, nbytes: int = 0,
            items: int = 0, cpu_seconds: float = 0.0):
        with self._lock:
            self._wall[stage] += seconds
            self._cpu[stage] += cpu_seconds
            self._bytes[stage] += nbytes
            self._items[stage] += items
            self._calls[stage] += 1
            self._last_end[stage] = time.perf_counter()

    def last_end(self, stage: str):
        """perf_counter timestamp when the stage last finished (None if
        it never ran)."""
        return self._last_end.get(stage)

    @property
    def stages(self):
        return dict(self._wall)

    def as_dict(self):
        out = {}
        for stage, wall in self._wall.items():
            entry = {"wall_s": round(wall, 4),
                     "cpu_s": round(self._cpu[stage], 4),
                     "process_cpu_s": round(self._pcpu[stage], 4),
                     "calls": self._calls[stage]}
            if self._bytes[stage]:
                entry["GB"] = round(self._bytes[stage] / 1e9, 3)
                entry["GB_per_s"] = round(
                    self._bytes[stage] / 1e9 / wall, 3) if wall else None
            if self._items[stage]:
                entry["items"] = self._items[stage]
                entry["items_per_s"] = round(
                    self._items[stage] / wall, 3) if wall else None
            out[stage] = entry
        return out

    def report(self, as_json: bool = False):
        d = self.as_dict()
        if as_json:
            return json.dumps(d)
        total = sum(self._wall.values())
        lines = []
        for stage, entry in sorted(d.items(), key=lambda kv:
                                   -kv[1]["wall_s"]):
            pct = 100 * entry["wall_s"] / total if total else 0
            extra = ""
            if "GB_per_s" in entry and entry["GB_per_s"]:
                extra += f" {entry['GB_per_s']:.2f} GB/s"
            if "items_per_s" in entry and entry["items_per_s"]:
                extra += f" {entry['items_per_s']:.1f} items/s"
            lines.append(f"  {stage:<24s} {entry['wall_s']:8.3f} s "
                         f"({pct:4.1f}%) x{entry['calls']}{extra}")
        return "\n".join([f"Stage timings ({total:.3f} s total):"] + lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when torch sees a card) and write the chrome trace
    ``<logdir>/<host>.<pid>.<ns>.pt.trace.json.gz`` on exit. Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` read the same
    run."""
    import os
    import socket
    from torch.profiler import ProfilerActivity, profile
    import torch
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json.gz"))


def _union_us(spans):
    """Length of the union of ``(start, end)`` intervals."""
    spans = sorted(spans)
    busy, (cur0, cur1) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return busy + cur1 - cur0


def parse_device_trace(logdir: str):
    """Device-busy seconds + device operations from the newest chrome
    trace ``*.trace.json.gz`` under ``logdir`` (written by :func:`trace`,
    or by ``jax.profiler``), the contract of the JAX package's parser.

    Device processes are those whose name carries ``GPU``, ``TPU`` or
    ``/device:`` (not ``host``), as XLA names them, or whose
    ``process_labels`` are ``GPU <i>``, as torch's profiler labels a card
    (it names that process after the program: ``python3``). Their lanes
    are XLA's ``XLA Modules`` lanes, one span per executable launch,
    where the trace has them; else its ``XLA Ops`` lanes, torch's
    ``stream <id>`` lanes (each CUDA stream's kernels, copies and
    memsets) and unnamed lanes. Returns::

        {"device_busy_s": <sum over lanes of the union of their spans>,
         "launches": <number of spans on those lanes>}

    Each ``(pid, tid)`` lane is unioned on its own, so nested spans do not
    count twice, and the lanes are summed: two streams busy at once count
    both. (The JAX code unions every lane at once, against its own
    docstring; on one lane the two agree.) ``None`` when there is no trace
    or no device span.
    """
    import glob
    import gzip
    import os

    paths = sorted(glob.glob(os.path.join(
        logdir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        return None
    with gzip.open(paths[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])

    pid_name, pid_label, tid_name = {}, {}, {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        args = ev.get("args", {})
        if ev.get("name") == "process_name":
            pid_name[ev.get("pid")] = args.get("name", "")
        elif ev.get("name") == "process_labels":
            pid_label[ev.get("pid")] = args.get("labels", "")
        elif ev.get("name") == "thread_name":
            tid_name[(ev.get("pid"), ev.get("tid"))] = args.get("name", "")
    device_pids = {p for p, n in pid_name.items()
                   if ("/device:" in n or "TPU" in n or "GPU" in n)
                   and "host" not in n.lower()}
    device_pids |= {p for p, n in pid_label.items()
                    if re.fullmatch(r"GPU \d+", n.strip())}
    lanes = defaultdict(list)
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("pid") in device_pids
                and ev.get("dur", 0) > 0):
            t0 = float(ev["ts"])
            lanes[(ev["pid"], ev.get("tid"))].append(
                (t0, t0 + float(ev["dur"])))
    names = {k: tid_name.get(k, "") for k in lanes}
    modules = {k for k, n in names.items() if n == "XLA Modules"}
    keep = modules or {k for k, n in names.items()
                       if not n or n.startswith(("XLA Ops", "stream "))}
    lanes = {k: lanes[k] for k in keep}
    if not lanes:
        return None
    busy_us = sum(_union_us(spans) for spans in lanes.values())
    return {"device_busy_s": round(busy_us / 1e6, 6),
            "launches": sum(len(spans) for spans in lanes.values())}


def device_memory(mesh=None):
    """``torch.cuda.memory_stats`` (bytes and counts) of each CUDA device
    of ``mesh`` (a :class:`..parallel.mesh.Mesh`; default: every visible
    card), keyed by device name; ``None`` for a CPU entry."""
    import torch
    if mesh is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = list(dict.fromkeys(mesh.devices))
    return {str(d): torch.cuda.memory_stats(d) if d.type == "cuda"
            else None for d in devices}
