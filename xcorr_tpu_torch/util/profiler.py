r"""
:mod:`util.profiler` -- Stage timing
====================================

:class:`StageTimer`, the stage sink that the device engine
(:mod:`..parallel.engine`) and the batch runner (:mod:`..core.lazy`)
report into: nested wall-clock, thread-CPU and byte/item counters per
pipeline stage, with a one-line report. Port of the ``StageTimer`` of
``xcorr_tpu/util/profiler.py``; its device-trace parser moves to
``torch.profiler`` in a later slice.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

__all__ = ["StageTimer"]


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
