# Carried from xcorr_tpu/util/sysmem.py (see test_torch_host_copies).
r"""
:mod:`util.sysmem` -- Host allocator tuning for large-array workloads
=====================================================================

Day-scale processing allocates a stream of ~35-70 MB numpy buffers
(waveform spans, lag vectors, CCF planes). glibc serves allocations
above ``M_MMAP_THRESHOLD`` (128 KB default) with fresh ``mmap`` regions
and unmaps them on free — so every buffer pays first-touch page faults.
On microVM/sandboxed hosts those faults run at ~16 MB/s (measured:
2-30 s per day-scale vector), dwarfing the actual compute.

Raising the threshold keeps large buffers on the regular heap, which
glibc reuses: measured 300x faster repeated day-scale allocations
(28.5 s -> 0.07 s for an 8.6M-sample fftfreq). The batch entry points
(CLI scripts, ``lazy_process``, ``bench.py``) call this once at start.
"""

from __future__ import annotations

__all__ = ["malloc_heap_reuse"]

_applied = False


def malloc_heap_reuse(threshold_bytes: int = 1 << 30) -> bool:
    """Route allocations below ``threshold_bytes`` through the reusable
    glibc heap (``mallopt(M_MMAP_THRESHOLD, ...)``) and pin every thread
    to the MAIN arena (``M_ARENA_MAX = 1``). Idempotent; returns False
    (no-op) on non-glibc platforms.

    The arena pin matters as much as the threshold: glibc gives worker
    threads their own arenas, whose pages are fresh mmaps that fault in
    at ~16 MB/s here regardless of the threshold — a fetch or writer
    thread allocating day-scale spans/CCF buffers paid 14 s per span
    (measured round 3) while the warmed main thread paid 0.5 s. One
    shared arena keeps every thread on the already-faulted heap; the
    allocator lock it serializes on is irrelevant next to that.

    ``M_TRIM_THRESHOLD`` is raised to the same bound: with the default
    128 KB trim, freeing a day-scale buffer that sits at the top of the
    heap shrinks ``brk`` and returns the pages to the kernel — the next
    span/CCF allocation then re-pays the first-touch faults the heap
    reuse was meant to avoid.
    """
    global _applied
    if _applied:
        return True
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        M_TRIM_THRESHOLD = -1
        M_ARENA_MAX = -8
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(threshold_bytes)))
        libc.mallopt(M_TRIM_THRESHOLD, int(threshold_bytes))
        libc.mallopt(M_ARENA_MAX, 1)
        _applied = ok
        return ok
    except Exception:
        return False
