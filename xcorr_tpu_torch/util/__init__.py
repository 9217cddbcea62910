r"""
:mod:`xcorr_tpu_torch.util` -- Utilities
========================================

Host-side utilities carried from :mod:`xcorr_tpu.util`: provenance
hashing, history logging, time handling, SEED-id/geodesy receiver helpers,
correlation lag math and the CF global attributes; the port's own stage
timer and device traces (:mod:`.profiler`), host <-> device conversion
(:mod:`.convert`) and the glibc heap settings carried from
:mod:`xcorr_tpu.util.sysmem` (:mod:`.sysmem`).
"""

from . import (cc, convert, geo, hasher, history, metadata, profiler,
               receiver, sysmem, time)
from .hasher import (hash, hash_obj, hash_Trace, hash_Stream, hash_DataArray,
                     hash_Dataset)
from .history import historicize
from .time import to_seconds, to_datetime, get_dates, update_lag_indices

__all__ = ["cc", "convert", "geo", "hasher", "history", "metadata", "profiler",
           "receiver", "sysmem", "time",
           "hash", "hash_obj", "hash_Trace", "hash_Stream",
           "hash_DataArray", "hash_Dataset", "historicize", "to_seconds",
           "to_datetime", "get_dates", "update_lag_indices"]
