r"""
:mod:`xcorr_tpu_torch.stream` -- Waveform ingest
================================================

Waveform containers, station inventory, the hashed preprocess-operations
DSL and archive clients, carried from :mod:`xcorr_tpu.stream`. The
miniSEED codec (``native/``) and the FDSN client are not carried yet:
SDS archives in HDF5 and the :class:`SyntheticClient` work without them.
"""

from .trace import Trace, Stream, Stats, UTCDateTime
from .inventory import Inventory, Channel, PAZResponse
from .client import Client, SyntheticClient
from .sds import SDSArchive, to_SDS
from . import process  # noqa: F401  (the ops DSL)
from .duration import duration
from .vdms import VDMSClient
from .running_rms import running_rms

__all__ = ["Trace", "Stream", "Stats", "UTCDateTime",
           "Inventory", "Channel", "PAZResponse", "Client",
           "SyntheticClient", "SDSArchive", "to_SDS", "process",
           "duration", "running_rms", "VDMSClient"]
