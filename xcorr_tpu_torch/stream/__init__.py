r"""
:mod:`xcorr_tpu_torch.stream` -- Waveform ingest
================================================

Waveform containers, station inventory, the hashed preprocess-operations
DSL and archive clients, carried from :mod:`xcorr_tpu.stream`, with the
miniSEED codec (:mod:`xcorr_tpu_torch.native`, built by ``g++`` on first
use) and the FDSN client (:mod:`.fdsn`) they import, so SDS archives in
miniSEED and HDF5 both read. :mod:`.compile` is the port's own: the
preprocess chains of the device engine as PyTorch functions.
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
