# Carried from xcorr_tpu/native/__init__.py (see test_torch_host_copies).
r"""
:mod:`xcorr_tpu.native` -- Native (C++) components
==================================================

The framework's native runtime pieces: the miniSEED data-plane codec
(``mseed.cpp``, built as ``libxcmseed.so`` and bound via ctypes). The
reference delegated this layer to obspy's libmseed; here it is first-party.
"""

from . import mseed

__all__ = ["mseed"]
