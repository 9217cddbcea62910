r"""
:mod:`ops.consts` -- Host constants and their device copies
===========================================================

The preprocess chains (:mod:`..stream.compile`, :mod:`.filter`) design
their constants on the host in float64 (taper windows, filter plans,
inverse responses, resampling positions) and use them on the device of
each call. :class:`HostConst` keeps one copy per (device, dtype), made on
first use, so a chain that runs once per launch ships its constants once.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["HostConst", "complex_of"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def complex_of(dtype):
    """The complex dtype whose parts are ``dtype``."""
    return _COMPLEX[dtype]


class HostConst:
    """A host numpy array and its device copies. :meth:`like` returns it
    in the dtype of a real tensor (its complex counterpart for a complex
    array), on that tensor's device."""

    def __init__(self, array):
        self.host = np.asarray(array)
        self._dev = {}
        self._lock = threading.Lock()

    def on(self, device, dtype):
        """The array as ``dtype`` on ``device``."""
        key = (str(device), dtype)
        with self._lock:
            t = self._dev.get(key)
            if t is None:
                t = self._dev[key] = torch.as_tensor(
                    self.host, dtype=dtype).to(device)
        return t

    def like(self, x):
        """The array in ``x``'s dtype (complex for a complex array), on
        ``x``'s device."""
        return self.on(x.device, complex_of(x.dtype)
                       if np.iscomplexobj(self.host) else x.dtype)
