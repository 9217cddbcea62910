# Carried from xcorr_tpu/signal/absolute.py (see test_torch_host_copies).
r"""
:mod:`signal.absolute` -- Absolute value
========================================

Elementwise magnitude with complex->float dtype mapping
(spec: ``xcorr/signal/absolute.py:28-94``).
"""

from __future__ import annotations

import numpy as np

from ..util.history import historicize

__all__ = ["absolute", "abs"]


def absolute(x):
    """|x| with complex dtypes mapped to their real counterpart."""
    data = np.abs(x.data)
    y = x.copy(deep=False, data=data)
    if np.iscomplexobj(x.data):
        y.data = data.astype(np.float64 if x.dtype == np.complex128
                             else np.float32)
    if "long_name" in y.attrs:
        y.attrs["long_name"] = "Absolute " + y.attrs["long_name"]
    if "standard_name" in y.attrs:
        y.attrs["standard_name"] = "absolute_" + y.attrs["standard_name"]
    historicize(y, f="absolute", a={"x": x.name})
    return y


abs = absolute  # noqa: A001
