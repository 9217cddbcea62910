# Carried from xcorr_tpu/util/history.py (see test_torch_host_copies).
r"""
:mod:`util.history` -- Provenance history
=========================================

Append operation provenance to ``attrs['history']``
(reference: ``xcorr/util/history.py:25-55``): every signal op logs
``"xcorr_tpu-{version}: f({json args})"`` so the lineage travels with the
data.
"""

from __future__ import annotations

import json

__all__ = ["historicize"]


def _serializable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def historicize(x, f: str, a: dict = None):
    """Append ``f(args)`` provenance to ``x.attrs['history']`` in place."""
    from .. import __version__
    a = a or {}
    args = json.dumps({k: _serializable(v) for k, v in a.items()
                       if v is not None})
    entry = f"xcorr_tpu-{__version__}: {f}({args})"
    if "history" in x.attrs and x.attrs["history"]:
        x.attrs["history"] += f", {entry}"
    else:
        x.attrs["history"] = entry
