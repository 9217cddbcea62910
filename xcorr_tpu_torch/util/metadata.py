# Carried from xcorr_tpu/util/metadata.py (see test_torch_host_copies).
r"""
:mod:`util.metadata` -- CF global attributes
============================================

COARDS/CF-1.9 global attribute factory and dependency versions
(reference: ``xcorr/util/metadata.py:26-77``).
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import scipy

__all__ = ["global_attrs", "list_versions", "version"]


def _version():
    from .. import __version__
    return __version__


def __getattr__(name):
    # lazy module attribute (PEP 562): avoids a circular import at load
    if name == "version":
        return _version()
    raise AttributeError(name)


def _h5py_version():
    """h5py writes the shards; a machine without it still correlates."""
    import importlib.util
    if importlib.util.find_spec("h5py") is None:
        return "not installed"
    import h5py
    return h5py.__version__


def list_versions(as_str: bool = True):
    """Core dependency versions, as string or dict."""
    import torch
    versions = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "json": json.__version__,
        "numpy": np.__version__,
        "pandas": pd.__version__,
        "scipy": scipy.__version__,
        "h5py": _h5py_version(),
    }
    if as_str:
        return ", ".join("-".join(item) for item in versions.items())
    return versions


def global_attrs(kwargs: dict, cf_only: bool = True):
    """COARDS/CF-1.9 global attribute dictionary."""
    attrs = {
        "title": kwargs.pop("title", ""),
        "institution": kwargs.pop("institution", "n/a"),
        "author": kwargs.pop("author", "n/a"),
        "source": kwargs.pop("source", "n/a"),
        "references": kwargs.pop("references", "n/a"),
        "comment": kwargs.pop("comment", "n/a"),
        "history": "Created @ {}".format(pd.to_datetime("now")),
        "Conventions": "CF-1.9",
        "xcorr_version": _version(),
        "dependencies_version": list_versions(as_str=True),
    }
    return attrs if cf_only else {**kwargs, **attrs}
