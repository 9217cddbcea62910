r"""
xcorr-tpu, PyTorch port
=======================

The CCF production path of :mod:`xcorr_tpu` in PyTorch, with the kernels
of the four-step correlation written by hand in CUDA for NVIDIA Hopper,
and its analysis tier (``postprocess``, ``merge``, the ops of
:mod:`.signal`, the ``ds.xcorr`` accessor and the plots).
It imports ``torch`` and never ``jax``; the JAX package stays the
reference.

The facade mirrors :mod:`xcorr_tpu`'s: ``init`` -> ``process(ds, client,
device='cuda')`` -> ``write`` / ``read``; ``lazy_process`` with the host
engine or ``engine='device'``; the device engine, meshes and
multi-process campaigns in :mod:`.parallel`; ``postprocess(ds,
device='cuda')``, ``merge`` and
``plot``. The shard I/O (``io``, ``read``, ``write``,
``lazy_process``) needs h5py and is imported on first use, so a machine
without h5py can still initialize, correlate and postprocess datasets.
"""

__version__ = "0.1.0"

import importlib

from . import ndlabel  # noqa: F401
from . import util  # noqa: F401
from . import ops  # noqa: F401
from . import stream  # noqa: F401
from . import signal  # noqa: F401
from . import core  # noqa: F401
from . import parallel  # noqa: F401

from .core import init, process, postprocess, merge, plot
from .stream import Client, SyntheticClient, Inventory

# name -> (module, attribute or None for the module itself)
_LAZY = {
    "io": (".io", None),
    "read": (".io", "read"),
    "write": (".io", "write"),
    "mfread": (".io", "mfread"),
    "validate": (".io", "validate"),
    "validate_list": (".io", "validate_list"),
    "ncfile": (".io", "ncfile"),
    "lazy_process": (".core.lazy", "lazy_process"),
    "lazy_processes": (".core.lazy", "lazy_processes"),
}

__all__ = ["ndlabel", "util", "ops", "stream", "signal", "core",
           "parallel", "init",
           "process", "postprocess", "merge", "plot", "Client",
           "SyntheticClient", "Inventory", "__version__", *_LAZY]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(module, __name__)
    return mod if attr is None else getattr(mod, attr)
