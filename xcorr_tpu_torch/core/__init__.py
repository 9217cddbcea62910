r"""
:mod:`xcorr_tpu_torch.core` -- Core dataset engine
==================================================

CCF dataset construction (:func:`init`, carried), batched correlation
on a torch device (:func:`process`), the postprocess chain
(:func:`postprocess`, on a torch device), merging (:func:`merge`,
carried), the ``ds.xcorr`` accessor and the plots (:mod:`.plot`; both
carried, matplotlib imported on use). :mod:`.lazy` (the pair-day batch
runner) is imported on use.
"""

from .init import init
from .process import process
from .postprocess import postprocess
from .merge import merge
from . import accessors  # noqa: F401  (registers ds.xcorr)
from . import plot

__all__ = ["init", "process", "postprocess", "merge", "plot"]
