r"""
:mod:`xcorr_tpu_torch.core` -- Core dataset engine
==================================================

CCF dataset construction (:func:`init`, carried), batched correlation
on a torch device (:func:`process`), the postprocess chain
(:func:`postprocess`, on a torch device) and merging (:func:`merge`,
carried). :mod:`.lazy` (the pair-day batch runner) is imported on use: it
writes shards, which needs h5py.
"""

from .init import init
from .process import process
from .postprocess import postprocess
from .merge import merge

__all__ = ["init", "process", "postprocess", "merge"]
