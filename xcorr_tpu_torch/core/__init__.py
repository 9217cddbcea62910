r"""
:mod:`xcorr_tpu_torch.core` -- Core dataset engine
==================================================

CCF dataset construction (:func:`init`, carried) and batched correlation
on a torch device (:func:`process`). :mod:`.lazy` (the pair-day batch
runner) is imported on use: it writes shards, which needs h5py.
"""

from .init import init
from .process import process

__all__ = ["init", "process"]
