r"""
:mod:`xcorr_tpu_torch.signal` -- Labelled signal operations
===========================================================

Only the bias correction ``core.process`` applies for
``unbiased_cc=True`` datasets, carried from :mod:`xcorr_tpu.signal`.
"""

from .unbias import unbias, unbias_weights

__all__ = ["unbias", "unbias_weights"]
