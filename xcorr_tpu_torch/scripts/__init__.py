r"""
:mod:`xcorr_tpu_torch.scripts` -- CLI entry points
==================================================

The console scripts of the port: ``xcorr-torch-cc`` (:mod:`.cc`, the
batch CCF production run of ``xcorr-cc``). The analysis scripts come with
the analysis slice.
"""

from . import utils  # noqa: F401

__all__ = ["utils"]
