r"""
:mod:`xcorr_tpu_torch.parallel` -- The device engine
====================================================

Port of :mod:`xcorr_tpu.parallel`'s device engine: raw spans shipped once,
windows cut, preprocessed and correlated on one torch device, many
pair-days per launch (:func:`device_process_bulk`). The mesh, batch and
multi-host modules come with the multi-GPU slice.
"""

from .pipeline import FusedPipeline, MultiSpanPipeline
from .engine import device_process, device_process_bulk

__all__ = ["FusedPipeline", "MultiSpanPipeline", "device_process",
           "device_process_bulk"]
