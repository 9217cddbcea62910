r"""
:mod:`xcorr_tpu_torch.parallel` -- Devices, meshes and processes
================================================================

Port of :mod:`xcorr_tpu.parallel`: the device engine (raw spans shipped
once, windows cut, preprocessed and correlated on the device, many
pair-days per launch: :func:`device_process_bulk`), the mesh that splits
a batch over torch devices (:func:`make_mesh`, :func:`sharded_correlate`,
``mesh=`` of the engine) and the multi-process campaign
(:func:`initialize`, :func:`host_slice`) that replaces the JAX package's
``jax.distributed`` formation with a ``torch.distributed`` group.
"""

from .mesh import make_mesh, batch_sharding
from .batch import sharded_correlate
from .distributed import initialize, host_slice
from .pipeline import FusedPipeline, MultiSpanPipeline
from .engine import device_process, device_process_bulk

__all__ = ["make_mesh", "batch_sharding", "sharded_correlate",
           "initialize", "host_slice", "FusedPipeline",
           "MultiSpanPipeline", "device_process", "device_process_bulk"]
