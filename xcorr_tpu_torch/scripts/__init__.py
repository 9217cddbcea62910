r"""
:mod:`xcorr_tpu_torch.scripts` -- CLI entry points
==================================================

The console scripts of the port: ``xcorr-torch-cc`` (:mod:`.cc`, the
batch CCF production run of ``xcorr-cc``) and the first analysis scripts,
``xcorr-torch-snr`` (:mod:`.snr`), ``xcorr-torch-ct`` (:mod:`.ct`) and
``xcorr-torch-psd`` (:mod:`.psd`). The beamform, plmax, swresp and
timelapse scripts come with their slices.
"""

from . import utils  # noqa: F401

__all__ = ["utils"]
