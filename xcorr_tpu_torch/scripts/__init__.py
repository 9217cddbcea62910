r"""
:mod:`xcorr_tpu_torch.scripts` -- CLI entry points
==================================================

The console scripts of the port: ``xcorr-torch-cc`` (:mod:`.cc`, the
batch CCF production run of ``xcorr-cc``) and the seven analysis
scripts, ``xcorr-torch-snr`` (:mod:`.snr`), ``-ct`` (:mod:`.ct`),
``-psd`` (:mod:`.psd`), ``-beamform`` (:mod:`.beamform`), ``-plmax``
(:mod:`.plmax`), ``-swresp`` (:mod:`.swresp`) and ``-timelapse``
(:mod:`.timelapse`).
"""

from . import utils  # noqa: F401

__all__ = ["utils"]
