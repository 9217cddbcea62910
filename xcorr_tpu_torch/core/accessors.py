# Carried from xcorr_tpu/core/accessors.py (see test_torch_host_copies).
r"""
:mod:`core.accessors` -- ``ds.xcorr`` Dataset accessor
======================================================

Dataset-level convenience API (spec: ``xcorr/core/accessors.py:29-139``):
``ds.xcorr.process/postprocess/merge/write/plot_ccf(s)/hash/...``.
Registered at import on :class:`xcorr_tpu.ndlabel.Dataset`.
"""

from __future__ import annotations

from .. import util
from ..ndlabel import Dataset

__all__ = ["XcorrAccessor"]


class XcorrAccessor:
    """``ds.xcorr.*`` convenience methods."""

    def __init__(self, ds):
        self._ds = ds

    @property
    def version(self):
        return self._ds.attrs.get("xcorr_version", "n/a")

    @property
    def dependencies_version(self):
        return self._ds.attrs.get("dependencies_version", "n/a")

    def process(self, *args, **kwargs):
        from .process import process
        return process(self._ds, *args, **kwargs)

    def postprocess(self, *args, **kwargs):
        from .postprocess import postprocess
        return postprocess(self._ds, *args, **kwargs)

    def merge(self, *others, **kwargs):
        from .merge import merge
        return merge([self._ds, *others], **kwargs)

    def write(self, path, **kwargs):
        from ..io.write import write
        return write(self._ds, path, **kwargs)

    def hash(self, metadata_only: bool = False, **kwargs):
        return util.hasher.hash_Dataset(self._ds,
                                        metadata_only=metadata_only,
                                        **kwargs)

    def hash_metadata(self, **kwargs):
        return util.hasher.hash_Dataset(self._ds, metadata_only=True,
                                        **kwargs)

    def plot_ccf(self, *args, **kwargs):
        from .plot import plot_ccf
        return plot_ccf(self._ds, *args, **kwargs)

    def plot_ccfs(self, *args, **kwargs):
        from .plot import plot_ccfs
        return plot_ccfs(self._ds, *args, **kwargs)

    def plot_ccfs_colored(self, *args, **kwargs):
        from .plot import plot_ccfs_colored
        return plot_ccfs_colored(self._ds, *args, **kwargs)

    def plot_snr_ct(self, *args, **kwargs):
        from .plot import plot_snr_ct
        obj = self._ds
        if hasattr(obj, "data_vars") and "snr" in obj.data_vars:
            obj = obj["snr"]
        return plot_snr_ct(obj, *args, **kwargs)


def _xcorr(self):
    return XcorrAccessor(self)


Dataset.xcorr = property(_xcorr)
