r"""
:mod:`parallel.batch` -- Sharded batch correlation
==================================================

Counterpart of ``xcorr_tpu/parallel/batch.py``: one correlation of a
dense ``(batch, n)`` block split over a mesh. Each mesh entry correlates
its contiguous rows on its own device (:func:`..ops.cc.correlate`: at day
scale on a card, the four-step route with one kernel launch per entry);
the entries' results are gathered into one host array. No collectives:
the workload is a pure map (SURVEY.md §2.8 P1). The production
multi-device path is :class:`.pipeline.MultiSpanPipeline` (the same split
plus on-device windowing and preprocess chains); this covers the
"correlate this block over the mesh" case.
"""

from __future__ import annotations

import torch

from ..ops.cc import correlate
from .mesh import make_mesh, split
from .pipeline import Readback

__all__ = ["sharded_correlate"]


def sharded_correlate(x, y, mesh=None, index_min: int = None,
                      index_max: int = None, normalize: bool = True,
                      unbiased: bool = False):
    """Correlate a ``(batch, n)`` block split over the mesh's entries;
    returns the ``(batch, nlag)`` host array.

    ``x``, ``y``: host arrays or tensors (a tensor already on an entry's
    device is not copied for it). Each entry takes its contiguous share
    of the rows (:func:`.mesh.split`); every entry's correlation is
    queued before the first result is read back. The JAX package pads
    the batch to a multiple of the mesh size so that one executable
    serves every shard; eager PyTorch needs no pad, and the shares differ
    by at most one row. ``mesh`` defaults to every visible card; an
    empty batch raises.
    """
    mesh = mesh or make_mesh()
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    if x.shape != y.shape or x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "be one (batch, n) shape")
    n0 = x.shape[0]
    if n0 == 0:
        raise ValueError("sharded_correlate: empty batch")
    return Readback([
        correlate(x[a:b].to(device, non_blocking=True),
                  y[a:b].to(device, non_blocking=True),
                  normalize=normalize, index_min=index_min,
                  index_max=index_max, unbiased=unbiased)
        for device, a, b in split(mesh, n0)]).wait()
