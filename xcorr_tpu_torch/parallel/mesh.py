r"""
:mod:`parallel.mesh` -- Device meshes
=====================================

Counterpart of ``xcorr_tpu/parallel/mesh.py``. The workload is
embarrassingly parallel over (pair x window) items (SURVEY.md §2.8 P1), so
a mesh is an ordered list of torch devices, each taking a contiguous share
of a batch's rows; there is no sharding annotation to compile against.

The four-step's sequence-parallel plan (``ops.fft4``, ``mesh=``) splits
over two named axes at once (:func:`split2`): windows over one, the k1
rows of each window's spectrum over the other.

A mesh may name a device more than once (``make_mesh(devices=["cpu"] *
4)``, or ``["cuda:0", "cuda:0"]`` on one card): such a *logical* mesh
runs the split, the per-entry launches and the gather as a mesh of
distinct cards would, one entry after the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "batch_sharding", "split", "split2",
           "pad_to_multiple", "mesh_fingerprint"]


class Mesh:
    """An ordered tuple of ``torch.device`` entries, with axis names and a
    shape whose product is the number of entries."""

    def __init__(self, devices, axis_names=("batch",), shape=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if shape is None:
            if len(self.axis_names) != 1:
                raise ValueError("shape required for multi-axis meshes")
            shape = (len(self.devices),)
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"shape {self.shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape})")


def make_mesh(n_devices: int = None, axis_names=("batch",), shape=None,
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` visible CUDA devices (all of
    them by default), or over ``devices`` (names or ``torch.device``\\ s,
    repeats allowed; the first ``n_devices`` of them when both are given).
    Raises when torch sees no card, when a CUDA entry names a card that is
    not there, or when fewer devices exist than asked for."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch sees no CUDA device; pass devices= "
                "(e.g. ['cpu'] * n) for a host mesh")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{count} CUDA devices visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        n = len(devices) if n_devices is None else int(n_devices)
        if not 1 <= n <= len(devices):
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n]
        for d in devices:
            if d.type != "cuda":
                continue
            if not torch.cuda.is_available():
                raise RuntimeError(f"make_mesh: {d} but torch sees no "
                                   "CUDA device")
            if (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"make_mesh: {d} but only "
                                 f"{torch.cuda.device_count()} CUDA "
                                 "devices are visible")
    return Mesh(devices, axis_names, shape)


def _shares(parts: int, rows: int):
    bounds = np.linspace(0, int(rows), parts + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def batch_sharding(mesh: Mesh, rows: int):
    """The contiguous ``(start, stop)`` row range of each mesh entry for a
    batch of ``rows``, divided as
    :func:`..parallel.distributed.host_slice` divides a work list
    (``np.linspace`` bounds: the shares differ by at most one row)."""
    return _shares(mesh.size, rows)


def split(mesh: Mesh, rows: int):
    """``(device, start, stop)`` of each mesh entry that takes rows of a
    batch of ``rows``, in row order: the shares of
    :func:`batch_sharding`, without the entries whose share is empty.
    Results gathered in this order are in row order."""
    return [(d, a, b) for d, (a, b) in zip(mesh.devices,
                                           batch_sharding(mesh, rows))
            if a < b]


def split2(mesh: Mesh, rows: int, cols: int, axes=("batch", "seq")):
    """Split ``rows`` over the mesh axis ``axes[0]`` and ``cols`` over
    ``axes[1]``, with :func:`batch_sharding`'s shares on each: a list, in
    row order, of ``(start, stop, entries)`` for each non-empty row share,
    ``entries`` the ``(device, col_start, col_stop)`` of its non-empty
    column shares in column order. An axis name the mesh lacks, or None,
    splits nothing; the mesh's other axes take their first index."""
    names = mesh.axis_names
    row_ax, col_ax = (a if a in names else None for a in axes)
    grid = np.empty(mesh.size, dtype=object)
    for k, d in enumerate(mesh.devices):
        grid[k] = d
    grid = grid.reshape(mesh.shape)

    def parts(ax):
        return mesh.shape[names.index(ax)] if ax is not None else 1

    def device(i, j):
        return grid[tuple(i if a == row_ax else j if a == col_ax else 0
                          for a in names)]

    return [(a, b, [(device(i, j), c, d)
                    for j, (c, d) in enumerate(_shares(parts(col_ax), cols))
                    if c < d])
            for i, (a, b) in enumerate(_shares(parts(row_ax), rows)) if a < b]


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros so its ``axis`` size divides ``multiple``;
    returns (padded, original_size)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths), n


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh for cache keys: its devices and axis
    layout (``None`` for no mesh)."""
    if mesh is None:
        return None
    return (mesh.axis_names, mesh.shape, tuple(str(d) for d in mesh.devices))
