r"""
:mod:`parallel.pipeline` -- Preprocess-and-correlate pipelines
==============================================================

The device side of the device engine (port of
``xcorr_tpu/parallel/pipeline.py``): raw day spans -> per-channel
preprocess chains (:func:`..stream.compile.compile_operations`) ->
batched correlation (:func:`..ops.cc.correlate`), on one torch device
or split over a mesh (:mod:`.mesh`).

:class:`MultiSpanPipeline` takes each receiver's raw span ONCE and cuts
the overlapping windows out of it on the device, at runtime ``(src,
offset)`` pairs; at the production 87.5% window overlap that ships every
raw sample once instead of 8 times. :class:`FusedPipeline` takes the
windows themselves.

Differences from the JAX package, none of them in the result:

* offsets are runtime arguments of :meth:`MultiSpanPipeline.launch`. The
  JAX package baked them into its executable as static slices and split
  the step into three executables, both constraints of its compiler;
* a window start past the span's end is clamped to the last full window,
  as ``jax.lax.dynamic_slice_in_dim`` clamps it (the engine never asks
  for one);
* the chains run on :data:`CHAIN_ROWS` windows at a time, each block
  written into the zero-padded stage-A stack that the correlation takes
  (``pre_padded_n``): eager PyTorch materializes every intermediate of a
  chain, so the block bounds the chains' working memory at day scale;
* the result comes back through :class:`Readback`: pinned host memory,
  ``non_blocking`` row-chunk copies on a side stream of the result's
  device;
* with ``mesh=``, each entry cuts, preprocesses and correlates its
  contiguous share of the windows on its own device, the spans
  replicated to every entry as the JAX package replicates them. No
  window is added: the JAX package padded the batch to a mesh multiple
  (``pad_nwin``) so that its executables were reused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cc import correlate, preferred_padded_len
from ..stream.compile import compile_operations
from .mesh import split

__all__ = ["FusedPipeline", "MultiSpanPipeline", "Readback", "CHAIN_ROWS"]

#: windows a chain runs on at once (at 250 Hz a raw day window is 95 MB
#: of float32, and a chain's intermediates several times that)
CHAIN_ROWS = 8
#: rows per device->host copy of a result
READBACK_ROWS = 8


def _chains(ops_a, ops_b, npts_raw_a, fs_a, npts_raw_b, fs_b, npts,
            response_a, response_b, trim_offset):
    chain_a, n_a, fs_out_a = compile_operations(
        ops_a, npts_raw_a, fs_a, response=response_a, trim_to=npts,
        trim_offset=trim_offset)
    chain_b, n_b, fs_out_b = compile_operations(
        ops_b, npts_raw_b, fs_b, response=response_b, trim_to=npts,
        trim_offset=trim_offset)
    if abs(fs_out_a - fs_out_b) > 1e-9:
        raise ValueError(
            f"chains produce different rates: {fs_out_a} vs {fs_out_b}")
    if n_a < npts or n_b < npts:
        raise ValueError(
            f"chains produce too few samples ({n_a}, {n_b}) for "
            f"npts={npts}")
    return chain_a, chain_b, fs_out_a


class FusedPipeline:
    """Preprocess both channels of ``(B, npts_raw)`` window blocks and
    correlate them.

    Parameters
    ----------
    ops_a, ops_b : the two receivers' DSL operation lists
    npts_raw_a, npts_raw_b : raw input block lengths (buffered windows)
    fs_a, fs_b : raw input sampling rates
    npts : correlation window length after preprocessing (samples)
    index_min, index_max : clipped lag window
    response_a, response_b : optional PAZ responses
    device : the torch device the work runs on
    """

    def __init__(self, ops_a, ops_b, npts_raw_a, fs_a, npts_raw_b, fs_b,
                 npts, index_min=None, index_max=None, normalize=True,
                 response_a=None, response_b=None, trim_offset=0,
                 device="cuda"):
        self._chain_a, self._chain_b, self.sampling_rate = _chains(
            ops_a, ops_b, npts_raw_a, fs_a, npts_raw_b, fs_b, npts,
            response_a, response_b, trim_offset)
        self.npts = npts
        self.index_min = index_min
        self.index_max = index_max
        self._normalize = normalize
        self.device = torch.device(device)

    def __call__(self, x_raw, y_raw):
        """(B, npts_raw_a), (B, npts_raw_b) float32 -> (B, nlag) float32
        host array."""
        x = torch.as_tensor(x_raw).to(self.device)
        y = torch.as_tensor(y_raw).to(self.device)
        out = correlate(self._chain_a(x)[..., :self.npts],
                        self._chain_b(y)[..., :self.npts],
                        normalize=self._normalize,
                        index_min=self.index_min, index_max=self.index_max)
        return out.cpu().numpy()


def _windows(raw, offsets, npts_raw):
    """Stack ``npts_raw`` samples of span row ``src`` from ``off`` for
    each ``(src, off)``; a start outside ``[0, span - npts_raw]`` is
    clamped into it."""
    top = raw.shape[-1] - npts_raw
    if top < 0:
        raise ValueError(f"span of {raw.shape[-1]} samples is shorter "
                         f"than a window of {npts_raw}")
    return torch.stack([raw[s].narrow(0, min(max(o, 0), top), npts_raw)
                        for s, o in offsets])


class MultiSpanPipeline:
    """Windowed correlation over a batch of raw spans: each receiver-day
    span goes to the device once and the (overlapping) windows are cut
    out there.

    :meth:`launch` takes ``(nsrc, span)`` stacks of spans and, per side,
    a sequence of ``(src, sample_off)``: window ``k`` is the
    ``npts_raw`` samples from ``sample_off`` of span row ``src``. Many
    (pair, day) tasks with a common chain and geometry share one launch.
    Where the four-step path engages, the preprocessed windows are
    written zero-extended to its stage-A length
    (:func:`..ops.cc.preferred_padded_len`).

    ``mesh`` (a :class:`.mesh.Mesh`, in place of ``device``): the windows
    split into contiguous shares (:func:`.mesh.split`), one per mesh
    entry, each run on the entry's device.
    """

    def __init__(self, ops_a, ops_b, npts_raw_a, fs_a, npts_raw_b, fs_b,
                 npts, index_min=None, index_max=None, normalize=True,
                 response_a=None, response_b=None, trim_offset=0,
                 device="cuda", mesh=None):
        self._chain_a, self._chain_b, self.sampling_rate = _chains(
            ops_a, ops_b, npts_raw_a, fs_a, npts_raw_b, fs_b, npts,
            response_a, response_b, trim_offset)
        self.npts = int(npts)
        self.npts_raw_a = int(npts_raw_a)
        self.npts_raw_b = int(npts_raw_b)
        self.index_min = index_min
        self.index_max = index_max
        self._normalize = normalize
        self.mesh = mesh
        #: the devices the windows split over, in window order
        self.devices = mesh.devices if mesh is not None \
            else (torch.device(device),)

    def _launch_on(self, device, raw_a, raw_b, offsets_a, offsets_b):
        """Cut, preprocess and correlate ``offsets_*`` on ``device``."""
        raw_a = _on(raw_a, device)
        raw_b = _on(raw_b, device)
        plen = preferred_padded_len(self.npts, device)
        nwin = len(offsets_a)
        width = plen or self.npts
        xa = torch.zeros((nwin, width), dtype=raw_a.dtype, device=device)
        yb = torch.zeros((nwin, width), dtype=raw_b.dtype, device=device)
        for r in range(0, nwin, CHAIN_ROWS):
            rows = slice(r, r + CHAIN_ROWS)
            xa[rows, :self.npts] = self._chain_a(_windows(
                raw_a, offsets_a[rows], self.npts_raw_a))
            yb[rows, :self.npts] = self._chain_b(_windows(
                raw_b, offsets_b[rows], self.npts_raw_b))
        return correlate(xa, yb, normalize=self._normalize,
                         index_min=self.index_min, index_max=self.index_max,
                         pre_padded_n=self.npts if plen else None)

    def launch(self, raw_a, raw_b, offsets_a, offsets_b):
        """Queue the work on the device(s); returns the ``(rows, nlag)``
        device tensors of the entries that took windows, in window order
        (one without a mesh). ``raw_a``: ``(nsrc_a, span_a)``, ``raw_b``:
        ``(nsrc_b, span_b)`` float32: host arrays, tensors, or dicts of
        tensors by device (a stack already replicated to each device)."""
        if len(offsets_a) != len(offsets_b):
            raise ValueError("offsets_a and offsets_b lengths differ")
        nwin = len(offsets_a)
        parts = [(self.devices[0], 0, nwin)] if self.mesh is None else \
            split(self.mesh, nwin)
        return [self._launch_on(device, raw_a, raw_b, offsets_a[a:b],
                                offsets_b[a:b])
                for device, a, b in parts]

    def __call__(self, raw_a, raw_b, offsets_a, offsets_b):
        """:meth:`launch`, then the result as a host array."""
        return Readback(self.launch(raw_a, raw_b, offsets_a,
                                    offsets_b)).wait()


def _on(raw, device):
    """A span stack as a tensor on ``device``."""
    if isinstance(raw, dict):
        return raw[device]
    return torch.as_tensor(raw).to(device)


class Readback:
    """The device -> host copy of a ``(rows, n)`` result, or of the row
    shards of one (a list, in row order), started at once: on a CUDA
    device, row chunks of :data:`READBACK_ROWS` go into pinned host
    memory with ``non_blocking`` copies on a side stream of the shard's
    own device, so they overlap the host work that follows; a CPU result
    is the host array already. :meth:`wait` hands each landed chunk
    on."""

    def __init__(self, result):
        shards = [result] if torch.is_tensor(result) else list(result)
        self.rows = sum(r.shape[0] for r in shards)
        self._events = []
        self._shards = None
        if all(r.device.type != "cuda" for r in shards):
            self.host = shards[0].numpy() if len(shards) == 1 else \
                torch.cat(shards).numpy()
            return
        host = torch.empty((self.rows,) + tuple(shards[0].shape[1:]),
                           dtype=shards[0].dtype, pin_memory=True)
        r0 = 0
        for shard in shards:
            r1 = r0 + shard.shape[0]
            if shard.device.type != "cuda":
                host[r0:r1].copy_(shard)
                self._events.append((r1, None))
            else:
                self._copy(shard, host[r0:r1], r0)
            r0 = r1
        self._shards = shards   # alive until the copies have landed
        self.host = host.numpy()

    def _copy(self, shard, host, r0):
        with torch.cuda.device(shard.device):
            stream = torch.cuda.Stream(device=shard.device)
            stream.wait_stream(torch.cuda.current_stream(shard.device))
            with torch.cuda.stream(stream):
                for c0 in range(0, shard.shape[0], READBACK_ROWS):
                    c1 = min(shard.shape[0], c0 + READBACK_ROWS)
                    host[c0:c1].copy_(shard[c0:c1], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    self._events.append((r0 + c1, ev))

    def wait(self, row_done=None) -> np.ndarray:
        """Block until every row has landed; ``row_done(host, nrows)``
        is called as each chunk lands, with the first ``nrows`` rows of
        ``host`` complete. Returns the host array."""
        if not self._events:
            if row_done is not None:
                row_done(self.host, self.rows)
            return self.host
        for r1, ev in self._events:
            if ev is not None:
                ev.synchronize()
            if row_done is not None:
                row_done(self.host, r1)
        self._shards = None
        return self.host
