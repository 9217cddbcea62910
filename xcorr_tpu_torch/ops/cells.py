r"""
:mod:`ops.cells` -- The timelapse's cell kernels (TL1, TL2)
===========================================================

The two hand-written CUDA kernels (``csrc/cells.cu``, built at first use
by :mod:`ops._build`) around the inverse transform of a batch of the
timelapse's 2-D correlation cells
(:func:`..scripts.timelapse.correlate_spectrograms`). They replace no
Pallas kernel: the JAX package fuses a batch of cells into one XLA
executable (``xcorr_tpu/scripts/timelapse.py``, ``_corr_step``), and
these are the passes of the port's form of that step that a library
call does not do in one.

* **TL1** :func:`gather_product` (``xc_gather_product``): the conjugate
  products of the cells' cached spectra, gathered by index::

      P[c] = a[ii[c]] · conj(b[jj[c]])

* **TL2** :func:`circular_argmax` (``xc_circular_argmax``): each cell's
  peak and flat argmax over the fftshifted window of its circular
  correlation map, read in place (rows ``(i - (n1-1)) mod nf``, columns
  ``(j - (n2-1)) mod nl``, as :func:`.cc.lag_slice_of_circular` defines
  them), with ``torch.argmax``'s rule: the first maximal element of the
  fftshifted order, a NaN above every number.

Each has a plain PyTorch version (``*_plain``): a wrapper takes it for
CPU tensors only, launches the kernel (or raises) for CUDA tensors, on
the tensors' card, and adds one to ``launches[name]`` per call that
launches it. TL2 is one kernel in two launches (``circular_argmax_part``
over the segments of each cell's window, ``circular_argmax_join`` over
each cell's segments), counted once per call: a count of ``n`` is ``n``
calls and ``2 n`` CUDA launches.
"""

from __future__ import annotations

import torch

from .cc import lag_slice_of_circular
from .fused_fft import _device_of, _launch, _lock, _ptrs, _stream

__all__ = ["gather_product", "gather_product_plain", "circular_argmax",
           "circular_argmax_plain", "KERNELS", "launches", "reset_launches"]

#: kernel names, as ``launches`` counts them
KERNELS = ("gather_product", "circular_argmax")

#: kernel calls made by the wrappers in this process, by kernel name: one
#: per launch of TL1, one per call of TL2's two launches
launches = dict.fromkeys(KERNELS, 0)

#: TL2's blocks per SM that the segments of a batch aim for
_BLOCKS_PER_SM = 4

_sms = {}


def reset_launches():
    """Set every launch count to 0."""
    with _lock:
        for k in KERNELS:
            launches[k] = 0


def gather_product_plain(a, ii, b, jj):
    """``a[ii] · conj(b[jj])``: TL1's function in PyTorch."""
    return a[ii] * torch.conj(b[jj])


def circular_argmax_plain(r, n1: int, n2: int):
    """The peak and flat argmax of each map of ``r`` over its fftshifted
    ``(2·n1-1, 2·n2-1)`` window, by slicing it out and ``torch.argmax``:
    TL2's function in PyTorch."""
    nf, nl = r.shape[-2:]
    r = lag_slice_of_circular(r.movedim(-2, -1), n1, nf, 0,
                              2 * n1 - 1).movedim(-1, -2)
    r = lag_slice_of_circular(r, n2, nl, 0, 2 * n2 - 1)
    flat = r.reshape(r.shape[0], -1)
    k = torch.argmax(flat, dim=-1)
    return torch.gather(flat, -1, k[:, None])[:, 0], k


def _check_index(name, idx, ref, n, count):
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int64 tensor, got "
                        f"{idx.dtype} of {tuple(idx.shape)}")
    if idx.shape[0] != n:
        raise ValueError(f"{name} has {idx.shape[0]} cells, not {n}")
    if idx.device != ref.device:
        raise ValueError(f"{name} is on {idx.device}, not {ref.device}")
    if not idx.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ref.device.type == "cpu" and n and (
            int(idx.min()) < 0 or int(idx.max()) >= count):
        raise IndexError(f"{name} out of range for {count} spectra")


def gather_product(a, ii, b, jj):
    """TL1: ``a[ii] · conj(b[jj])``, ``(B, nf, h)`` complex64, from the
    spectra ``a`` and ``b`` (``(Ta, nf, h)`` and ``(Tb, nf, h)``) and the
    cells' indices ``ii``, ``jj`` (``(B,)`` int64, in range: the kernel
    does not check them)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[1:] != b.shape[1:]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be spectra (T, nf, h) of one (nf, h)")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a ({a.dtype} on {a.device}) and b ({b.dtype} "
                         f"on {b.device}) differ")
    n = ii.shape[0] if ii.dim() == 1 else -1
    _check_index("ii", ii, a, n, a.shape[0])
    _check_index("jj", jj, a, n, b.shape[0])
    if _device_of(a, "gather_product") == "cpu":
        return gather_product_plain(a, ii, b, jj)
    if a.dtype != torch.complex64:
        raise TypeError(f"gather_product takes complex64, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    M = a.shape[1] * a.shape[2]
    if n < 1 or M < 1 or M >= 1 << 31:
        raise ValueError(f"{n} cells of {M} values: gather_product takes "
                         "at least one of each, and under 2**31 values")
    out = torch.empty((n, *a.shape[1:]), dtype=a.dtype, device=a.device)
    from ._build import load
    _launch("gather_product", a.device, load().xc_gather_product,
            *_ptrs(a, b, ii, jj, out), n, M, _stream(a), counts=launches)
    return out


def _segments(device, B: int, rows: int) -> int:
    """TL2's segments per cell: about ``_BLOCKS_PER_SM`` blocks per SM
    over the batch, at most one per row."""
    with _lock:
        sms = _sms.get(device)
        if sms is None:
            sms = _sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
    return max(1, min(rows, -(-_BLOCKS_PER_SM * sms // B)))


def circular_argmax(r, n1: int, n2: int):
    """TL2: ``(peak, k)`` of each map of ``r`` (``(B, nf, nl)``) over its
    fftshifted ``(2·n1-1, 2·n2-1)`` window: ``peak`` (``(B,)``, ``r``'s
    dtype) and ``k`` (``(B,)`` int64) the flat index in that window's
    row-major order, as :func:`circular_argmax_plain` returns them."""
    if r.dim() != 3:
        raise ValueError(f"r must be (B, nf, nl), got {tuple(r.shape)}")
    B, nf, nl = r.shape
    n1, n2 = int(n1), int(n2)
    if n1 < 1 or n2 < 1 or 2 * n1 - 1 > nf or 2 * n2 - 1 > nl:
        raise ValueError(f"a ({2 * n1 - 1}, {2 * n2 - 1}) window does not "
                         f"fit a ({nf}, {nl}) map")
    if _device_of(r, "circular_argmax") == "cpu":
        return circular_argmax_plain(r, n1, n2)
    if r.dtype != torch.float32:
        raise TypeError(f"circular_argmax takes float32, got {r.dtype}")
    if not r.is_contiguous():
        raise ValueError("r must be contiguous")
    if B < 1:
        raise ValueError("circular_argmax takes at least one map")
    segs = _segments(r.device, B, 2 * n1 - 1)
    kw = dict(device=r.device)
    peak = torch.empty(B, dtype=torch.float32, **kw)
    k = torch.empty(B, dtype=torch.int64, **kw)
    part_v = torch.empty(B * segs, dtype=torch.float32, **kw)
    part_k = torch.empty(B * segs, dtype=torch.int64, **kw)
    from ._build import load
    _launch("circular_argmax", r.device, load().xc_circular_argmax,
            *_ptrs(r, peak, k, part_v, part_k), B, nf, nl, n1, n2, segs,
            _stream(r), counts=launches)
    return peak, k
