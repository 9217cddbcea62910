r"""
:mod:`ops.cells` -- The timelapse's cell kernels (TL1, TL2)
===========================================================

The hand-written CUDA kernels (``csrc/cells.cu``, built at first use by
:mod:`ops._build`) of a batch of the timelapse's 2-D correlation cells
(:func:`..scripts.timelapse.correlate_spectrograms`). They replace no
Pallas kernel: the JAX package fuses a batch of cells into one XLA
executable (``xcorr_tpu/scripts/timelapse.py``, ``_corr_step``), and
these are the passes of the port's form of that step that a library
call does not do in one.

* **TL1** :func:`gather_product` (``xc_gather_product``): the conjugate
  products of the cells' cached spectra, gathered by index::

      P[c] = a[ii[c]] · conj(b[jj[c]])

* **TL2** :func:`product_peaks`: each cell's peak and flat argmax over
  the fftshifted ``(2·n1-1, 2·n2-1)`` window of ``irfft2(P, s=(nf,
  nl))`` (rows ``(i - (n1-1)) mod nf``, columns ``(j - (n2-1)) mod nl``,
  as :func:`.cc.lag_slice_of_circular` defines them), with
  ``torch.argmax``'s rule: the first maximal element of the fftshifted
  order, a NaN above every number. The route follows the row length
  ``nl`` (:func:`row_plan`), chosen before any launch:

  - ``'kernel'``, where a row fits one block's shared memory: cuFFT's
    column inverse ``ifft(P, dim=-2)``, then :func:`inverse_argmax`
    (``xc_inverse_argmax``), each kept row's inverse and its peak in
    shared memory, two rows a block, so no map reaches device memory;
  - ``'scan'``, for longer rows: cuFFT's ``irfft2``, then
    :func:`circular_argmax` (``xc_circular_argmax``), the map's window
    read in place.

Each has a plain PyTorch version (``*_plain``): a wrapper takes it for
CPU tensors only, launches the kernel (or raises) for CUDA tensors, on
the tensors' card, and adds one to ``launches[name]`` per call that
launches it. :func:`circular_argmax` and :func:`inverse_argmax` are each
one kernel in two launches (the rows' part, then ``circular_argmax_join``
over each cell's parts), counted once per call: a count of ``n`` is
``n`` calls and ``2 n`` CUDA launches.
"""

from __future__ import annotations

from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from .cc import lag_slice_of_circular
from .fused_fft import _cached, _device_of, _launch, _lock, _ptrs, _stream

__all__ = ["gather_product", "gather_product_plain", "circular_argmax",
           "circular_argmax_plain", "inverse_argmax", "inverse_argmax_plain",
           "product_peaks", "product_peaks_plain", "products_in_columns",
           "row_plan", "RowPlan", "KERNELS", "launches", "reset_launches"]

#: kernel names, as ``launches`` counts them
KERNELS = ("gather_product", "circular_argmax", "inverse_argmax")

#: kernel calls made by the wrappers in this process, by kernel name: one
#: per launch of TL1, one per call of the two-launch kernels
launches = dict.fromkeys(KERNELS, 0)

#: shared memory one block may take on an H100 (227 KB)
SMEM_BYTES = 232_448
#: threads of a block of ``xc_inverse_argmax`` (``csrc/cells.cu``)
ROW_THREADS = 512
#: the row kernel's twiddle ``e^{+2πi·e/nl}`` is ``lo[e mod 2**TW_LO_BITS]
#: · hi[e >> TW_LO_BITS]`` (``csrc/cells.cu``; :func:`row_twiddles`)
TW_LO_BITS = 7

#: the row transform of :func:`inverse_argmax` at length ``nl``: its
#: radix passes in order (None where ``nl`` has a prime factor above 7),
#: the shared memory of a block in bytes, and the route of
#: :func:`product_peaks` (``'kernel'`` or ``'scan'``)
RowPlan = namedtuple("RowPlan", ["nl", "passes", "smem", "route"])

#: the scan's blocks per SM that the segments of a batch aim for
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
    """The scan's segments per cell: about ``_BLOCKS_PER_SM`` blocks per SM
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


# -- TL2's row route: the inverse's last axis and the peak in one kernel ----

@lru_cache(maxsize=None)
def row_plan(nl: int) -> RowPlan:
    """How :func:`inverse_argmax` transforms a row of length ``nl``.

    The passes are ``nl``'s prime factors as radices: the power of two
    as 8s and then one 4 or 2, then 7s, the power of three as 9s, 5s,
    and one 3 where the power of three is odd. The odd radices come
    last, where a pass's butterflies lie ``r`` apart and an odd stride
    keeps shared memory free of bank conflicts. A block holds both rows'
    half spectra, ``2 (nl//2 + 1)`` complex64 values, in which it builds
    and transforms the packed row in place (at least the ``12
    ROW_THREADS`` bytes of its final reduction), and the twiddle tables
    of :func:`row_twiddles`. The route is ``'kernel'`` where those bytes
    fit :data:`SMEM_BYTES` and ``nl`` is 7-smooth, else ``'scan'``."""
    nl = int(nl)
    if nl < 1:
        raise ValueError(f"nl={nl}: a row holds at least one value")
    n, powers = nl, {}
    for p in (2, 3, 5, 7):
        powers[p] = 0
        while n % p == 0:
            n //= p
            powers[p] += 1
    slots = max(2 * (nl // 2 + 1), 3 * ROW_THREADS // 2)
    # lo takes one slot more every 16 entries (csrc/cells.cu: TW_LO_SLOTS)
    smem = 8 * (slots + len(row_twiddles(nl)) + (1 << TW_LO_BITS) // 16)
    if n != 1:
        return RowPlan(nl, None, smem, "scan")
    twos, threes = powers[2], powers[3]
    passes = ((8,) * (twos // 3) + ((), (2,), (4,))[twos % 3]
              + (7,) * powers[7] + (9,) * (threes // 2) + (5,) * powers[5]
              + (3,) * (threes % 2))
    return RowPlan(nl, passes, smem,
                   "kernel" if smem <= SMEM_BYTES else "scan")


def row_twiddles(nl: int) -> np.ndarray:
    """The row kernel's twiddle tables at length ``nl`` (complex128,
    computed in float64): ``lo[i] = e^{+2πi·i/nl}`` for ``i <
    2**TW_LO_BITS``, then ``hi[i] = e^{+2πi·i·2**TW_LO_BITS/nl}`` for ``i <
    ceil(nl / 2**TW_LO_BITS)``. The kernel holds both, as float32, in
    shared memory, and takes ``e^{+2πi·e/nl}`` as ``lo[e mod 2**TW_LO_BITS]
    · hi[e >> TW_LO_BITS]`` (about one float32 rounding more than a
    value of its own): a table of every twiddle would need as much
    shared memory as the rows."""
    lo = np.arange(1 << TW_LO_BITS)
    hi = (np.arange(-(-nl // (1 << TW_LO_BITS))) << TW_LO_BITS) % nl
    return np.exp(2j * np.pi * np.concatenate([lo, hi]) / nl)


def _row_twiddles(nl: int, device):
    """:func:`row_twiddles` as complex64 on ``device``, made once per
    (device, nl)."""
    return _cached(("tl2tw", nl, str(device)), lambda: torch.from_numpy(
        row_twiddles(nl).astype(np.complex64)).to(device))


def _check_window(name, x, n1: int, n2: int, nl: int):
    if x.dim() != 3 or x.shape[2] != nl // 2 + 1:
        raise ValueError(f"{name} must be (B, nf, nl//2 + 1) = (B, nf, "
                         f"{nl // 2 + 1}), got {tuple(x.shape)}")
    nf = x.shape[1]
    if n1 < 1 or n2 < 1 or 2 * n1 - 1 > nf or 2 * n2 - 1 > nl:
        raise ValueError(f"a ({2 * n1 - 1}, {2 * n2 - 1}) window does not "
                         f"fit a ({nf}, {nl}) map")


def inverse_argmax_plain(Y, n1: int, n2: int, nl: int):
    """The peak and flat argmax of each map ``irfft(Y, n=nl) / nf`` over
    its fftshifted ``(2·n1-1, 2·n2-1)`` window: :func:`inverse_argmax`'s
    function in PyTorch."""
    return circular_argmax_plain(
        torch.fft.irfft(Y, n=nl, dim=-1) / Y.shape[1], n1, n2)


def inverse_argmax(Y, n1: int, n2: int, nl: int):
    """TL2 on the row route: ``(peak, k)`` of each map ``irfft(Y, n=nl,
    dim=-1) / nf`` of ``Y`` (``(B, nf, nl//2 + 1)`` complex64: the
    cells' column inverses, unscaled, contiguous or with its columns
    contiguous, as ``torch.fft.ifft(P, dim=-2, norm="forward")`` gives
    them, so that the maps are ``irfft2``'s) over its fftshifted
    ``(2·n1-1, 2·n2-1)`` window, as :func:`inverse_argmax_plain` returns
    them, with no map stored: one block per two kept rows of a cell
    takes both half spectra into shared memory, extends each to its
    Hermitian length (the DC and, for an even ``nl``, the Nyquist term
    real, as ``irfft`` reads them), packs the pair as one complex row
    ``Ya + i·Yb``, inverts it in place over :func:`row_plan`'s passes,
    scales by ``1/(nf·nl)`` and reduces both rows' window columns; a
    second launch joins each cell's blocks. A row whose terms hold a NaN
    maps to NaN at every lag (the transform sums every term into every
    lag), and one that holds an infinity has no defined inverse (inf -
    inf): for either the block gives NaN at that row's first window
    column without transforming the pair, so the packed partner row
    never sees it. Raises where ``nl`` takes the scan route."""
    nl, n1, n2 = int(nl), int(n1), int(n2)
    _check_window("Y", Y, n1, n2, nl)
    if Y.dtype != torch.complex64:
        raise TypeError(f"inverse_argmax takes complex64, got {Y.dtype}")
    if not (Y.is_contiguous() or Y.transpose(-2, -1).is_contiguous()):
        raise ValueError("Y must be contiguous, or its columns")
    if _device_of(Y, "inverse_argmax") == "cpu":
        return inverse_argmax_plain(Y, n1, n2, nl)
    plan = row_plan(nl)
    if plan.route != "kernel":
        raise ValueError(f"nl={nl}: a block would need {plan.smem} bytes of "
                         f"shared memory, over {SMEM_BYTES}; the row takes "
                         "the scan route")
    B, nf = Y.shape[:2]
    if B < 1 or Y.numel() >= 1 << 31:
        raise ValueError(f"{B} maps of {nf} x {nl // 2 + 1}: inverse_argmax "
                         "takes at least one, and under 2**31 values")
    kw = dict(device=Y.device)
    peak = torch.empty(B, dtype=torch.float32, **kw)
    k = torch.empty(B, dtype=torch.int64, **kw)
    part_v = torch.empty(B * n1, dtype=torch.float32, **kw)
    part_k = torch.empty(B * n1, dtype=torch.int64, **kw)
    radices = np.asarray(plan.passes, dtype=np.int32)
    from ._build import load
    _launch("inverse_argmax", Y.device, load().xc_inverse_argmax,
            *_ptrs(Y, _row_twiddles(nl, Y.device), peak, k, part_v, part_k),
            radices.ctypes.data, radices.size, B, nf, nl, n1, n2,
            *Y.stride(), _stream(Y), counts=launches)
    return peak, k


def products_in_columns(nl: int, device) -> bool:
    """Whether :func:`product_peaks` on ``device`` wants its products with
    their columns contiguous (``(B, nl//2 + 1, nf)`` transposed): on a
    card on the row route, where cuFFT's column inverse then reads and
    writes them without a copy. The CPU takes them contiguous."""
    return (torch.device(device).type == "cuda"
            and row_plan(nl).route == "kernel")


def product_peaks_plain(P, n1: int, n2: int, nl: int):
    """``circular_argmax_plain(irfft2(P, s=(nf, nl)), n1, n2)``:
    :func:`product_peaks`'s function in PyTorch."""
    return circular_argmax_plain(
        torch.fft.irfft2(P, s=(P.shape[1], nl)), n1, n2)


def product_peaks(P, n1: int, n2: int, nl: int):
    """TL2: ``(peak, k)`` of each cell of the conjugate products ``P``
    (``(B, nf, nl//2 + 1)``, TL1's output) over the fftshifted ``(2·n1-1,
    2·n2-1)`` window of ``irfft2(P, s=(nf, nl))``, as
    :func:`product_peaks_plain` returns them, which the CPU takes. On the
    card the route is :func:`row_plan`'s, chosen from ``nl`` before any
    launch: ``'kernel'`` runs ``torch.fft.ifft(P, dim=-2,
    norm="forward")`` (cuFFT's column inverse, unscaled: the kernel
    divides by ``nf`` with its own ``nl``) and :func:`inverse_argmax`;
    ``'scan'`` runs ``torch.fft.irfft2`` and :func:`circular_argmax`.
    ``P`` with its columns contiguous (``P.transpose(-2, -1)`` of a
    contiguous ``(B, h, nf)``, where :func:`products_in_columns` says so)
    takes the column inverse without a copy: cuFFT's output lays its
    columns out so too."""
    nl, n1, n2 = int(nl), int(n1), int(n2)
    _check_window("P", P, n1, n2, nl)
    if _device_of(P, "product_peaks") == "cpu":
        return product_peaks_plain(P, n1, n2, nl)
    if row_plan(nl).route == "kernel":
        return inverse_argmax(torch.fft.ifft(P, dim=-2, norm="forward"),
                              n1, n2, nl)
    return circular_argmax(torch.fft.irfft2(P, s=(P.shape[1], nl)), n1, n2)
