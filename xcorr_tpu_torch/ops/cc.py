r"""
:mod:`ops.cc` -- Batched frequency-domain cross-correlation
===========================================================

The hot path (spec: ``xcorr/util/cc.py:22-79``): normalized
cross-correlation of receiver pairs via ``rfft -> conj-multiply -> irfft``
over a dense leading batch axis. Counterpart of ``xcorr_tpu/ops/cc.py``.

Two routes, chosen before the call from the window length, dtype and
device, never by catching an error:

* **monolithic**: ``torch.fft.rfft``/``irfft`` at the next cuFFT-fast
  length. Every CPU tensor takes it unless ``method='fourstep'`` is given.
* **four-step** (:mod:`ops.fft4`): a CUDA float32 batch with
  ``n >= FOURSTEP_THRESHOLD`` runs one of three routes through the
  hand-written kernels of :mod:`ops.fused_fft`, chosen by
  ``ops.fft4.plan_correlate4`` from the environment on every call:
  ``"corr"`` (default: stage-A product, K1, pruned-inverse product),
  ``"acc"`` (``XCORR_FFT4_FUSED_INV=1``: stage-A product, then K3 with
  the pruned inverse inside) or ``"full"`` (``XCORR_FFT4_FULL=1``, which
  wins over the other: K4, stage A to pruned rows in one kernel); then
  the lag-window slice. On the CPU the route's plain version runs.

Normalization by the norm product and the unbiased lag weights apply on
the clipped lag window only (index math identical to the reference's
``index_min``/``index_max`` machinery, ``xcorr/util/time.py:94-108``).
"""

from __future__ import annotations

import numpy as np
import torch

from .fft import next_fast_len

__all__ = ["correlate", "lag_slice_of_circular", "unbiased_weights",
           "FOURSTEP_THRESHOLD"]

#: windows at least this long take the four-step route on a CUDA device.
#: Carried from the reference until a benchmark measures the crossover.
FOURSTEP_THRESHOLD = 1 << 20

_METHODS = ("auto", "monolithic", "fourstep")


def unbiased_weights(npts: int, index_min: int = None, index_max: int = None,
                     clip: float = None, dtype=torch.float32,
                     device="cpu"):
    """Unbiased-estimate weights ``npts/(npts-|k|)`` on the fftshifted lag
    window [index_min, index_max) of the full 2·npts-1 lag vector."""
    nn = 2 * npts - 1
    index_min = 0 if index_min is None else index_min
    index_max = nn if index_max is None else index_max
    k = np.arange(index_min, index_max, dtype=np.float64) - (npts - 1)
    w = npts / (npts - np.abs(k))
    if clip is not None:
        w = np.minimum(w, clip)
    return torch.as_tensor(w, dtype=dtype, device=device)


def lag_slice_of_circular(r, npts: int, nfft: int, index_min: int,
                          index_max: int):
    """Gather the fftshift-ordered lag window out of a circular correlation
    buffer ``r`` of length ``nfft``.

    fftshifted index ``i`` (0..2·npts-2, zero lag at npts-1) lives at
    circular index ``(i - (npts-1)) mod nfft``: one or two slices.
    """
    z = npts - 1  # zero-lag fftshift position
    if index_max <= z:  # purely negative lags
        return r[..., nfft + index_min - z: nfft + index_max - z]
    if index_min >= z:  # purely non-negative lags
        return r[..., index_min - z: index_max - z]
    neg = r[..., nfft + index_min - z:]
    pos = r[..., : index_max - z]
    return torch.cat([neg, pos], dim=-1)


def correlate(x, y, *, normalize: bool = True, index_min: int = None,
              index_max: int = None, unbiased: bool = False,
              nfft: int = None, clip_weight: float = None,
              method: str = "auto"):
    """Normalized cross-correlation of ``x`` and ``y`` (``(B, n)`` tensors
    on one device), returned on that device.

    ``method``: ``'auto'`` routes a CUDA float32 batch with
    ``n >= FOURSTEP_THRESHOLD`` (and no ``unbiased``/``nfft``/
    ``clip_weight``) to the four-step path and everything else to the
    monolithic path; ``'monolithic'`` and ``'fourstep'`` force one. The
    four-step products run in full float32.
    """
    if method not in _METHODS:
        raise ValueError(f"method={method!r}: expected one of {_METHODS}")
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    n = x.shape[-1]
    if method == "fourstep" and (unbiased or nfft is not None
                                 or clip_weight is not None):
        raise ValueError(
            "method='fourstep' does not support unbiased/nfft/"
            "clip_weight; use method='auto' or 'monolithic'")
    use4 = method == "fourstep" or (
        method == "auto" and nfft is None and not unbiased
        and clip_weight is None
        and n >= FOURSTEP_THRESHOLD
        and x.device.type == "cuda"
        and x.dtype == torch.float32)
    if use4:
        from .fft4 import plan_correlate4
        fn = plan_correlate4(n, index_min, index_max, normalize=normalize)
        return fn(x, y)
    return _correlate_monolithic(
        x, y, normalize=normalize, index_min=index_min,
        index_max=index_max, unbiased=unbiased, nfft=nfft,
        clip_weight=clip_weight)


def _correlate_monolithic(x, y, *, normalize: bool = True,
                          index_min: int = None, index_max: int = None,
                          unbiased: bool = False, nfft: int = None,
                          clip_weight: float = None):
    """Batched normalized cross-correlation along the last axis.

    Returns the ``(..., index_max-index_min)`` cross-correlation estimate
    in fftshifted lag order, same dtype as ``x``.
    """
    n = x.shape[-1]
    nn = 2 * n - 1
    index_min = 0 if index_min is None else index_min
    index_max = nn if index_max is None else index_max
    if nfft is not None and nfft < nn:
        raise ValueError(
            f"nfft={nfft} < 2n-1={nn}: the circular correlation would "
            "alias positive lags onto negative ones")
    nfft = nfft or next_fast_len(nn)

    X = torch.fft.rfft(x, n=nfft, dim=-1)
    Y = torch.fft.rfft(y, n=nfft, dim=-1)
    r = torch.fft.irfft(X * torch.conj(Y), n=nfft, dim=-1)
    out = lag_slice_of_circular(r, n, nfft, index_min, index_max)

    if normalize:
        nx = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        ny = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        denom = nx * ny
        out = out / torch.where(denom == 0, torch.ones_like(denom), denom)
    if unbiased:
        out = out * unbiased_weights(n, index_min, index_max,
                                     clip=clip_weight, dtype=out.dtype,
                                     device=out.device)
    return out.to(x.dtype)
