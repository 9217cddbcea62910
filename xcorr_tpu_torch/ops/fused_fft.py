r"""
:mod:`ops.fused_fft` -- Fused stage-B correlation kernel (K1)
=============================================================

The whole stage B of the four-step correlation (:mod:`ops.fft4`) in one
launch. For each ``(b, k1)`` row of the packed stage-A planes::

    C[b,k1,:] = IDFT_N2( DFT_N2(Ax[b,k1,:]·T[k1,:])
                         · conj(DFT_N2(Ay[b,k1,:]·T[k1,:])) ) · conj(T[k1,:])

with ``T = exp(-2πi·k1·n2/N)`` the outer twiddle, output in natural n2
order. Replaces the Pallas kernel
``xcorr_tpu/ops/pallas_fft.py::plan_fused_corr`` (``corr_kernel``).

The CUDA kernel (``csrc/fused_corr.cu``) keeps one x row and one y row
per block in shared memory, so N2 must be a power of two no larger than
:data:`MAX_N2`; the spectra never reach device memory. It is memory-bound
(see the source note). :func:`fused_corr_plain` is the same function in
plain PyTorch: the wrapper takes it for CPU tensors only, and the tests
and ``chip_smoke.py`` hold the kernel against it.

Layouts: ``ax``, ``ay`` and the result are ``(B, 2, H, N2)`` float32 with
re/im on axis 1; ``T`` is ``(2, H, N2)`` float32.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["fused_corr", "fused_corr_plain", "check_geometry", "MAX_N2",
           "launches"]

#: largest row length whose x and y rows (complex float32) plus the
#: twiddle table fit one block's shared memory (160 KB of 227 KB)
MAX_N2 = 8192

#: kernel launches made by :func:`fused_corr` in this process
launches = 0

_lock = threading.Lock()
_twiddles = {}


def check_geometry(N2: int):
    """Raise ``ValueError`` unless the kernel takes rows of length N2."""
    if N2 < 2 or N2 & (N2 - 1) or N2 > MAX_N2:
        raise ValueError(
            f"N2={N2}: the fused stage-B kernel takes a power of two "
            f"between 2 and {MAX_N2}")


def fused_corr_plain(ax, ay, T):
    """:func:`fused_corr` in plain PyTorch (``torch.fft``)."""
    t = torch.complex(T[0], T[1])
    x = torch.complex(ax[:, 0], ax[:, 1]) * t
    y = torch.complex(ay[:, 0], ay[:, 1]) * t
    s = torch.fft.fft(x, dim=-1) * torch.conj(torch.fft.fft(y, dim=-1))
    c = torch.fft.ifft(s, dim=-1) * torch.conj(t)
    return torch.stack([c.real, c.imag], dim=1)


def _check(ax, ay, T):
    if ax.dim() != 4 or ax.shape[1] != 2:
        raise ValueError(f"ax must be (B, 2, H, N2), got {tuple(ax.shape)}")
    B, _, H, N2 = ax.shape
    check_geometry(N2)
    if ay.shape != ax.shape:
        raise ValueError(f"ay {tuple(ay.shape)} != ax {tuple(ax.shape)}")
    if T.shape != (2, H, N2):
        raise ValueError(f"T must be (2, {H}, {N2}), got {tuple(T.shape)}")
    for name, a in (("ax", ax), ("ay", ay), ("T", T)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != ax.device:
            raise ValueError(f"{name} is on {a.device}, ax on {ax.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _inner_twiddles(N2: int, device):
    """``exp(-2πi k/N2)``, k < N2/2, computed in float64, stored as
    interleaved float32 (re, im) pairs on ``device``."""
    key = (N2, str(device))
    with _lock:
        tw = _twiddles.get(key)
        if tw is None:
            w = np.exp(-2j * np.pi * np.arange(N2 // 2) / N2)
            host = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
            tw = torch.from_numpy(host).to(device)
            _twiddles[key] = tw
        return tw


def fused_corr(ax, ay, T):
    """Fused stage-B correlation of the packed planes ``ax``, ``ay``.

    CPU tensors go through :func:`fused_corr_plain`; CUDA tensors launch
    the kernel (built at first use) or raise. Shapes, dtype, device and
    contiguity are checked on both.
    """
    global launches
    _check(ax, ay, T)
    if ax.device.type == "cpu":
        return fused_corr_plain(ax, ay, T)
    if ax.device.type != "cuda":
        raise ValueError(f"fused_corr runs on cpu or cuda, not {ax.device}")
    from ._build import load
    lib = load()
    B, _, H, N2 = ax.shape
    out = torch.empty_like(ax)
    tw = _inner_twiddles(N2, ax.device)
    stream = torch.cuda.current_stream(ax.device).cuda_stream
    rc = lib.xc_fused_corr(ax.data_ptr(), ay.data_ptr(), T.data_ptr(),
                           tw.data_ptr(), out.data_ptr(), B, H, N2,
                           N2.bit_length() - 1, stream)
    if rc != 0:
        raise RuntimeError(f"fused_corr kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return out
