r"""
:mod:`ops.filter` -- IIR filtering on tensors
=============================================

Butterworth second-order-section filtering (spec:
``xcorr/signal/filter.py:27-120`` = scipy ``butter`` + ``sosfiltfilt``;
obspy's single-pass ``sosfilt`` for the stream DSL). Port of
``xcorr_tpu/ops/filter.py``.

A biquad in transposed direct-form II is the affine state recurrence

    s[t] = A s[t-1] + B x[t],    y[t] = b0 x[t] + s1[t-1]

with A = [[-a1, 1], [-a2, 0]], B = [b1 - a1 b0, b2 - a2 b0]. Within a
chunk of L samples it has the closed form s[t] = A^(t+1) z_in +
(h * x)[t]: the A-power sequences and the impulse response h[k] = A^k B
are designed on the host in float64 (:func:`_biquad_chunk_plan`, the JAX
package's), and the data-dependent part is ONE causal FFT convolution
per chunk (``torch.fft``).

The trace is cut into chunks of ``2^18`` samples (one chunk of n samples
when it is shorter; the JAX package scans those with
``lax.associative_scan``, which PyTorch lacks). Every chunk's
convolution runs in one batched transform. The state entering chunk k
is ``z_k = M z_(k-1) + u_(k-1)`` with ``M = A^L`` and ``u`` the chunk's
own end state from zero, a 2-element recurrence over the chunks; it is
solved in closed form too, ``z_k = sum_(j<=k) M^(k-j) u'_j`` with
``u'_0`` the initial state: one small matrix product instead of a loop
of launches. The JAX package carries the same state through a
``lax.scan``; the sums differ only in float32 rounding.

Not carried: the six-plane layout (``xcorr_tpu/ops/filter.py:75-77``),
which worked around the TPU's lane padding.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as sp_signal
import torch

from .consts import HostConst

__all__ = ["butter_sos", "sosfilt", "sosfiltfilt", "filtfilt_design"]

#: chunk length of the closed form (the JAX package's, swept on its TPU)
_CHUNK = 1 << 18


def butter_sos(order: int, frequency, btype: str, sampling_rate: float):
    """Butterworth SOS design (host-side scipy; coefficients are data)."""
    nyq = 0.5 * sampling_rate
    wn = np.atleast_1d(np.asarray(frequency, dtype=np.float64)) / nyq
    wn = wn if wn.size > 1 else wn.item()
    return sp_signal.butter(order, wn, btype=btype, output="sos")


def _biquad_chunk_plan(b, a, L):
    """Host precomputation for the conv-based chunked biquad (the JAX
    package's ``_biquad_chunk_plan``).

    The state recurrence s[t] = A s[t-1] + B x[t] has, within a chunk of
    length L, the closed form s[t] = A^(t+1) z_in + sum_j A^(t-j) B x[j]:
    the A-power entries are data-independent sequences (computed here in
    f64) and the convolution term uses the impulse response h[k] = A^k B.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    a1, a2 = a[1], a[2]
    B1, B2 = b[1] - a1 * b[0], b[2] - a2 * b[0]

    def seq(u0, u1):
        # u[t] = -a1 u[t-1] - a2 u[t-2] from the given first two values,
        # via one lfilter call
        delta = np.zeros(L)
        delta[0] = 1.0
        return sp_signal.lfilter([u0, u1 + a1 * u0], [1.0, a1, a2], delta)

    # A^(t+1) entries (A = [[-a1, 1], [-a2, 0]])
    m11 = seq(-a1, a1 * a1 - a2)
    m12 = seq(1.0, -a1)
    m21 = seq(-a2, a1 * a2)
    m22 = seq(0.0, -a2)
    # impulse response h[k] = A^k B
    h1 = seq(B1, -a1 * B1 + B2)
    h2 = seq(B2, -a2 * B1)
    nfft = 1
    while nfft < 2 * L:
        nfft *= 2
    H1 = np.fft.rfft(h1, nfft)
    return {
        "m11": m11, "m12": m12, "m21": m21, "m22": m22,
        "H1": H1, "h2_rev": h2[::-1].copy(), "nfft": nfft,
    }


def _carry_matrix(M, C):
    """``(2C, 2C)`` float64 matrix W with ``W[2k+p, 2j+q] = (M^(k-j))[p,
    q]`` for ``j <= k``, else 0: ``z = W @ u'`` solves the chunk-state
    recurrence ``z_k = M z_(k-1) + u'_k`` from ``z_0 = u'_0``."""
    powers = [np.eye(2)]
    for _ in range(C - 1):
        powers.append(M @ powers[-1])
    W = np.zeros((2 * C, 2 * C))
    for k in range(C):
        for j in range(k + 1):
            W[2 * k:2 * k + 2, 2 * j:2 * j + 2] = powers[k - j]
    return W


@lru_cache(maxsize=64)
def _plan(b, a, L, C):
    """The chunk plan of one biquad as device-ready constants, for
    ``C`` chunks of ``L`` samples."""
    p = _biquad_chunk_plan(np.asarray(b), np.asarray(a), L)
    M = np.array([[p["m11"][L - 1], p["m12"][L - 1]],
                  [p["m21"][L - 1], p["m22"][L - 1]]])
    return {"b0": float(b[0]), "nfft": p["nfft"],
            "m11": HostConst(p["m11"]), "m12": HostConst(p["m12"]),
            "H1": HostConst(p["H1"]), "h2_rev": HostConst(p["h2_rev"]),
            "WT": HostConst(_carry_matrix(M, C).T.copy())}


def _biquad(x, b, a, zi=None):
    """One biquad along the last axis of ``x`` (``(..., n)``); ``zi`` an
    optional ``(..., 2)`` initial state (transposed DF-II, scipy's
    convention)."""
    n = x.shape[-1]
    L = min(_CHUNK, n)
    C = -(-n // L)
    plan = _plan(tuple(map(float, b)), tuple(map(float, a)), L, C)
    nfft = plan["nfft"]
    lead = x.shape[:-1]
    xc = torch.nn.functional.pad(x, (0, C * L - n)).reshape(*lead, C, L)
    X = torch.fft.rfft(xc, n=nfft, dim=-1)
    v1 = torch.fft.irfft(X * plan["H1"].like(x), n=nfft, dim=-1)[..., :L]
    del X
    # u'_0 = the initial state; u'_k = chunk k-1's end state from zero
    u = torch.zeros(*lead, C, 2, dtype=x.dtype, device=x.device)
    if zi is not None:
        u[..., 0, :] = zi
    if C > 1:
        u[..., 1:, 0] = v1[..., :-1, L - 1]
        u[..., 1:, 1] = torch.matmul(xc[..., :-1, :],
                                     plan["h2_rev"].like(x))
        u = torch.matmul(u.reshape(*lead, 2 * C),
                         plan["WT"].like(x)).reshape(*lead, C, 2)
    z1, z2 = u[..., 0:1], u[..., 1:2]     # (..., C, 1): state entering
    s1 = plan["m11"].like(x) * z1 + plan["m12"].like(x) * z2 + v1
    y = plan["b0"] * xc + torch.cat([z1, s1[..., :-1]], dim=-1)
    return y.reshape(*lead, C * L)[..., :n]


def sosfilt(sos, x, zi=None):
    """Cascaded-biquad forward filtering along the last axis.

    sos: (nsections, 6) scipy-layout coefficients, concrete (the plans
    are designed from their values on the host). zi: optional
    (nsections, ..., 2) per-section initial conditions.
    """
    sos = np.asarray(sos, dtype=np.float64)
    y = x
    for i in range(sos.shape[0]):
        y = _biquad(y, sos[i, :3], sos[i, 3:], None if zi is None else zi[i])
    return y


def filtfilt_design(sos):
    """Host-side precomputation for sosfiltfilt: per-section zi templates
    and the scipy default pad length."""
    sos = np.asarray(sos, dtype=np.float64)
    zi = sp_signal.sosfilt_zi(sos)  # (nsec, 2), scaled for unit step
    # scipy sosfiltfilt default edge padding: 3 x effective taps, crediting
    # trailing zero coefficients
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * int(ntaps)
    return zi, padlen


def sosfiltfilt(sos, x, zi_template=None, padlen: int = None):
    """Zero-phase forward-backward SOS filtering (scipy ``sosfiltfilt``
    algorithm: odd extension by ``padlen``, x0-scaled initial conditions,
    forward pass, reversed pass, trim)."""
    sos = np.asarray(sos, dtype=np.float64)
    if zi_template is None or padlen is None:
        zi_template, padlen_default = filtfilt_design(sos)
        padlen = padlen_default if padlen is None else padlen
    n = x.shape[-1]
    if padlen >= n:
        raise ValueError(
            f"padlen ({padlen}) must be less than the signal length ({n})")
    zi_t = torch.as_tensor(np.asarray(zi_template), dtype=x.dtype,
                           device=x.device)   # (nsec, 2)

    # odd extension at both ends
    left = 2 * x[..., :1] - torch.flip(x[..., 1:padlen + 1], [-1])
    right = 2 * x[..., -1:] - torch.flip(x[..., n - padlen - 1:n - 1], [-1])
    ext = torch.cat([left, x, right], dim=-1)

    def run(data):
        # scipy scales every section's zi by the extension's first sample
        x0 = data[..., :1]
        y = data
        for i in range(sos.shape[0]):
            y = _biquad(y, sos[i, :3], sos[i, 3:], zi_t[i] * x0)
        return y

    fwd = run(ext)
    bwd = torch.flip(run(torch.flip(fwd, [-1])), [-1])
    return bwd[..., padlen:padlen + n]
