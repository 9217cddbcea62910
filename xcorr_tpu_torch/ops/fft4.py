r"""
:mod:`ops.fft4` -- Four-step (Cooley-Tukey) pruned correlation
==============================================================

A hand-decomposed frequency-domain correlation for day-scale windows,
N = N1 x N2. Counterpart of ``xcorr_tpu/ops/fft4.py``'s fused plan
(``_build_pallas_corr``). Three routes compute the same function, each
through one of the hand-written kernels of :mod:`ops.fused_fft`:

* ``"corr"`` (the default; K1): **stage A**, the DFT over the slow axis,
  as a real ``torch.matmul`` against a pruned ``W1`` (only the
  ``rows_in`` rows covered by input samples; the zero padding costs
  nothing), re and im stacked; **stage B** in one launch of
  :func:`ops.fused_fft.fused_corr` (outer twiddle, length-N2 DFT of both
  signals, cross spectrum, inverse DFT, conjugate twiddle); the **pruned
  inverse** as a second ``torch.matmul`` computing only the output rows
  covered by the requested lag window;
* ``"acc"`` (K3, ``XCORR_FFT4_FUSED_INV=1``): stage A as above, then
  stage B and the pruned inverse in :func:`ops.fused_fft.fused_corr_acc`;
* ``"full"`` (K4, ``XCORR_FFT4_FULL=1``): everything from the padded
  windows to the pruned rows in :func:`ops.fused_fft.fused_corr_full`;

then the lag-window slice and the norm division (:func:`_finish_ccf`).
:func:`plan_correlate4` reads the two variables on every call, with the
JAX package's names and precedence (``XCORR_FFT4_FULL`` first), unless
the caller names the route.

**Hermitian half-row pruning**: x and y are real, so the time-domain rows
pair as ``C(N1-k1) = conj(C(k1))``. Stage A and stage B therefore run on
the first ``H = N1/2 + 1`` rows only, and the mirror rows fold into the
pruned inverse as the real-ifft weights (2, except 1 at k1 = 0 and N1/2).

Geometry: N2 is a power of two no larger than the route's kernel takes
(``fused_fft.MAX_N2``): 16384 on every route (K1, K3 and K4 share a row
chain that keeps its rows in registers). The default ``n1`` is the
route's own, the smallest multiple of 16 that brings N2 down to that
limit. At n = 4,320,000 (24 h at 50 Hz) every route takes n1 = 528,
N2 = 16384, H = 265, rows_in = 264, rows_out = 99 on the 0-9 h lag
window: the reference's geometry. A smaller N1 shrinks stage A and the
pruned inverse, dense products over the k1 rows, at the same N.

Precision: the ``torch.matmul`` products of ``corr`` and ``acc`` run in
full float32: TF32 is switched off for matmuls and cuDNN when a plan is
built and checked on every call. K3's and K4's own products run on the
tensor cores as three TF32 passes (``hi·hi + hi·lo + lo·hi`` with
``lo = a - hi``), float32-level products held to the same 1e-6 bar.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .fft import next_fast_len
from .fused_fft import (MAX_N2, check_geometry, fused_corr, fused_corr_acc,
                        fused_corr_full)

__all__ = ["plan_correlate4", "padded_len", "resolve_route", "ROUTES"]

#: the correlation routes and the kernel of ops.fused_fft each launches
ROUTE_KERNEL = {"corr": "fused_corr", "acc": "fused_corr_acc",
                "full": "fused_corr_full"}
ROUTES = tuple(ROUTE_KERNEL)


def _default_n1(nn: int, route: str = "corr") -> int:
    """Smallest multiple of 16 that brings N2 down to the largest row
    the route's kernel takes."""
    rows = -(-nn // MAX_N2[ROUTE_KERNEL[route]])  # ceil(nn / max N2)
    return max(16, -(-rows // 16) * 16)


def _pick_factors(nn: int, n1: int):
    """N1 x N2 >= nn with N2 a power of two (the kernel's radix-2
    transforms)."""
    return n1, next_fast_len(-(-nn // n1), radices=(2,))


def padded_len(n: int, n1: int = None, route: str = "corr") -> int:
    """Stage-A input length ``rows_in * N2`` for a window of ``n``
    samples, in ``route``'s default geometry unless ``n1`` is given."""
    nn = 2 * n - 1
    _, N2 = _pick_factors(nn, n1 or _default_n1(nn, route))
    return -(-n // N2) * N2


@lru_cache(maxsize=8)
def _plan(n: int, index_min: int, index_max: int, n1: int):
    """Static plan: factor geometry, twiddles and DFT matrices (host f64,
    stored complex64)."""
    nn = 2 * n - 1
    N1, N2 = _pick_factors(nn, n1)
    N = N1 * N2

    rows_in = (n + N2 - 1) // N2  # input rows covered by n samples

    k1 = np.arange(N1)
    # forward DFT matrix over the slow axis, pruned to input rows
    W1 = np.exp(-2j * np.pi * np.outer(k1, np.arange(rows_in)) / N1)
    # twiddle W_N^(k1 * n2)
    T = np.exp(-2j * np.pi * np.outer(k1, np.arange(N2)) / N)

    # output rows covered by the circular lag gather:
    # fftshifted lag index i in [index_min, index_max) lives at circular
    # index (i - (n-1)) mod N; that index range maps to row range(s)
    z = n - 1
    segs = []
    if index_max <= z:
        segs.append((N + index_min - z, N + index_max - z))
    elif index_min >= z:
        segs.append((index_min - z, index_max - z))
    else:
        segs.append((N + index_min - z, N))
        segs.append((0, index_max - z))
    row_lo = min(s[0] // N2 for s in segs)
    row_hi = max((s[1] - 1) // N2 for s in segs) + 1
    # contiguity: the negative-lag segment sits at the very top rows and
    # the positive at the bottom; handle both by computing the union of
    # two row ranges when split
    if len(segs) == 2:
        rows_sets = [(segs[0][0] // N2, N1),
                     (0, (segs[1][1] - 1) // N2 + 1)]
    else:
        rows_sets = [(row_lo, row_hi)]

    out_rows = []
    for lo, hi in rows_sets:
        out_rows.extend(range(lo, hi))
    out_rows = np.asarray(sorted(set(out_rows)), dtype=np.int64)

    # pruned inverse DFT matrix: rows n1 in out_rows only. The stage-B
    # inverse already contributes 1/N2, so 1/N1 completes 1/N.
    W1inv = np.exp(+2j * np.pi * np.outer(out_rows, k1) / N1) / N1

    # map requested lag indices into the pruned (row, col) layout
    # circular index c = row * N2 + col; pruned row position p(row)
    row_pos = {r: i for i, r in enumerate(out_rows)}
    gather = np.empty(index_max - index_min, dtype=np.int64)
    for j, i in enumerate(range(index_min, index_max)):
        c = (i - z) % N
        gather[j] = row_pos[c // N2] * N2 + (c % N2)

    # each circular segment is CONTIGUOUS in the pruned flat layout
    # (consecutive lag -> consecutive circular index -> next pruned row
    # starts exactly where the previous ended), so the lag window is a
    # concat of slices
    segs_flat = []
    for lo, hi in segs:
        start = row_pos[lo // N2] * N2 + (lo % N2)
        segs_flat.append((start, hi - lo))
    # plan-time invariant check (ValueError, not assert: this guards
    # output correctness and must survive python -O)
    if not np.array_equal(
            np.concatenate([np.arange(s, s + ln) for s, ln in segs_flat]),
            gather):
        raise ValueError("pruned lag window is not slice-contiguous "
                         "for this geometry")

    return {
        "N1": N1, "N2": N2, "N": N, "rows_in": rows_in,
        "W1": W1.astype(np.complex64),
        "T": T.astype(np.complex64),
        "W1inv": W1inv.astype(np.complex64),
        "out_rows": out_rows,
        "gather": gather,
        "segs_flat": tuple(segs_flat),
    }


def _take_lag_window(out_flat, segs_flat):
    """Slice the lag window out of the pruned flat correlation rows (see
    ``segs_flat`` in :func:`_plan`)."""
    parts = [out_flat[:, s:s + ln] for s, ln in segs_flat]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _finish_ccf(out_flat, x, y, segs_flat, normalize):
    """Correlation epilogue: lag-window slice, optional norm division,
    output dtype."""
    r = _take_lag_window(out_flat, segs_flat)
    if normalize:
        nx = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        ny = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        denom = nx * ny
        r = r / torch.where(denom == 0, torch.ones_like(denom), denom)
    return r.to(x.dtype)


def _half_rows(N1: int) -> int:
    """k1 rows stage A and stage B run on: N1/2 + 1 for even N1 (the rest
    fold into the inverse), all of them for odd N1."""
    return N1 // 2 + 1 if N1 % 2 == 0 else N1


def _fold_weights(N1: int, half: int):
    """Real-ifft weights over the retained k1 rows."""
    if half == N1:  # odd N1 (or N1 = 2): every row is kept, weight 1
        return np.ones(half)
    w = np.full(half, 2.0)
    w[0] = 1.0
    w[N1 // 2] = 1.0
    return w


def _pin_fp32():
    """Switch TF32 off for float32 matmuls and cuDNN (10-bit mantissa,
    far off the 1e-6 bar)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_enabled() -> bool:
    """Whether either TF32 switch is on."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def resolve_route(route=None) -> str:
    """``route``, or when it is None the environment's: ``"full"`` if
    ``XCORR_FFT4_FULL=1``, else ``"acc"`` if ``XCORR_FFT4_FUSED_INV=1``,
    else ``"corr"``. Any name outside :data:`ROUTES` raises
    ``ValueError``."""
    if route is not None:
        if route not in ROUTES:
            raise ValueError(f"route={route!r}: expected one of {ROUTES}")
        return route
    if os.environ.get("XCORR_FFT4_FULL", "0") == "1":
        return "full"
    if os.environ.get("XCORR_FFT4_FUSED_INV", "0") == "1":
        return "acc"
    return "corr"


class FusedPlan:
    """The four-step correlation ``plan(x, y) -> ccf`` for one window
    length, lag window and route. Host constants are built once; their
    device copies are made on first use per device.

    x, y: ``(B, n)`` float32 on one device. Output: ``(B, index_max -
    index_min)`` float32 in fftshifted lag order.
    """

    def __init__(self, n, index_min, index_max, n1, normalize,
                 route="corr", pre_padded=False):
        # check the geometry before _plan builds its (N1, N2) tables
        check_geometry(_pick_factors(2 * n - 1, n1)[1], ROUTE_KERNEL[route])
        self.route = route
        p = _plan(n, index_min, index_max, n1)
        N1, N2 = p["N1"], p["N2"]
        half = _half_rows(N1)
        self.n, self.N1, self.N2, self.N = n, N1, N2, p["N"]
        self.rows_in, self.half = p["rows_in"], half
        #: samples per input row: n, or the stage-A length rows_in * N2
        #: for a pre-padded plan (the tail beyond n zero)
        self.width = self.rows_in * N2 if pre_padded else n
        self.normalize = normalize
        self.segs_flat = p["segs_flat"]
        # (2*half, rows_in): [re rows | im rows] of the pruned W1, so ONE
        # matmul per signal yields the packed (B, 2, half, N2) planes
        W1 = p["W1"][:half]
        self._w1 = np.concatenate([W1.real, W1.imag]).astype(np.float32)
        # Re(sum_k w(k) W1inv[r,k] C(k)) = Wi_re·cr - Wi_im·ci as ONE
        # matmul over the packed axis: (rows_out, 2*half)
        Wi = p["W1inv"][:, :half] * _fold_weights(N1, half)[None, :]
        self._wi = np.concatenate([Wi.real, -Wi.imag],
                                  axis=1).astype(np.float32)
        T = p["T"][:half]
        self._t = np.stack([T.real, T.imag]).astype(np.float32)
        self.rows_out = self._wi.shape[0]
        self._dev = {}
        _pin_fp32()

    def device_consts(self, device):
        key = str(device)
        c = self._dev.get(key)
        if c is None:
            c = tuple(torch.from_numpy(a).to(device)
                      for a in (self._w1, self._wi, self._t))
            self._dev[key] = c
        return c

    def padded(self, v):
        """``(B, n)`` -> the zero-padded ``(B, rows_in, N2)`` window; a
        pre-padded ``(B, rows_in * N2)`` window is only viewed so."""
        pad = self.rows_in * self.N2 - v.shape[1]
        if pad:
            v = torch.nn.functional.pad(v, (0, pad))
        return v.view(v.shape[0], self.rows_in, self.N2)

    def stage_a(self, v, w1):
        """``(B, n)`` -> packed ``(B, 2, half, N2)`` slow-axis spectrum."""
        return torch.matmul(w1, self.padded(v)).view(
            v.shape[0], 2, self.half, self.N2)

    def inverse(self, c, wi):
        """Packed stage-B output -> ``(B, rows_out * N2)`` pruned rows."""
        B = c.shape[0]
        out = torch.matmul(wi, c.view(B, 2 * self.half, self.N2))
        return out.view(B, -1)

    def __call__(self, x, y):
        if x.dtype != torch.float32 or y.dtype != torch.float32:
            raise TypeError("the four-step path takes float32 windows")
        if x.dim() != 2 or x.shape != y.shape or x.shape[1] != self.width:
            raise ValueError(f"expected two (B, {self.width}) tensors, got "
                             f"{tuple(x.shape)} and {tuple(y.shape)}")
        if tf32_enabled():
            raise RuntimeError(
                "TF32 was switched back on after the plan was built; the "
                "four-step products need full float32")
        w1, wi, t = self.device_consts(x.device)
        B = x.shape[0]
        if self.route == "full":
            out = fused_corr_full(self.padded(x), self.padded(y), w1, t,
                                  wi).view(B, -1)
        elif self.route == "acc":
            out = fused_corr_acc(self.stage_a(x, w1), self.stage_a(y, w1),
                                 t, wi).view(B, -1)
        else:
            c = fused_corr(self.stage_a(x, w1), self.stage_a(y, w1), t)
            out = self.inverse(c, wi)
        return _finish_ccf(out, x, y, self.segs_flat, self.normalize)


def plan_correlate4(n: int, index_min: int = None, index_max: int = None,
                    n1: int = None, normalize: bool = True,
                    route: str = None,
                    pre_padded: bool = False) -> FusedPlan:
    """The four-step correlation ``f(x, y) -> ccf`` for windows of ``n``
    samples, on ``route`` (see :func:`resolve_route`: None reads the
    environment, on every call). The route is resolved first, then
    ``n1`` defaults to the route's own (:func:`_default_n1`). Raises
    ``ValueError`` when N2 is not a power of two the route's kernel takes
    (``fused_fft.MAX_N2``).

    ``pre_padded=True`` takes ``(B, padded_len(n))`` windows whose tail
    beyond ``n`` is zero (the JAX package's ``pre_padded``): the plan
    then skips its zero-extension copy. The norms are unchanged by the
    zero tail."""
    nn = 2 * n - 1
    index_min = 0 if index_min is None else index_min
    index_max = nn if index_max is None else index_max
    route = resolve_route(route)
    n1 = n1 or _default_n1(nn, route)
    return _build_plan(n, index_min, index_max, n1, normalize, route,
                       pre_padded)


@lru_cache(maxsize=32)
def _build_plan(n, index_min, index_max, n1, normalize, route, pre_padded):
    return FusedPlan(n, index_min, index_max, n1, normalize, route,
                     pre_padded)
