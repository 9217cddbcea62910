r"""
:mod:`ops.fft4` -- Four-step (Cooley-Tukey) pruned correlation
==============================================================

A hand-decomposed frequency-domain correlation for day-scale windows,
N = N1 x N2. Counterpart of ``xcorr_tpu/ops/fft4.py``: every
``stageb`` branch of its :func:`plan_correlate4`, each through the
hand-written kernels of :mod:`ops.fused_fft` where the JAX package runs
a Pallas kernel or an FFT.

``stageb='pallas'`` (the default; the JAX package's fused plan,
``_build_pallas_corr``) takes one of three routes:

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

**Hermitian half-row pruning** (the kernel routes): x and y are real, so
the time-domain rows pair as ``C(N1-k1) = conj(C(k1))``. Stage A and
stage B therefore run on the first ``H = N1/2 + 1`` rows only, and the
mirror rows fold into the pruned inverse as the real-ifft weights (2,
except 1 at k1 = 0 and N1/2).

``stageb='fft'`` and ``'matmul'`` (:class:`StageBPlan`, the JAX
package's XLA branches) run the same three stages over **all N1 rows**,
stage B as two forward row transforms, the cross spectrum and one
inverse:

* ``'fft'``: K2, :func:`ops.fused_fft.stageb_fwd` on x and on y, then
  :func:`ops.fused_fft.stageb_inv`; the spectra stay in K2's order
  (:func:`ops.fused_fft.spectrum_order`), which the correlation never
  needs undone. ``packed=True`` transforms ``x + iy`` once and forms the
  cross spectrum from ``Z`` and its frequency reversal ``Z(-k)``
  (:func:`_freq_reverse2`), taken as one gather in K2's order;
* ``'matmul'``: the six-step form, each row's DFT as two ``torch.matmul``
  products over a split N2 = P x Q (:func:`_split_pq`) with an inner
  twiddle, and its exact adjoint for the inverse.

Geometry: N2 is a power of two. On the kernel routes it is at most what
the route's kernel takes (``fused_fft.MAX_N2``: 16384 on every route)
and the default ``n1`` is the route's own, the smallest multiple of 16
that brings N2 down to that limit: at n = 4,320,000 (24 h at 50 Hz)
n1 = 528, N2 = 16384, H = 265, rows_in = 264, rows_out = 99 on the 0-9 h
lag window. The ``'fft'`` and ``'matmul'`` branches default to the JAX
package's n1 = 576 (N2 = 16384, all 576 rows; ``'fft'`` takes N2 up to
K2's 16384).

Precision (``precision=``, the JAX package's names): ``'high'`` (the
default), ``'high3'`` and ``'highest'`` run the plan's ``torch.matmul``
products in full float32 and K3's and K4's products as three TF32 passes
(``hi·hi + hi·lo + lo·hi`` with ``lo = a - hi``), float32-level products
held to the 1e-6 bar; ``'default'`` is the speed knob: on the kernel
routes it runs the ``torch.matmul`` products in TF32 and K3's and K4's
as one TF32 pass, on the ``'fft'`` and ``'matmul'`` branches stage A
alone in TF32 (:class:`StageBPlan`). K1 and K2 hold no products. TF32
is switched on only around a ``'default'`` call's products
(:func:`ops.precision.products`), while the call holds the lock that
every float32 product of the port takes, and every call checks under
it that TF32 is off (:func:`_plan_call`). A kernel-route ``'default'``
plan keeps the pruned inverse's 1/N1 out of its TF32 product and
applies it in float32 to the lag window: TF32 would round it (1/528 by
up to 2^-11) and so scale every lag by the same error. ``'high_block'`` is taken where
the JAX package takes it, the ``corr`` route, as ``'high'``.

``mesh=`` (``stageb='fft'|'matmul'``): the JAX package's
sequence-parallel split, on a :class:`..parallel.mesh.Mesh`. The batch
axis splits windows and the seq axis the k1 rows: each seq entry runs
stage A, stage B and its partial pruned inverse on its rows, on its own
device, and the partials of one batch share are summed in seq order on
that share's first device (:func:`..parallel.mesh.split2`).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .cc import row_norm
from .fft import next_fast_len
from .fused_fft import (MAX_N2, check_geometry, fused_corr, fused_corr_acc,
                        fused_corr_full, spectrum_order, stageb_fwd,
                        stageb_inv)
from .precision import lock, pin_fp32, products, tf32_enabled

__all__ = ["plan_correlate4", "correlate4", "padded_len", "traffic_model",
           "resolve_route", "ROUTES", "STAGEB", "PRECISIONS"]

#: the correlation routes and the kernel of ops.fused_fft each launches
ROUTE_KERNEL = {"corr": "fused_corr", "acc": "fused_corr_acc",
                "full": "fused_corr_full"}
ROUTES = tuple(ROUTE_KERNEL)
#: stage-B forms, with the JAX package's names: the kernel routes, K2, the
#: six-step products
STAGEB = ("pallas", "fft", "matmul")
#: default n1 of the 'fft' and 'matmul' branches (the JAX package's)
STAGEB_N1 = 576
#: product precisions, with the JAX package's names
PRECISIONS = ("default", "high", "high3", "highest", "high_block")


def _default_n1(nn: int, route: str = "corr") -> int:
    """Smallest multiple of 16 that brings N2 down to the largest row
    the route's kernel takes."""
    rows = -(-nn // MAX_N2[ROUTE_KERNEL[route]])  # ceil(nn / max N2)
    return max(16, -(-rows // 16) * 16)


def _pick_factors(nn: int, n1: int):
    """N1 x N2 >= nn with N2 a power of two (the kernel's radix-2
    transforms)."""
    return n1, next_fast_len(-(-nn // n1), radices=(2,))


def padded_len(n: int, n1: int = None, route: str = "corr",
               stageb: str = "pallas") -> int:
    """Stage-A input length ``rows_in * N2`` for a window of ``n``
    samples, in the default geometry of ``stageb`` (and, for
    ``'pallas'``, of ``route``) unless ``n1`` is given."""
    nn = 2 * n - 1
    if n1 is None:
        n1 = _default_n1(nn, route) if stageb == "pallas" else STAGEB_N1
    _, N2 = _pick_factors(nn, n1)
    return -(-n // N2) * N2


def _split_pq(n2: int):
    """Factor N2 = P x Q with P, Q as close to sqrt(N2) as possible."""
    best = None
    p = int(np.sqrt(n2))
    while p >= 2:
        if n2 % p == 0:
            best = (max(p, n2 // p), min(p, n2 // p))
            break
        p -= 1
    if best is None:
        raise ValueError(f"N2={n2} has no usable factorization")
    return best


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


def _finish_ccf(out_flat, x, y, segs_flat, normalize, scale=None):
    """Correlation epilogue: lag-window slice, the pruned inverse's 1/N1
    where the plan left it out of its products (``scale``), optional norm
    division, output dtype."""
    r = _take_lag_window(out_flat, segs_flat)
    if scale is not None:
        r = r * scale
    if normalize:
        denom = row_norm(x) * row_norm(y)
        r = r / torch.where(denom == 0, torch.ones_like(denom), denom)
    return r.to(x.dtype)


def _freq_reverse2(Z):
    """Frequency reversal Z(-k) in the permuted (k1, k2) layout of the
    last two axes (natural order in each).

    k = k2*N1 + k1, so -k mod N maps to k1' = (-k1) % N1 with a carry
    into the fast axis: k2' = (-k2) % N2 when k1 == 0 but
    (-k2 - 1) % N2 when k1 > 0. Row-reverse first, then: row 0 gets the
    head-fixed column reversal, rows 1.. get the plain flip."""
    def rev_headfix(a, dim):
        return torch.cat([a.narrow(dim, 0, 1),
                          a.narrow(dim, 1, a.shape[dim] - 1).flip(dim)], dim)

    R = rev_headfix(Z, -2)
    row0 = rev_headfix(R.narrow(-2, 0, 1), -1)
    return torch.cat([row0, R.narrow(-2, 1, R.shape[-2] - 1).flip(-1)], -2)


def _packed_reverse_index(N1: int, N2: int):
    """Flat gather index of :func:`_freq_reverse2` on spectra in K2's
    order: ``Zr.flat = Z.flat[index]`` for (N1, N2) planes whose columns
    hold ``spectrum_order(N2)``. Natural position (k1, f) of a column p
    is ``(k1, order[p])``; its reversal's natural position (k1', f') is
    at column ``inverse_order[f']`` of K2's plane."""
    order = spectrum_order(N2).numpy()
    inv = np.empty_like(order)
    inv[order] = np.arange(N2)
    rev = _freq_reverse2(torch.arange(N1 * N2).view(N1, N2)).numpy()
    m = rev[:, order]                 # natural flat index of the reversal
    return torch.from_numpy(((m // N2) * N2 + inv[m % N2]).reshape(-1))


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


@contextmanager
def _plan_call():
    """One plan call, under :data:`ops.precision.lock`: its products set
    the TF32 switch only through :func:`ops.precision.products`, and no
    other thread's 'default' products run meanwhile. Raises if TF32 was
    switched on outside a plan."""
    with lock:
        if tf32_enabled():
            raise RuntimeError(
                "TF32 was switched back on after the plan was built; the "
                "four-step products need full float32")
        yield


def _check_precision(precision: str, stageb: str, route):
    """``precision`` is one of :data:`PRECISIONS` that the plan takes:
    ``'high_block'`` only on the ``corr`` route, as the JAX package's
    fused corr plan alone takes it (its accumulator and full plans raise,
    its XLA branches have no such precision)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: expected one of {PRECISIONS}")
    if precision == "high_block" and route != "corr":
        raise ValueError(
            "precision='high_block' is not supported by this plan "
            f"(stageb={stageb!r}, route={route!r}); it is the corr "
            "route's alias of 'high'")


def _check_inputs(x, y, width):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("the four-step path takes float32 windows")
    if x.dim() != 2 or x.shape != y.shape or x.shape[1] != width:
        raise ValueError(f"expected two (B, {width}) tensors, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")


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
                 route="corr", pre_padded=False, precision="high"):
        # check the geometry before _plan builds its (N1, N2) tables
        check_geometry(_pick_factors(2 * n - 1, n1)[1], ROUTE_KERNEL[route])
        self.route = route
        self.precision = precision
        #: TF32 passes of K3's and K4's products
        self.passes = 1 if precision == "default" else 3
        p = _plan(n, index_min, index_max, n1)
        #: the inverse's 1/N1, applied after the products when TF32 runs
        #: them (module docstring), else kept in ``wi``
        self.scale = 1.0 / p["N1"] if precision == "default" else None
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
        if self.scale is not None:
            Wi = Wi * N1
        self._wi = np.concatenate([Wi.real, -Wi.imag],
                                  axis=1).astype(np.float32)
        T = p["T"][:half]
        self._t = np.stack([T.real, T.imag]).astype(np.float32)
        self.rows_out = self._wi.shape[0]
        self._dev = {}
        pin_fp32()

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
        _check_inputs(x, y, self.width)
        w1, wi, t = self.device_consts(x.device)
        B = x.shape[0]
        with _plan_call(), products(self.precision == "default"):
            if self.route == "full":
                out = fused_corr_full(self.padded(x), self.padded(y), w1, t,
                                      wi, self.passes).view(B, -1)
            elif self.route == "acc":
                out = fused_corr_acc(self.stage_a(x, w1),
                                     self.stage_a(y, w1), t, wi,
                                     self.passes).view(B, -1)
            else:
                c = fused_corr(self.stage_a(x, w1), self.stage_a(y, w1), t)
                out = self.inverse(c, wi)
        return _finish_ccf(out, x, y, self.segs_flat, self.normalize,
                           self.scale)


def _cmul(a, t, dim, conj=False):
    """``a * t`` (``a * conj(t)``) of complex planes held as re, im on
    axis ``dim`` (negative, so ``t`` broadcasts from the right)."""
    ar, ai = a.unbind(dim)
    tr, ti = t.unbind(dim)
    if conj:
        ti = -ti
    return torch.stack([ar * tr - ai * ti, ar * ti + ai * tr], dim)


def _left(m, a):
    """``M @ A`` over the second-to-last axis of complex ``(..., 2, P,
    Q)`` planes, ``m`` the real block ``[[Mr, -Mi], [Mi, Mr]]``: one
    real product on the stacked ``[re; im]`` rows."""
    s = a.shape
    return torch.matmul(m, a.reshape(-1, 2 * s[-2], s[-1])).view(s)


def _right(m, a):
    """``A @ M`` over the last axis of complex ``(..., 2, P, Q)`` planes,
    ``m`` the real ``[Mr | Mi]``: one real product on the stacked rows,
    whose four re/im blocks combine into the complex result."""
    s = a.shape
    z = torch.matmul(a.reshape(-1, 2 * s[-2], s[-1]), m).view(
        -1, 2, s[-2], 2, s[-1])
    return torch.stack([z[:, 0, :, 0] - z[:, 1, :, 1],
                        z[:, 0, :, 1] + z[:, 1, :, 0]], 1).view(s)


def _six_step_consts(N2: int):
    """The six-step row transform's real matrices (``xcorr_tpu/ops/
    fft4.py``'s ``fwd2``/``inv2`` over N2 = P x Q), float32: forward
    ``WP @ A``, inner twiddle ``T2``, ``A @ WQ^T``; the inverse, its
    exact adjoint over N2, ``S @ conj(WQ) / Q``, ``conj(T2)``,
    ``conj(WP)^T @ S / P``. The spectrum position ``k_p·Q + k_q`` holds
    frequency ``k_p + P·k_q``; only the inverse reads it."""
    P, Q = _split_pq(N2)
    WP = np.exp(-2j * np.pi * np.outer(np.arange(P), np.arange(P)) / P)
    WQ = np.exp(-2j * np.pi * np.outer(np.arange(Q), np.arange(Q)) / Q)
    T2 = np.exp(-2j * np.pi * np.outer(np.arange(P), np.arange(Q)) / N2)

    def left(M):
        return np.block([[M.real, -M.imag], [M.imag, M.real]])

    def right(M):
        return np.concatenate([M.real, M.imag], axis=1)

    mats = {"fp": left(WP), "t2": np.stack([T2.real, T2.imag]),
            "fq": right(WQ.T), "iq": right(WQ.conj() / Q),
            "ip": left(WP.conj().T / P)}
    return P, Q, {k: v.astype(np.float32) for k, v in mats.items()}


class StageBPlan:
    """The four-step correlation's ``stageb='fft'|'matmul'`` branches
    (the JAX package's XLA branches) over all N1 rows, optionally
    ``packed`` (``'fft'`` only) and split over a ``mesh`` (windows over
    its batch axis, k1 rows over its seq axis). Same inputs and output as
    :class:`FusedPlan`.

    Under ``precision='default'`` only stage A, the product on the
    windows, runs in TF32; the six-step's products and the pruned
    inverse stay float32. With every product in TF32 the rounding of
    the constant DFT matrices, the same for every row, reached every
    lag: at day scale on an H100 ``'matmul'`` came 1.1e-4 off the
    float64 oracle and ``'fft'`` 9.7e-5, over the 1e-4 bar; with stage
    A alone, 1.4e-5.

    Layouts: the ``'fft'`` branch keeps K2's packed ``(B, 2, R, N2)``
    planes (re rows, then im rows); the ``'matmul'`` branch keeps
    ``(B, R, 2, N2)`` (re and im of each row together), so that a row's
    ``(2, P, Q)`` block feeds the six-step's products without a copy.
    The stage-A matrix, T and the pruned inverse's columns are stored in
    the branch's order. Host constants are built once; their device
    copies are made on first use per device and row range.
    """

    def __init__(self, n, index_min, index_max, n1, normalize, stageb,
                 packed=False, precision="high", pre_padded=False,
                 mesh=None, mesh_axes=("batch", "seq")):
        N2 = _pick_factors(2 * n - 1, n1)[1]
        if stageb == "fft":
            # K2's geometry, before _plan builds its (N1, N2) tables
            check_geometry(N2, "stageb_fwd")
        self.stageb, self.packed, self.precision = stageb, packed, precision
        self.mesh, self.mesh_axes = mesh, tuple(mesh_axes)
        p = _plan(n, index_min, index_max, n1)
        self.n, self.N1, self.N2, self.N = n, p["N1"], N2, p["N"]
        self.rows_in = p["rows_in"]
        self.width = self.rows_in * N2 if pre_padded else n
        self.normalize = normalize
        self.segs_flat = p["segs_flat"]
        W1, T, Wi = p["W1"], p["T"], p["W1inv"]
        # Re(sum_k W1inv[r,k] C(k)) = Wi_re·cr - Wi_im·ci
        self._w1 = np.stack([W1.real, W1.imag])          # (2, N1, rows_in)
        self._t = np.stack([T.real, T.imag])              # (2, N1, N2)
        self._wi = np.stack([Wi.real, -Wi.imag], axis=1)  # (rows_out, 2, N1)
        self.rows_out = self._wi.shape[0]
        if stageb == "matmul":
            self.P, self.Q, self._six = _six_step_consts(N2)
        self._dev = {}
        pin_fp32()

    def _cached(self, key, make):
        c = self._dev.get(key)
        if c is None:
            c = self._dev[key] = make()
        return c

    def row_consts(self, device, lo, hi):
        """``(w1, t, wi)`` of k1 rows ``lo:hi`` on ``device``, in the
        branch's layout: ``w1`` ``(2R, rows_in)``, ``t`` ``(2, R, N2)``
        (``'fft'``) or ``(R, 2, N2)`` (``'matmul'``), ``wi``
        ``(rows_out, 2R)``; each contiguous."""
        def make():
            w1, t = self._w1[:, lo:hi], self._t[:, lo:hi]
            wi = self._wi[:, :, lo:hi]
            if self.stageb == "matmul":
                w1, t = w1.transpose(1, 0, 2), t.transpose(1, 0, 2)
                wi = wi.transpose(0, 2, 1)
            return tuple(
                torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(
                    device)
                for m in (w1.reshape(-1, self.rows_in), t,
                          wi.reshape(self.rows_out, -1)))
        return self._cached((str(device), lo, hi), make)

    padded = FusedPlan.padded

    def stage_a(self, v, w1):
        """``(B, n)`` -> the rows' slow-axis spectrum in the branch's
        layout."""
        with products(self.precision == "default"):
            a = torch.matmul(w1, self.padded(v))
        if self.stageb == "fft":
            return a.view(v.shape[0], 2, -1, self.N2)
        return a.view(v.shape[0], -1, 2, self.N2)

    def _fft(self, x, y, w1, t):
        """Stage B through K2: ``(B, 2, R, N2)`` rows of C."""
        if not self.packed:
            return stageb_inv(stageb_fwd(self.stage_a(x, w1), t),
                              stageb_fwd(self.stage_a(y, w1), t), t)
        ax, ay = self.stage_a(x, w1), self.stage_a(y, w1)
        # the slow-axis spectrum of x + iy, then its transform
        z = stageb_fwd(torch.stack([ax[:, 0] - ay[:, 1],
                                    ax[:, 1] + ay[:, 0]], 1), t)
        del ax, ay
        B = z.shape[0]
        dev = z.device
        rev = self._cached((str(dev), "reverse"), lambda: (
            _packed_reverse_index(self.N1, self.N2).to(dev)))
        zr = z.view(B, 2, -1).index_select(-1, rev).view(z.shape)
        a, b = z.unbind(1)
        c, d = zr.unbind(1)
        # S = (1/2) Im(Z Z(-k)) + (i/4)(|Z|^2 - |Z(-k)|^2)
        s = torch.stack([0.5 * (a * d + b * c),
                         0.25 * ((a * a + b * b) - (c * c + d * d))], 1)
        del z, zr, a, b, c, d
        # the unit spectrum (conj 1 = 1), one window that K2 inv reads
        # for every window of S
        ones = self._cached((str(dev), "ones"), lambda: torch.stack(
            [torch.ones_like(t[0]), torch.zeros_like(t[0])])[None])
        return stageb_inv(s, ones, t)

    def _matmul(self, x, y, w1, t):
        """Stage B as the six-step products: ``(B, R, 2, N2)`` rows of
        C."""
        six = self._cached((str(x.device), "six"), lambda: {
            k: torch.from_numpy(v).to(x.device)
            for k, v in self._six.items()})
        P, Q = self.P, self.Q

        def fwd(v):
            a = self.stage_a(v, w1)
            a = _cmul(a, t, -2).view(-1, 2, P, Q)
            a = _cmul(_left(six["fp"], a), six["t2"], -3)
            return _right(six["fq"], a)

        s = _cmul(fwd(x), fwd(y), -3, conj=True)
        s = _cmul(_right(six["iq"], s), six["t2"], -3, conj=True)
        s = _left(six["ip"], s).view(x.shape[0], -1, 2, self.N2)
        return _cmul(s, t, -2, conj=True)

    def partial(self, x, y, lo, hi):
        """The pruned inverse's sum over k1 rows ``lo:hi`` of windows on
        one device: ``(B, rows_out * N2)``."""
        w1, t, wi = self.row_consts(x.device, lo, hi)
        stage_b = self._fft if self.stageb == "fft" else self._matmul
        c = stage_b(x, y, w1, t)
        B = x.shape[0]
        return torch.matmul(wi, c.reshape(B, -1, self.N2)).view(B, -1)

    def __call__(self, x, y):
        _check_inputs(x, y, self.width)
        with _plan_call():
            if self.mesh is None:
                out = self.partial(x, y, 0, self.N1)
                return _finish_ccf(out, x, y, self.segs_flat,
                                   self.normalize)
            from ..parallel.mesh import split2
            parts = []
            for a, b, entries in split2(self.mesh, x.shape[0], self.N1,
                                        self.mesh_axes):
                ins = [(x[a:b].to(d, non_blocking=True),
                        y[a:b].to(d, non_blocking=True), lo, hi)
                       for d, lo, hi in entries]
                partials = [self.partial(*i) for i in ins]
                # summed in seq order on the share's first device: the
                # same bits whatever the cards' timing
                d0 = entries[0][0]
                out = partials[0]
                for q in partials[1:]:
                    out = out + q.to(d0, non_blocking=True)
                parts.append(_finish_ccf(out, ins[0][0], ins[0][1],
                                         self.segs_flat, self.normalize))
            return torch.cat([q.to(x.device) for q in parts])


def plan_correlate4(n: int, index_min: int = None, index_max: int = None,
                    n1: int = None, normalize: bool = True,
                    route: str = None, pre_padded: bool = False, *,
                    stageb: str = "pallas", packed: bool = False,
                    precision: str = "high", mesh=None,
                    mesh_axes=("batch", "seq")):
    """The four-step correlation ``f(x, y) -> ccf`` for windows of ``n``
    samples.

    ``stageb='pallas'`` (the default, the port's counterpart of what
    ``ops.cc.correlate`` picks on an accelerator) returns a
    :class:`FusedPlan` on ``route`` (see :func:`resolve_route`: None
    reads the environment, on every call); the route is resolved first,
    then ``n1`` defaults to the route's own (:func:`_default_n1`).
    ``stageb='fft'|'matmul'`` returns a :class:`StageBPlan` with the JAX
    package's branches and default n1 = 576; ``route`` is not read.
    Raises ``ValueError`` when N2 is not a power of two the plan's
    kernel takes (``fused_fft.MAX_N2``).

    ``pre_padded=True`` takes ``(B, padded_len(n))`` windows whose tail
    beyond ``n`` is zero (the JAX package's ``pre_padded``): the plan
    then skips its zero-extension copy. The norms are unchanged by the
    zero tail.

    ``packed=True`` (``stageb='fft'`` only): one forward transform of
    ``x + iy``; the cross spectrum is ``(i/4)(|Z|^2 - |Z(-k)|^2) + (1/2)
    Im(Z·Z(-k))``, which loses accuracy on the difference of magnitudes.

    ``precision``: one of :data:`PRECISIONS` (module docstring).

    ``mesh`` (``stageb='fft'|'matmul'``, not ``packed``): a
    :class:`..parallel.mesh.Mesh`; ``mesh_axes = (batch_axis, seq_axis)``
    name its axes that split the windows and the k1 rows, and a name the
    mesh lacks (or None) splits nothing. The result is gathered in row
    order onto the inputs' device. ``stageb='pallas'`` with a mesh
    raises ``ValueError``: the kernel routes are single-chip."""
    if stageb not in STAGEB:
        raise ValueError(f"stageb={stageb!r}: expected one of {STAGEB}")
    if packed and stageb != "fft":
        raise ValueError("packed Hermitian split assumes natural fast-axis "
                         "frequency order; use stageb='fft' with packed")
    if mesh is not None:
        if stageb == "pallas":
            raise ValueError(
                "sequence-parallel meshes need stageb='fft' or 'matmul'; "
                "the kernel routes (stageb='pallas') are single-chip")
        if packed:
            raise ValueError(
                "packed Hermitian split frequency-reverses across k1 rows, "
                "which a seq split divides; use packed=False with mesh")
    nn = 2 * n - 1
    index_min = 0 if index_min is None else index_min
    index_max = nn if index_max is None else index_max
    if stageb == "pallas":
        route = resolve_route(route)
        n1 = n1 or _default_n1(nn, route)
    else:
        route, n1 = None, n1 or STAGEB_N1
    _check_precision(precision, stageb, route)
    return _build_plan(n, index_min, index_max, n1, normalize, route,
                       pre_padded, stageb, packed, precision, mesh,
                       tuple(mesh_axes))


@lru_cache(maxsize=32)
def _build_plan(n, index_min, index_max, n1, normalize, route, pre_padded,
                stageb, packed, precision, mesh, mesh_axes):
    if stageb == "pallas":
        return FusedPlan(n, index_min, index_max, n1, normalize, route,
                         pre_padded, precision)
    return StageBPlan(n, index_min, index_max, n1, normalize, stageb,
                      packed, precision, pre_padded, mesh, mesh_axes)


def correlate4(x, y, index_min: int = None, index_max: int = None,
               normalize: bool = True, n1: int = 512, stageb: str = "fft",
               device="cuda"):
    """One-shot four-step correlation of two ``(B, n)`` float32 tensors
    or arrays, with the JAX package's one-shot defaults. A tensor stays
    on its device; an array goes to ``device``, by default the card,
    which raises when torch sees none (pass ``device='cpu'`` to run on
    the host)."""
    device = torch.device(device)
    if device.type == "cuda" and not (isinstance(x, torch.Tensor)
                                      and isinstance(y, torch.Tensor)):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch sees no CUDA device; "
                "pass device='cpu' or CPU tensors to correlate on the host")
    x, y = (v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for v in (x, y))
    return plan_correlate4(x.shape[-1], index_min, index_max, n1=n1,
                           normalize=normalize, stageb=stageb)(x, y)


def traffic_model(n: int, index_min: int = None, index_max: int = None,
                  n1: int = None, batch: int = 16) -> int:
    """Device-memory bytes of one ``corr``-route correlation batch, the
    JAX package's count at the port's geometry (H = N1/2 + 1 rows, no
    8-row rounding; ``n1`` defaults to the route's own).

    Each tensor counts once per producing and consuming pass: stage A
    reads the padded inputs and writes 4 float32 planes (re/im x 2
    signals); the kernel reads those and writes the 2 correlation
    planes; the pruned inverse reads both planes and writes the out_rows
    block; the lag-window slice copies the result. Divide by the card's
    bytes/s for a share of its bound."""
    nn = 2 * n - 1
    index_min = 0 if index_min is None else index_min
    index_max = nn if index_max is None else index_max
    p = _plan(n, index_min, index_max, n1 or _default_n1(nn))
    N2, rows_in = p["N2"], p["rows_in"]
    f = 4  # float32
    plane = _half_rows(p["N1"]) * N2 * f
    stage_a = 2 * (rows_in * N2 * f + 2 * plane)   # read A, write re+im
    kernel = 4 * plane + 2 * plane                 # read 4, write 2
    inverse = 2 * plane + len(p["out_rows"]) * N2 * f
    window = 2 * (index_max - index_min) * f
    return batch * (stage_a + kernel + inverse + window)
