"""TL2's row route (``xcorr_tpu_torch/ops/cells.py``: ``row_plan``,
``inverse_argmax``, ``product_peaks``; ``xcorr_tpu_torch/csrc/cells.cu``:
``xc_inverse_argmax``) on the CPU, where the kernel cannot run.

What the kernel will run is checked here instead: ``row_plan`` for every
length ``next_fast_len`` gives up to past the shared-memory limit; a
float64 numpy model of the kernel's algorithm (the in-place Hermitian
extension and packing of two rows, term pair by term pair as the
kernel's threads take them; the decimation-in-frequency passes in
``row_plan``'s order with ``row_twiddles``; the digit-reversed read of
its reduction) held to ``numpy.fft.irfft`` within 1e-12 relative, and,
with the kernel's block reduction and join, to ``inverse_argmax_plain``;
``product_peaks`` on the CPU giving the bits of the composition it
replaced, against the JAX package too; and the wrappers' refusals.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import cells
from xcorr_tpu_torch.ops.fft import next_fast_len

#: every length next_fast_len gives, from 2 to past the route's limit
LENGTHS = sorted({next_fast_len(n) for n in range(2, 40_001)})
#: the model's sweep: tiny lengths, every radix alone, 8d's and the
#: widest production band's rows, and the longest rows of the route
MODEL_LENGTHS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 27, 40, 63, 81, 98,
                 243, 245, 1200, 14000, 18225, 28000, 28672, 28812]


def digits_lag(passes, nl):
    """The lag held at each position after the passes, read as the
    kernel's reduction reads it: position ``d0·M0 + s`` holds lag
    ``d0 + r0·g``, ``g`` the digit reversal of ``s`` over the later
    passes (Horner from the last pass)."""
    r0 = passes[0] if len(passes) > 0 else 1
    M0 = nl // r0
    s = np.arange(M0)
    g, x = np.zeros(M0, np.int64), s.copy()
    for r in passes[:0:-1]:
        g = g * r + x % r
        x //= r
    lag = np.empty(nl, np.int64)
    for d0 in range(r0):
        lag[d0 * M0 + s] = d0 + r0 * g
    return lag


def pack(raw, nl):
    """The kernel's in-place extension and packing of two half spectra
    (``raw``: ``2h`` complex, row a then row b): terms ``n`` and
    ``c - n`` read and write the same four slots; returns the packed row
    ``Ya + i·Yb`` (``nl`` values) and whether each row's used terms are
    finite."""
    h = nl // 2 + 1
    z = raw.astype(np.complex128).copy()
    c = h - 1 if nl % 2 else h - 2
    ok = [True, True]

    def term(n, a, b):
        if n == 0:
            ok[0] &= bool(np.isfinite(a.real))
            ok[1] &= bool(np.isfinite(b.real))
            z[0] = complex(a.real, b.real)
        else:
            ok[0] &= bool(np.isfinite(a.real) and np.isfinite(a.imag))
            ok[1] &= bool(np.isfinite(b.real) and np.isfinite(b.imag))
            z[n] = complex(a.real - b.imag, a.imag + b.real)
            z[nl - n] = complex(a.real + b.imag, b.real - a.imag)
    for n in range(c // 2 + 1):
        m = c - n
        a0, b0, a1, b1 = z[n], z[h + n], z[m], z[h + m]
        touched = {n, h + n, m, h + m}
        term(n, a0, b0)
        if m != n:
            term(m, a1, b1)
        # the slots written are among the slots read: no other pair's
        assert {n, nl - n if n else 0, m, nl - m if m else 0} <= touched
    if nl % 2 == 0:
        a, b = z[h - 1], z[2 * h - 1]
        ok[0] &= bool(np.isfinite(a.real))
        ok[1] &= bool(np.isfinite(b.real))
        z[h - 1] = complex(a.real, b.real)
    return z[:nl], ok


def dif(z, passes):
    """The kernel's in-place decimation-in-frequency passes, in float64:
    for each span of ``S`` values and ``j < m = S/r``, the ``r`` values
    ``j + q·m`` through the r-point inverse DFT, output ``k`` times
    ``e^{+2πi·j·k/S}`` (``e = j·k·nl/S``: ``hi[e >> TW_LO_BITS] ·
    lo[e mod 2**TW_LO_BITS]`` of :func:`cells.row_twiddles`), stored at
    ``j + k·m``. Outputs in digit-reversed order."""
    nl = z.size
    tw = cells.row_twiddles(nl)
    bits = cells.TW_LO_BITS
    lo, hi = tw[:1 << bits], tw[1 << bits:]
    S = nl
    for r in passes:
        m = S // r
        q = np.arange(r)
        F = np.exp(2j * np.pi * np.outer(q, q) / r)
        y = np.einsum("qk,bqj->bkj", F, z.reshape(nl // S, r, m))
        e = np.outer(q, np.arange(m)) * (nl // S)
        assert e.max() < nl
        z = (y * (hi[e >> bits] * lo[e & ((1 << bits) - 1)])).reshape(nl)
        S = m
    return z


def two_rows(Ya, Yb, nl):
    """Both real rows of the packed inverse, in lag order, and the
    finite flags; no transform, as in the kernel, where a row is not
    finite."""
    h = nl // 2 + 1
    z, ok = pack(np.concatenate([Ya, Yb]), nl)
    if not all(ok):
        return None, None, ok
    out = np.empty(nl, complex)
    out[digits_lag(cells.row_plan(nl).passes, nl)] = dif(
        z, cells.row_plan(nl).passes)
    assert Ya.size == Yb.size == h
    return out.real / nl, out.imag / nl, ok


def best(v, k):
    """``torch.argmax``'s winner of the pairs (v, k): the first NaN, else
    the first maximum."""
    order = np.argsort(k, kind="stable")
    v, k = v[order], k[order]
    nan = np.flatnonzero(np.isnan(v))
    i = nan[0] if nan.size else int(np.argmax(v))
    return v[i], k[i]


def model_inverse_argmax(Y, n1, n2, nl):
    """The kernel's function in float64: per block two kept rows (the
    last alone for an odd count), a non-finite row NaN at its first
    window column, else its window columns scaled by ``1/(nf·nl)``; then
    the join."""
    B, nf, _ = Y.shape
    rows, W = 2 * n1 - 1, 2 * n2 - 1
    col = (np.arange(nl) + n2 - 1) % nl      # window column of each lag
    keep = col < W
    peaks, ks = np.empty(B), np.empty(B, np.int64)
    for c in range(B):
        parts = []
        for q in range(n1):
            ia, ib = 2 * q, 2 * q + 1
            ci = [(i - (n1 - 1)) % nf for i in (ia, ib)]
            ya = Y[c, ci[0]]
            yb = Y[c, ci[1]] if ib < rows else np.zeros_like(ya)
            ra, rb, ok = two_rows(ya, yb, nl)
            if not ok[0] or (ib < rows and not ok[1]):
                parts.append((np.nan, (ia if not ok[0] else ib) * W))
                continue
            v = [ra[keep] / nf] + ([rb[keep] / nf] if ib < rows else [])
            k = [ia * W + col[keep]] + ([ib * W + col[keep]]
                                        if ib < rows else [])
            parts.append(best(np.concatenate(v), np.concatenate(k)))
        peaks[c], ks[c] = best(np.array([p[0] for p in parts]),
                               np.array([p[1] for p in parts]))
    return peaks, ks


def spectra(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- row_plan ---------------------------------------------------------------

def test_row_plan_every_length():
    """For every length next_fast_len gives from 2 to 40,000: the radices
    multiply to nl in the kernel's order (8s, one 4 or 2, 7s, 9s, 5s,
    one 3), the bytes are the two half spectra's (at least the
    reduction's) and the twiddle tables', and the route is the kernel's
    exactly where those fit SMEM_BYTES."""
    order = {8: 0, 4: 1, 2: 1, 7: 2, 9: 3, 5: 4, 3: 5}
    for nl in LENGTHS:
        plan = cells.row_plan(nl)
        assert plan.nl == nl
        assert int(np.prod(plan.passes)) == nl
        assert set(plan.passes) <= {2, 3, 4, 5, 7, 8, 9}
        ranks = [order[r] for r in plan.passes]
        assert ranks == sorted(ranks)
        assert sum(r in (2, 4) for r in plan.passes) <= 1
        assert plan.passes.count(3) <= 1
        lo = 1 << cells.TW_LO_BITS
        tables = lo + lo // 16 + -(-nl // lo)
        assert plan.smem == max(16 * (nl // 2 + 1),
                                12 * cells.ROW_THREADS) + 8 * tables
        assert (plan.route == "kernel") == (plan.smem <= cells.SMEM_BYTES)
        if plan.route == "kernel":
            assert plan.smem <= 227 * 1024


def test_row_plan_route_changes_at_the_limit():
    """The kernel's lengths are a prefix: every length up to 28,672 takes
    the kernel, every longer one the scan (28,800 and 30,000 among
    them), and the first scan length is the first whose bytes pass the
    limit."""
    kernel = [n for n in LENGTHS if cells.row_plan(n).route == "kernel"]
    scan = [n for n in LENGTHS if cells.row_plan(n).route == "scan"]
    assert kernel[-1] == 28672 < scan[0] == 28800
    assert 14000 in kernel and 18225 in kernel and 30000 in scan
    assert cells.row_plan(kernel[-1]).smem <= cells.SMEM_BYTES \
        < cells.row_plan(scan[0]).smem


@pytest.mark.parametrize("nl,device,want", [
    (18225, "cuda", True), (14000, "cuda:0", True), (30000, "cuda", False),
    (18225, "cpu", False), (143, "cuda", False)])
def test_products_in_columns_follows_the_route(nl, device, want):
    """The layout of the products is asked of ``ops.cells``: in columns
    only on a card and on the row kernel's route."""
    assert cells.products_in_columns(nl, device) is want
    assert cells.products_in_columns(nl, torch.device(device)) is want


@pytest.mark.parametrize("nl", [11, 143, 2 * 3 * 5 * 7 * 11])
def test_row_plan_other_primes_take_the_scan(nl):
    plan = cells.row_plan(nl)
    assert plan.passes is None and plan.route == "scan"


def test_row_plan_refuses_empty_rows():
    with pytest.raises(ValueError):
        cells.row_plan(0)


@pytest.mark.parametrize("nl", [1, 2, 40, 127, 128, 129, 1200, 18225])
def test_row_twiddles(nl):
    """``lo`` then ``hi``, whose products give every ``e^{+2πi·e/nl}``,
    ``e < nl``, within 1e-14 (float64 roundings); as float32, within
    2e-7."""
    tw = cells.row_twiddles(nl)
    n = 1 << cells.TW_LO_BITS
    assert tw.dtype == np.complex128 and tw.size == n + -(-nl // n)
    e = np.arange(nl)
    want = np.exp(2j * np.pi * e / nl)
    assert np.abs(tw[n + (e >> cells.TW_LO_BITS)] * tw[e % n]
                  - want).max() <= 1e-14
    t32 = tw.astype(np.complex64)
    got = t32[n + (e >> cells.TW_LO_BITS)] * t32[e % n]
    assert np.abs(got - want).max() <= 2e-7


# -- the float64 model of the kernel ----------------------------------------

@pytest.mark.parametrize("nl", MODEL_LENGTHS)
def test_model_matches_irfft(nl):
    """The packed pair's inverse gives both rows' ``irfft`` within 1e-12
    relative, DC's and Nyquist's imaginary parts ignored as irfft
    ignores them."""
    h = nl // 2 + 1
    Ya, Yb = spectra(h, nl), spectra(h, nl + 1)
    ra, rb, ok = two_rows(Ya, Yb, nl)
    assert ok == [True, True]
    for got, Y in ((ra, Ya), (rb, Yb)):
        want = np.fft.irfft(Y, n=nl)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("nl", [1, 2, 5, 12, 40, 63, 1200])
def test_model_lags_are_a_permutation(nl):
    lag = digits_lag(cells.row_plan(nl).passes, nl)
    assert np.array_equal(np.sort(lag), np.arange(nl))


@pytest.mark.parametrize("geom", [(3, 2, 7, 5, 12), (2, 3, 5, 4, 9),
                                  (2, 4, 9, 20, 40), (1, 1, 1, 1, 1),
                                  (2, 5, 10, 31, 63), (1, 2, 4, 600, 1200)],
                         ids=["even", "odd", "eights", "one", "sevens",
                              "1200"])
def test_model_window_argmax(geom):
    """The model with the kernel's block reduction and join gives
    ``inverse_argmax_plain``'s index, and its peak within 1e-12, on
    random spectra, all-zero spectra and spectra with a NaN planted in
    one kept row (the row maps to NaN at every lag). An infinity makes
    the row's inverse undefined (inf - inf): the kernel gives NaN at the
    first window column of the first row that holds one, where the plain
    version gives its transform's own mix of infinities and NaNs."""
    B, n1, nf, n2, nl = geom
    h = nl // 2 + 1
    W = 2 * n2 - 1
    Y = spectra((B, nf, h), nl)
    rows = [(i - (n1 - 1)) % nf for i in range(2 * n1 - 1)]

    def planted(bad):
        P = Y.copy()
        P[-1, rows[-1], h // 2] = bad          # the last kept row
        first = {B - 1: len(rows) - 1}
        if len(rows) > 1:
            P[0, rows[1], h - 1] = bad         # the second kept row
            first[0] = min(first.get(0, 1), 1)
        return P, first
    for Yc in (Y, np.zeros_like(Y), planted(complex(np.nan, np.nan))[0]):
        pk, k = model_inverse_argmax(Yc, n1, n2, nl)
        want = cells.inverse_argmax_plain(torch.from_numpy(Yc), n1, n2, nl)
        np.testing.assert_array_equal(k, want[1].numpy())
        np.testing.assert_allclose(pk, want[0].numpy(), rtol=0, atol=1e-12)
    Yc, first = planted(complex(np.inf, 0.0))
    pk, k = model_inverse_argmax(Yc, n1, n2, nl)
    want = cells.inverse_argmax_plain(torch.from_numpy(Yc), n1, n2, nl)
    for c, i in first.items():
        assert np.isnan(pk[c]) and k[c] == i * W
        assert not np.isfinite(want[0][c].item())


# -- the wrappers on the CPU ------------------------------------------------

def products(B, nf, h, seed=0, dtype=np.complex64):
    return torch.from_numpy(spectra((B, nf, h), seed).astype(dtype))


@pytest.mark.parametrize("geom", [(4, 3, 9, 5, 20), (2, 1, 1, 600, 1200),
                                  (3, 8, 15, 7, 30000)],
                         ids=["small", "one-row", "scan-length"])
def test_product_peaks_cpu_is_the_composition(geom):
    """On the CPU, ``product_peaks`` gives the bits of the composition it
    took the place of, ``circular_argmax(irfft2(P))``, on either route's
    length; ``inverse_argmax`` gives its plain version's on the unscaled
    column inverse the main path gives it; nothing counts as a launch."""
    B, n1, nf, n2, nl = geom
    P = products(B, nf, nl // 2 + 1)
    before = dict(cells.launches)
    got = cells.product_peaks(P, n1, n2, nl)
    want = cells.circular_argmax_plain(torch.fft.irfft2(P, s=(nf, nl)),
                                       n1, n2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    Y = torch.fft.ifft(P, dim=-2, norm="forward")
    for g, w in zip(cells.inverse_argmax(Y, n1, n2, nl),
                    cells.inverse_argmax_plain(Y, n1, n2, nl)):
        assert torch.equal(g, w)
    assert cells.launches == before


def test_product_peaks_against_jax():
    """``product_peaks`` on the CPU against the JAX package's step
    (``_corr_step``'s inverse, fftshift slices and argmax): the peaks of
    the same products within 1e-6, the flat indices equal."""
    import jax.numpy as jnp
    from xcorr_tpu.ops.cc import lag_slice_of_circular
    n1, n2, nf, nl = 5, 9, 9, 18
    P = products(6, nf, nl // 2 + 1, seed=3)
    pk, k = cells.product_peaks(P, n1, n2, nl)
    r = jnp.fft.irfft2(jnp.asarray(P.numpy()), s=(nf, nl))
    r = lag_slice_of_circular(jnp.moveaxis(r, -2, -1), n1, nf, 0,
                              2 * n1 - 1)
    r = lag_slice_of_circular(jnp.moveaxis(r, -1, -2), n2, nl, 0,
                              2 * n2 - 1)
    flat = np.asarray(r).reshape(6, -1)
    np.testing.assert_array_equal(k.numpy(), flat.argmax(-1))
    np.testing.assert_allclose(pk.numpy(), flat.max(-1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "rank", "h", "nl", "layout",
                                 "window_rows", "window_cols", "n2", "n1"])
def test_inverse_argmax_refuses(bad):
    """A wrong dtype, shape or layout, an nl that does not match Y's last
    axis, or a window that does not fit or is empty, on every device."""
    n1, n2, nf, nl = 2, 3, 5, 8
    Y = products(2, nf, nl // 2 + 1)
    err = ValueError
    if bad == "dtype":
        Y, err = Y.to(torch.complex128), TypeError
    elif bad == "rank":
        Y = Y[0]
    elif bad == "h":
        Y = products(2, nf, nl // 2 + 2)
    elif bad == "nl":
        nl = 10
    elif bad == "layout":
        Y = products(2, nf, 2 * (nl // 2 + 1))[..., ::2]
    elif bad == "window_rows":
        n1 = 4
    elif bad == "window_cols":
        n2 = 5
    elif bad == "n2":
        n2 = 0
    elif bad == "n1":
        n1 = 0
    with pytest.raises(err):
        cells.inverse_argmax(Y, n1, n2, nl)


@pytest.mark.parametrize("bad", ["rank", "h", "nl", "window"])
def test_product_peaks_refuses(bad):
    n1, n2, nf, nl = 2, 3, 5, 9
    P = products(2, nf, nl // 2 + 1)
    if bad == "rank":
        P = P[0]
    elif bad == "h":
        P = products(2, nf, nl // 2)
    elif bad == "nl":
        nl = 11
    elif bad == "window":
        n1 = 4
    with pytest.raises(ValueError):
        cells.product_peaks(P, n1, n2, nl)
