"""A plain torch emulation of K3's and K4's split-TF32 products
(``xcorr_tpu_torch/csrc/gemm_tf32.cu``) on the CPU, which predicts the
card's error before a card run.

Each operand is split as ``hi = tf32(a)``, ``lo = tf32(a - hi)``, where
``tf32`` rounds to nearest at 10 mantissa bits with ties away from zero
(``cvt.rna.tf32.f32``), and the product is the float32 sum of
``lo·hi + hi·lo + hi·hi``. It does not model the tensor cores' own
float32 accumulation inside one ``mma``; the card run measures that.

Tolerances:
- the split product against float64, on stage-A- and inverse-like
  matrices of the day-scale geometry (n1 = 528): within twice the error
  of a float32 ``torch.matmul`` of the same operands (the split drops
  terms of ~2^-22 of a product, the order of float32's own rounding),
  while one TF32 pass is over 100 times worse;
- the ``acc`` and ``full`` routes with their products emulated, at
  n = 100,000 (n1 = 16, N2 = 16384): 1e-6 abs of the float64 oracle, the
  repository's bar for normalized CCFs;
- the same routes at ``precision='default'`` (one TF32 pass, ``hi·hi``,
  the plain versions' ``passes=1``): within 2^-11 of the largest
  |CCF| of the float64 oracle (TF32's unit roundoff: each operand of the
  one product is rounded by up to 2^-11 of itself), and unequal to
  ``'high'``.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import fft4 as tfft4
from xcorr_tpu_torch.ops import fused_fft

N_LONG = 100_000
ATOL_LONG = 1e-6
#: TF32's unit roundoff (10 mantissa bits, round to nearest)
TF32_U = 2.0 ** -11


def tf32(a):
    """float32 -> float32 rounded to 10 mantissa bits, ties away from
    zero: half of the dropped 13 bits' range added to the magnitude, then
    the 13 bits cleared."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def split_matmul(a, b):
    """``a @ b`` as the card's three TF32 passes, float32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)
            + torch.matmul(ah, bh))


def test_tf32_rounds_to_nearest_ties_away_and_splits_exactly():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                                1 + 2 ** -9, 3.0]
    a = torch.from_numpy(np.random.default_rng(1).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(a)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    # hi + lo carries 22 of float32's 24 significant bits
    rel = ((hi.double() + lo.double() - a.double()).abs()
           / a.double().abs()).max().item()
    assert 0 < rel <= 2.0 ** -22


def _day_scale_operand(kind):
    """A stage-A-like (530 x 264) or inverse-like (99 x 530) matrix of the
    n1 = 528 geometry, re and im stacked as ops.fft4 stacks them."""
    n1, H = 528, 265
    if kind == "stage_a":
        w = np.exp(-2j * np.pi * np.outer(np.arange(H), np.arange(264))
                   / n1)
        return np.concatenate([w.real, w.imag])
    fold = np.full(H, 2.0)
    fold[[0, -1]] = 1.0
    w = np.exp(2j * np.pi * np.outer(np.arange(429, 528), np.arange(H))
               / n1) / n1 * fold
    return np.concatenate([w.real, -w.imag], axis=1)


@pytest.mark.parametrize("kind", ["stage_a", "inverse"])
def test_split_product_is_float32_level(kind):
    a = _day_scale_operand(kind).astype(np.float32)
    b = np.random.default_rng(0).normal(size=(a.shape[1], 512)).astype(
        np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def err(c):
        return np.abs(c.double().numpy() - ref).max() / np.abs(ref).max()

    e_split = err(split_matmul(at, bt))
    e_f32 = err(torch.matmul(at, bt))
    e_one = err(torch.matmul(tf32(at), tf32(bt)))
    assert e_split <= 2 * e_f32
    assert e_one >= 100 * e_f32


@pytest.mark.parametrize("route", ["acc", "full"])
def test_route_through_split_products_within_1e6_of_f64(route):
    """The route's arithmetic with K3's and K4's products emulated: the
    pruned inverse (both routes) and stage A (``full``) as split TF32,
    stage B as K1's plain version."""
    from xcorr_tpu.util.cc import cc as cc_f64
    imin, imax = 95_000, 105_000
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, N_LONG)).astype(np.float32)
    y = (np.roll(x, 40, axis=1)
         + 0.5 * rng.normal(size=(2, N_LONG))).astype(np.float32)
    plan = tfft4.plan_correlate4(N_LONG, imin, imax, route=route)
    assert (plan.N1, plan.N2) == (16, 16384)
    w1, wi, t = plan.device_consts("cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    shape = (2, 2, plan.half, plan.N2)
    if route == "full":
        ax = split_matmul(w1, plan.padded(xt)).view(shape)
        ay = split_matmul(w1, plan.padded(yt)).view(shape)
    else:
        ax, ay = plan.stage_a(xt, w1), plan.stage_a(yt, w1)
    c = fused_fft.fused_corr_plain(ax, ay, t)
    out = split_matmul(wi, c.view(2, 2 * plan.half, plan.N2)).view(2, -1)
    got = tfft4._finish_ccf(out, xt, yt, plan.segs_flat, True).numpy()
    oracle = np.stack([cc_f64(x[i].astype(np.float64),
                              y[i].astype(np.float64),
                              unbiased=False)[imin:imax] for i in range(2)])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL_LONG)
    np.testing.assert_allclose(got, plan(xt, yt).numpy(), rtol=0,
                               atol=ATOL_LONG)


def test_one_pass_plain_product_is_one_tf32_product():
    """K3's and K4's plain versions with ``passes=1`` round both operands
    as this emulation does and multiply once; ``passes=3`` is float32."""
    a = torch.from_numpy(_day_scale_operand("inverse").astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(3).normal(
        size=(a.shape[1], 64)).astype(np.float32))
    assert torch.equal(fused_fft.tf32_round(b), tf32(b))
    assert torch.equal(fused_fft._product(a, b, 1),
                       torch.matmul(tf32(a), tf32(b)))
    assert torch.equal(fused_fft._product(a, b, 3), torch.matmul(a, b))
    with pytest.raises(ValueError, match="passes"):
        fused_fft.fused_corr_acc(*(torch.zeros(1, 2, 3, 8),) * 2,
                                 torch.zeros(2, 3, 8), torch.zeros(2, 6), 2)


@pytest.mark.parametrize("route", ["acc", "full"])
def test_default_precision_route_is_one_pass_within_1e4_of_f64(route):
    """``precision='default'`` on the ``acc`` and ``full`` routes is the
    route's arithmetic with one-TF32-pass products (the pruned inverse's
    1/N1 applied after them): it equals that emulation, stays within
    TF32's unit roundoff of float64's peak and differs from
    ``'high'``."""
    from xcorr_tpu.util.cc import cc as cc_f64
    imin, imax = 95_000, 105_000
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, N_LONG)).astype(np.float32)
    y = (np.roll(x, 40, axis=1)
         + 0.5 * rng.normal(size=(2, N_LONG))).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    plan = tfft4.plan_correlate4(N_LONG, imin, imax, route=route,
                                 precision="default")
    w1, wi, t = plan.device_consts("cpu")
    shape = (2, 2, plan.half, plan.N2)
    if route == "full":
        ax = torch.matmul(tf32(w1), tf32(plan.padded(xt))).view(shape)
        ay = torch.matmul(tf32(w1), tf32(plan.padded(yt))).view(shape)
    else:
        ax, ay = plan.stage_a(xt, w1), plan.stage_a(yt, w1)
    c = fused_fft.fused_corr_plain(ax, ay, t)
    out = torch.matmul(tf32(wi), tf32(c.view(2, 2 * plan.half, plan.N2)))
    want = tfft4._finish_ccf(out.view(2, -1), xt, yt, plan.segs_flat, True,
                             plan.scale)
    got = plan(xt, yt)
    assert torch.equal(got, want)
    oracle = np.stack([cc_f64(x[i].astype(np.float64),
                              y[i].astype(np.float64),
                              unbiased=False)[imin:imax] for i in range(2)])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0,
                               atol=TF32_U * np.abs(oracle).max())
    high = tfft4.plan_correlate4(N_LONG, imin, imax, route=route)(xt, yt)
    assert not torch.equal(got, high)
