"""The four-step correlation of the PyTorch port
(``xcorr_tpu_torch.ops.fft4``, plain stage B on the CPU) against the JAX
reference's fused plan (``xcorr_tpu.ops.fft4.plan_correlate4(...,
stageb='pallas', precision='highest')``) in Pallas interpret mode.

Tolerance: 5e-7 abs, as ``tests/test_ops.py`` holds the reference plan
against its monolithic kernel (normalized CCF values are O(0.05) at
n = 2000, so this is a few float32 ulps).
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import cc as tcc
from xcorr_tpu_torch.ops import fft4 as tfft4
from xcorr_tpu_torch.ops import fused_fft

ATOL = 5e-7
N = 2000
# a length where the routes' default geometries differ; 1e-6 abs, the
# repository's bar for normalized CCFs against the float64 oracle
N_LONG = 100_000
ATOL_LONG = 1e-6
# fftshifted lag windows of the 2N-1 lags (zero lag at 1999)
WINDOWS = [(1999, 3000), (500, 1500), (1500, 2500)]


@pytest.fixture(scope="module")
def reference_plans():
    """The reference's fused plans, built in Pallas interpret mode."""
    from jax.experimental import pallas as pl
    from xcorr_tpu.ops import fft4, pallas_fft
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    def clear():
        pallas_fft.plan_fused_corr.cache_clear()
        fft4.plan_correlate4.cache_clear()

    pl.pallas_call = interp
    clear()
    try:
        yield lambda imin, imax, n1: fft4.plan_correlate4(
            N, imin, imax, n1=n1, stageb="pallas", precision="highest")
    finally:
        pl.pallas_call = orig
        clear()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N)).astype(np.float32)
    y = rng.normal(size=(2, N)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n1", [16, 32])
def test_fourstep_matches_pallas_reference(reference_plans, n1, window):
    """n1=32 runs 17 of 32 k1 rows: the Hermitian half-row fold."""
    imin, imax = window
    x, y = _inputs()
    want = np.asarray(reference_plans(imin, imax, n1)(x, y))
    plan = tfft4.plan_correlate4(N, imin, imax, n1=n1)
    assert plan.half == n1 // 2 + 1
    got = plan(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fourstep_method_on_cpu_uses_plain_stage_b(monkeypatch):
    monkeypatch.setattr(fused_fft, "launches",
                        dict.fromkeys(fused_fft.KERNELS, 0))
    x, y = (torch.from_numpy(a) for a in _inputs(5))
    got = tcc.correlate(x, y, index_min=1999, index_max=3000,
                        method="fourstep")
    want = tcc.correlate(x, y, index_min=1999, index_max=3000)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    assert not any(fused_fft.launches.values())


@pytest.mark.parametrize("window", WINDOWS + [(0, 3999)], ids=str)
@pytest.mark.parametrize("n1", [16, 32, 64])
def test_plan_matches_reference_and_is_slice_contiguous(n1, window):
    """Where both pick the same N2, the port's ``_plan`` equals the
    reference's, and its lag window is the concatenation of
    ``segs_flat`` slices (the invariant ``_plan`` raises on)."""
    from xcorr_tpu.ops import fft4 as jfft4
    p = tfft4._plan(N, *window, n1)
    r = jfft4._plan(N, *window, n1)
    assert (p["N1"], p["N2"], p["rows_in"]) == (r["N1"], r["N2"],
                                                r["rows_in"])
    for key in ("W1", "T", "W1inv", "out_rows", "gather"):
        np.testing.assert_array_equal(p[key], r[key])
    assert p["segs_flat"] == r["segs_flat"]
    flat = np.concatenate([np.arange(s, s + ln) for s, ln in p["segs_flat"]])
    np.testing.assert_array_equal(flat, p["gather"])


def test_geometry_is_power_of_two_and_bounded():
    assert tfft4._pick_factors(3999, 16) == (16, 256)
    assert tfft4._pick_factors(3999, 24) == (24, 256)  # 167 -> 256
    # production: 24 h at 50 Hz. Every route (K1, K3, K4: rows up to
    # 16384) takes the reference's geometry
    nn = 2 * 4_320_000 - 1
    for route in ("corr", "acc", "full"):
        assert tfft4._default_n1(nn, route) == 528
        assert tfft4.padded_len(4_320_000, route=route) == 264 * 16384
    assert tfft4._pick_factors(nn, 528) == (528, 16384)
    assert tfft4._pick_factors(nn, 1056) == (1056, 8192)
    assert tfft4._default_n1(nn) == 528
    assert tfft4._half_rows(528) == 265
    assert tfft4._half_rows(1056) == 529
    assert tfft4.padded_len(4_320_000) == 264 * 16384
    # N2 = 32768 > every kernel's limit: refused before any table is built
    with pytest.raises(ValueError, match="power of two"):
        tfft4.plan_correlate4(100_000, n1=8)
    for kernel in ("fused_corr", "fused_corr_acc", "fused_corr_full"):
        assert fused_fft.MAX_N2[kernel] == 16384
        for bad in (250, 3 * 1024, 2 * 16384, 1):
            with pytest.raises(ValueError, match="power of two"):
                fused_fft.check_geometry(bad, kernel)


@pytest.mark.parametrize("route,n1,N2", [("corr", 16, 16384),
                                         ("acc", 16, 16384),
                                         ("full", 16, 16384)])
def test_default_geometry_follows_the_route(route, n1, N2):
    """At n = 100,000 every route takes n1 = 16, N2 = 16384; the route is
    resolved before n1 is picked, and a route refuses rows its kernel
    does not take (n1 = 8: N2 = 32768)."""
    plan = tfft4.plan_correlate4(N_LONG, N_LONG - 1, N_LONG + 999,
                                 route=route)
    assert (plan.route, plan.N1, plan.N2) == (route, n1, N2)
    assert tfft4.padded_len(N_LONG, route=route) == 7 * 16384
    with pytest.raises(ValueError, match="power of two"):
        tfft4.plan_correlate4(N_LONG, n1=8, route=route)


@pytest.mark.parametrize("window", [(90_000, 99_000), (95_000, 105_000),
                                    (0, 2 * N_LONG - 1)], ids=str)
def test_corr_route_at_n1_16_matches_reference_and_f64(window):
    """The corr route at its own geometry (n1 = 16, N2 = 16384; plain
    stage B on the CPU) against the reference's four-step plan with its
    XLA stage B (``stageb='fft'``, which picks its own N1 x N2: the
    function on the lag window is the same) and the float64 oracle."""
    import jax.numpy as jnp
    from xcorr_tpu.ops import fft4 as jfft4
    from xcorr_tpu.util.cc import cc as cc_f64
    imin, imax = window
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, N_LONG)).astype(np.float32)
    y = (np.roll(x, 40, axis=1)
         + 0.5 * rng.normal(size=(2, N_LONG))).astype(np.float32)
    plan = tfft4.plan_correlate4(N_LONG, imin, imax, route="corr")
    assert (plan.N1, plan.N2) == (16, 16384)
    got = plan(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = jfft4.plan_correlate4(N_LONG, imin, imax, stageb="fft")
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LONG)
    oracle = np.stack([cc_f64(x[i].astype(np.float64),
                              y[i].astype(np.float64),
                              unbiased=False)[imin:imax] for i in range(2)])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL_LONG)


def test_tf32_off_after_plan_and_checked(monkeypatch):
    tfft4._build_plan.cache_clear()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    plan = tfft4.plan_correlate4(N, 1999, 3000, n1=16)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert not tfft4.tf32_enabled()
    x, y = (torch.from_numpy(a) for a in _inputs())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        plan(x, y)
    tfft4._build_plan.cache_clear()


def test_plan_rejects_bad_inputs():
    plan = tfft4.plan_correlate4(N, 1999, 3000, n1=16)
    x = torch.zeros((1, N))
    with pytest.raises(TypeError):
        plan(x.double(), x.double())
    with pytest.raises(ValueError):
        plan(torch.zeros((1, N + 1)), torch.zeros((1, N + 1)))
