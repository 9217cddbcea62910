"""The ``acc`` (K3) and ``full`` (K4) routes of the port's four-step
correlation (``xcorr_tpu_torch.ops.fft4``, plain versions on the CPU)
against the JAX reference's fused plan with ``XCORR_FFT4_FUSED_INV=1``
and ``XCORR_FFT4_FULL=1`` (``xcorr_tpu.ops.fft4.plan_correlate4(...,
stageb='pallas', precision='highest')`` in Pallas interpret mode, set up
as ``tests/test_ops.py`` does), and the port's per-call route resolution.

Tolerances (normalized CCF values are O(0.05) at n = 2000):
- ``acc`` vs the reference: 5e-7 abs, as ``tests/test_ops.py`` holds the
  reference's fused-inverse plan;
- ``full`` vs the reference: 2e-6 abs, the reference's own tolerance for
  its bf16x3 stage A (the port's stage A is float32);
- each route vs the port's ``corr`` route: 5e-7 abs.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import cc as tcc
from xcorr_tpu_torch.ops import fft4 as tfft4
from xcorr_tpu_torch.ops import fused_fft

N = 2000
WINDOWS = [(1999, 3000), (500, 1500), (1500, 2500)]
ENV = {"acc": "XCORR_FFT4_FUSED_INV", "full": "XCORR_FFT4_FULL"}
ATOL_REF = {"acc": 5e-7, "full": 2e-6}
ATOL_ROUTES = 5e-7
# a length at which every route takes n1 = 16, N2 = 16384; 1e-6 abs, the
# repository's bar for normalized CCFs against the float64 oracle
N_LONG = 100_000
ATOL_LONG = 1e-6


@pytest.fixture
def no_route_env(monkeypatch):
    for var in ENV.values():
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture
def reference_route(monkeypatch):
    """The reference's plan for a route: its variable set, its plan
    caches cleared before and after (the reference reads the variable
    once, when the plan is built), Pallas interpreted."""
    from jax.experimental import pallas as pl
    from xcorr_tpu.ops import fft4, pallas_fft
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    def clear():
        pallas_fft.plan_fused_corr.cache_clear()
        pallas_fft.plan_fused_corr_acc.cache_clear()
        pallas_fft.plan_fused_corr_full.cache_clear()
        fft4.plan_correlate4.cache_clear()

    def build(route, imin, imax, n1):
        for var in ENV.values():
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv(ENV[route], "1")
        clear()
        plan = fft4.plan_correlate4(N, imin, imax, n1=n1, stageb="pallas",
                                    precision="highest")
        # the reference built the route's kernel, not a fallback
        kernel = {"acc": pallas_fft.plan_fused_corr_acc,
                  "full": pallas_fft.plan_fused_corr_full}[route]
        assert kernel.cache_info().currsize == 1
        return plan

    pl.pallas_call = interp
    try:
        yield build
    finally:
        pl.pallas_call = orig
        for var in ENV.values():
            monkeypatch.delenv(var, raising=False)
        clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed=4, B=2, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n)).astype(np.float32)
    y = rng.normal(size=(B, n)).astype(np.float32)
    return x, y


def _run(route, imin, imax, n1, x, y):
    plan = tfft4.plan_correlate4(N, imin, imax, n1=n1, route=route)
    assert plan.route == route
    return plan(torch.from_numpy(x), torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n1", [16, 32])
@pytest.mark.parametrize("route", ["acc", "full"])
def test_route_matches_pallas_reference(reference_route, route, n1, window):
    """n1=32 runs 17 of 32 k1 rows: the Hermitian half-row fold."""
    imin, imax = window
    x, y = _inputs()
    want = np.asarray(reference_route(route, imin, imax, n1)(x, y))
    got = _run(route, imin, imax, n1, x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF[route])


@pytest.mark.parametrize("window", WINDOWS + [(0, 3999)], ids=str)
@pytest.mark.parametrize("n1", [16, 32, 64])
@pytest.mark.parametrize("route", ["acc", "full"])
def test_route_matches_corr_route(no_route_env, route, n1, window):
    x, y = _inputs(7)
    want = _run("corr", *window, n1, x, y)
    got = _run(route, *window, n1, x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_ROUTES)


def test_route_follows_the_environment_on_every_call(no_route_env):
    """Set and unset between calls, no cache cleared: the plan follows;
    XCORR_FFT4_FULL wins over XCORR_FFT4_FUSED_INV."""
    mp = no_route_env

    def route():
        return tfft4.plan_correlate4(N, 1999, 3000, n1=16).route

    assert route() == "corr"
    mp.setenv("XCORR_FFT4_FUSED_INV", "1")
    assert route() == "acc"
    mp.setenv("XCORR_FFT4_FULL", "1")
    assert route() == "full"
    mp.delenv("XCORR_FFT4_FULL")
    assert route() == "acc"
    mp.setenv("XCORR_FFT4_FUSED_INV", "0")
    assert route() == "corr"
    mp.setenv("XCORR_FFT4_FULL", "1")
    assert route() == "full"
    # an explicit route wins over the environment
    assert tfft4.plan_correlate4(N, 1999, 3000, n1=16,
                                 route="corr").route == "corr"


@pytest.mark.parametrize("route", ["corr", "acc", "full"])
def test_correlate_on_cpu_takes_the_routes_plain_version(no_route_env,
                                                         route):
    mp = no_route_env
    mp.setattr(fused_fft, "launches", dict.fromkeys(fused_fft.KERNELS, 0))
    if route != "corr":
        mp.setenv(ENV[route], "1")
    x, y = (torch.from_numpy(a) for a in _inputs(5))
    got = tcc.correlate(x, y, index_min=1999, index_max=3000,
                        method="fourstep")
    plan = tfft4.plan_correlate4(N, 1999, 3000)
    assert plan.route == route
    np.testing.assert_array_equal(got.numpy(), plan(x, y).numpy())
    want = tcc.correlate(x, y, index_min=1999, index_max=3000)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL_ROUTES)
    assert not any(fused_fft.launches.values())


@pytest.mark.parametrize("route", ["corr", "acc", "full"])
def test_every_route_refuses_a_geometry_at_plan_time(no_route_env, route):
    # N2 = 32768 > MAX_N2
    with pytest.raises(ValueError, match="power of two"):
        tfft4.plan_correlate4(100_000, n1=8, route=route)


def test_unknown_route_raises(no_route_env):
    with pytest.raises(ValueError, match="route"):
        tfft4.plan_correlate4(N, 1999, 3000, n1=16, route="einsum")


@pytest.mark.parametrize("window", [(90_000, 99_000), (95_000, 105_000),
                                    (0, 2 * N_LONG - 1)], ids=str)
@pytest.mark.parametrize("route", ["acc", "full"])
def test_route_at_n1_16_matches_reference_and_f64(no_route_env, route,
                                                  window):
    """The acc and full routes at their own geometry (n1 = 16, N2 = 16384;
    plain versions on the CPU) against the reference's four-step plan with
    its XLA stage B (``stageb='fft'``, which picks its own N1 x N2: the
    function on the lag window is the same) and the float64 oracle, as
    ``tests/test_torch_fft4.py`` holds the corr route."""
    import jax.numpy as jnp
    from xcorr_tpu.ops import fft4 as jfft4
    from xcorr_tpu.util.cc import cc as cc_f64
    imin, imax = window
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, N_LONG)).astype(np.float32)
    y = (np.roll(x, 40, axis=1)
         + 0.5 * rng.normal(size=(2, N_LONG))).astype(np.float32)
    plan = tfft4.plan_correlate4(N_LONG, imin, imax, route=route)
    assert (plan.route, plan.N1, plan.N2) == (route, 16, 16384)
    got = plan(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = jfft4.plan_correlate4(N_LONG, imin, imax, stageb="fft")
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LONG)
    oracle = np.stack([cc_f64(x[i].astype(np.float64),
                              y[i].astype(np.float64),
                              unbiased=False)[imin:imax] for i in range(2)])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL_LONG)


def _acc_inputs(B, H, N2, rows_in, rows_out, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ph = rng.uniform(0.0, 2 * np.pi, size=(H, N2))
    return {
        "ax": rng.normal(size=(B, 2, H, N2)).astype(f32),
        "ay": rng.normal(size=(B, 2, H, N2)).astype(f32),
        "T": np.stack([np.cos(ph), np.sin(ph)]).astype(f32),
        "wi": (rng.normal(size=(rows_out, 2 * H)) / np.sqrt(2 * H))
        .astype(f32),
        "w1": (rng.normal(size=(2 * H, rows_in)) / np.sqrt(rows_in))
        .astype(f32),
        "vx": rng.normal(size=(B, rows_in, N2)).astype(f32),
        "vy": rng.normal(size=(B, rows_in, N2)).astype(f32),
    }


def test_plain_versions_are_the_routes_arithmetic():
    """K3's plain version is K1's followed by the inverse product; K4's
    is the stage-A product followed by K3's."""
    a = {k: torch.from_numpy(v)
         for k, v in _acc_inputs(2, 9, 64, 5, 7).items()}
    c = fused_fft.fused_corr_plain(a["ax"], a["ay"], a["T"])
    want = torch.einsum("rk,bkj->brj", a["wi"], c.reshape(2, 18, 64))
    got = fused_fft.fused_corr_acc_plain(a["ax"], a["ay"], a["T"], a["wi"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ax = torch.einsum("kr,brj->bkj", a["w1"], a["vx"]).reshape(2, 2, 9, 64)
    ay = torch.einsum("kr,brj->bkj", a["w1"], a["vy"]).reshape(2, 2, 9, 64)
    got = fused_fft.fused_corr_full(a["vx"], a["vy"], a["w1"], a["T"],
                                    a["wi"])
    torch.testing.assert_close(
        got, fused_fft.fused_corr_acc_plain(ax, ay, a["T"], a["wi"]),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["wi_cols", "w1_rows", "vy_shape",
                                 "float64", "N2_not_pow2"])
def test_acc_and_full_reject_what_the_kernels_do_not_take(bad):
    a = {k: torch.from_numpy(v)
         for k, v in _acc_inputs(1, 5, 64, 4, 3).items()}
    err = ValueError
    if bad == "wi_cols":
        a["wi"] = a["wi"][:, :-1].contiguous()
    elif bad == "w1_rows":
        a["w1"] = a["w1"][:-1].contiguous()
    elif bad == "vy_shape":
        a["vy"] = a["vy"][:, :-1].contiguous()
    elif bad == "float64":
        a["wi"], err = a["wi"].double(), TypeError
    elif bad == "N2_not_pow2":
        a["vx"] = a["vy"] = torch.zeros(1, 4, 96)
        a["ax"] = a["ay"] = torch.zeros(1, 2, 5, 96)
        a["T"] = torch.zeros(2, 5, 96)
    with pytest.raises(err):
        fused_fft.fused_corr_full(a["vx"], a["vy"], a["w1"], a["T"],
                                  a["wi"])
    if bad in ("wi_cols", "float64", "N2_not_pow2"):
        with pytest.raises(err):
            fused_fft.fused_corr_acc(a["ax"], a["ay"], a["T"], a["wi"])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_corr_acc", "fused_corr_full"])
@pytest.mark.parametrize("shape", [(2, 24, 256, 8, 5),
                                   (8, 529, 8192, 528, 198),
                                   (1, 3, 16384, 2, 2),
                                   (4, 265, 16384, 264, 99)])
def test_kernel_matches_plain_and_repeats_bitwise_on_card(cuda_device,
                                                          kernel, shape):
    """K3 and K4 against their plain versions (1e-5 of the max) at
    (B, H, N2, rows_in, rows_out): a small shape, the n1 = 1056 day-scale
    one, one window of three rows of 16384 and half the n1 = 528
    pair-day; two launches on the same inputs give the same bits."""
    a = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in _acc_inputs(*shape).items()}
    args = ((a["ax"], a["ay"], a["T"], a["wi"]) if kernel == "fused_corr_acc"
            else (a["vx"], a["vy"], a["w1"], a["T"], a["wi"]))
    fn = getattr(fused_fft, kernel)
    before = fused_fft.launches[kernel]
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert fused_fft.launches[kernel] == before + 2
    assert torch.equal(first, second)
    want = getattr(fused_fft, kernel + "_plain")(*args)
    assert ((first - want).abs().max() <= 1e-5 * want.abs().max()).item()
