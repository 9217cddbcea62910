"""Parity of the PyTorch port's correlation (``xcorr_tpu_torch.ops.cc``)
with the JAX reference (``xcorr_tpu.ops.cc``) and the float64 oracle
(``xcorr_tpu.util.cc.cc``), on the CPU.

Tolerances: 5e-7 abs against the JAX float32 kernel (both are float32
FFT correlations of the same inputs; values are O(0.1) at these sizes, so
this is a few float32 ulps of the peak) and 1e-6 abs against the float64
oracle (the repository's accuracy bar for normalized CCFs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcorr_tpu import ops as jops
from xcorr_tpu.util.cc import cc as cc_f64, weight
from xcorr_tpu_torch.ops import cc as tcc
from xcorr_tpu_torch.ops import fft as tfft
from xcorr_tpu_torch.ops import fft4 as tfft4

ATOL_JAX = 5e-7
ATOL_F64 = 1e-6

N = 300
# fftshifted lag windows of the 2N-1 = 599 lags (zero lag at 299)
WINDOWS = {
    "below_zero": (50, 250),
    "above_zero": (320, 500),
    "across_zero": (200, 420),
}
# (unbiased, clip_weight)
WEIGHTS = {"biased": (False, None), "unbiased": (True, None),
           "unbiased_clipped": (True, 1.5)}


def _inputs(zero_row, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, N)).astype(dtype)
    y = (np.roll(x, 7, axis=1) + 0.5 * rng.normal(size=(3, N))).astype(dtype)
    if zero_row:
        y[1] = 0.0
    return x, y


def _oracle(x, y, imin, imax, unbiased, clip):
    out = np.zeros((x.shape[0], imax - imin))
    w = weight(N, pad=True, clip=clip) if unbiased else 1.0
    for i in range(x.shape[0]):
        if not np.any(x[i]) or not np.any(y[i]):
            continue  # zero norm: both kernels return zeros
        r = cc_f64(x[i].astype(np.float64), y[i].astype(np.float64),
                   unbiased=False) * w
        out[i] = r[imin:imax]
    return out


@pytest.mark.parametrize("zero_row", [False, True], ids=["", "zero_row"])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_monolithic_matches_jax_and_f64(window, weights, zero_row):
    imin, imax = WINDOWS[window]
    unbiased, clip = WEIGHTS[weights]
    x, y = _inputs(zero_row)
    kw = dict(index_min=imin, index_max=imax, unbiased=unbiased,
              clip_weight=clip)
    got = tcc.correlate(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert got.dtype == torch.float32 and got.shape == (3, imax - imin)
    got = got.numpy()
    want = np.asarray(jops.cc.correlate(jnp.asarray(x), jnp.asarray(y),
                                        **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(got, _oracle(x, y, imin, imax, unbiased,
                                            clip), rtol=0, atol=ATOL_F64)
    if zero_row:
        assert not got[1].any()


def test_float64_matches_oracle():
    """float64 inputs stay float64 end to end."""
    x, y = _inputs(False, seed=1, dtype=np.float64)
    got = tcc.correlate(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               _oracle(x, y, 0, 2 * N - 1, False, None),
                               rtol=0, atol=1e-12)


def test_unnormalized_and_nfft_override():
    x, y = _inputs(False, seed=2)
    kw = dict(normalize=False, index_min=100, index_max=400, nfft=1024)
    got = tcc.correlate(torch.from_numpy(x), torch.from_numpy(y),
                        **kw).numpy()
    want = np.asarray(jops.cc.correlate(jnp.asarray(x), jnp.asarray(y),
                                        **kw))
    # unnormalized values are O(sqrt(N)) larger
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="alias"):
        tcc.correlate(torch.from_numpy(x), torch.from_numpy(y), nfft=512)


def test_cpu_routes_monolithic_above_threshold(monkeypatch):
    """A CPU tensor takes the monolithic path even at day-scale n; the
    four-step plan is never built."""
    def no_plan(*a, **k):
        raise AssertionError("four-step plan built for a CPU tensor")

    monkeypatch.setattr(tfft4, "plan_correlate4", no_plan)
    n = tcc.FOURSTEP_THRESHOLD
    x = torch.zeros((1, n))
    x[0, 5] = 1.0
    out = tcc.correlate(x, x, index_min=n - 3, index_max=n + 2)
    np.testing.assert_allclose(out.numpy(), [[0, 0, 1, 0, 0]], atol=1e-6)


def test_method_validation():
    x = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="method"):
        tcc.correlate(x, x, method="fast")
    with pytest.raises(ValueError, match="fourstep"):
        tcc.correlate(x, x, method="fourstep", unbiased=True)
    with pytest.raises(ValueError, match="differ"):
        tcc.correlate(x, torch.zeros((1, 65)))


def test_unbiased_weights_match_reference():
    got = tcc.unbiased_weights(N, 10, 500, clip=3.0, dtype=torch.float64)
    want = np.asarray(jops.cc.unbiased_weights(N, 10, 500, clip=3.0,
                                               dtype=jnp.float64))
    np.testing.assert_array_equal(got.numpy(), want)


def _smooth(k, primes=(2, 3, 5, 7)):
    for p in primes:
        while k % p == 0:
            k //= p
    return k == 1


@pytest.mark.parametrize("n", [1, 2, 97, 1000, 8639999])
def test_next_fast_len_is_next_7_smooth(n):
    m = tfft.next_fast_len(n)
    assert m >= n and _smooth(m)
    assert not any(_smooth(k) for k in range(n, m))
    assert tfft.next_fast_len(n, radices=(2,)) == 1 << max(n - 1, 0) \
        .bit_length()


#: one day at 50 Hz and the production lag window, 0-9 h
DAY_N, DAY_LAGS = 4_320_000, 1_620_000


@pytest.fixture(scope="module")
def day_windows():
    """Two seeded day-scale windows, ``y`` a copy of ``x`` 4 s earlier
    plus half as much noise (peak 0.89 at lag 200)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, DAY_N)).astype(np.float32)
    y = (np.roll(x, -200, axis=1)
         + 0.5 * rng.normal(size=x.shape)).astype(np.float32)
    return x, y


def test_row_norm_at_day_scale(day_windows):
    """The port's norm is within 1e-6 (relative) of ``jnp.linalg.norm``
    and of the float64 norm at n = 4,320,000 on the CPU
    (``torch.linalg.vector_norm`` is 9e-5 off there)."""
    x, _ = day_windows
    got = tcc.row_norm(torch.from_numpy(x))
    assert got.shape == (2, 1) and got.dtype == torch.float32
    got = got[:, 0].numpy().astype(np.float64)
    f64 = np.linalg.norm(x.astype(np.float64), axis=-1)
    jax_norm = np.asarray(jnp.linalg.norm(jnp.asarray(x), axis=-1),
                          dtype=np.float64)
    np.testing.assert_allclose(got, f64, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, jax_norm, rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["monolithic", "fourstep"])
def test_day_scale_ccf_on_cpu_matches_f64(day_windows, method):
    """One day-scale correlation on the CPU (``process(device="cpu")``
    takes the monolithic path; the four-step's epilogue shares the norm)
    is within 1e-6 of the float64 oracle (with the float32
    ``vector_norm`` it was 1.8e-4 off)."""
    import scipy.fft as sfft
    x, y = day_windows
    imin, imax = DAY_N - 1, DAY_N - 1 + DAY_LAGS
    got = tcc.correlate(torch.from_numpy(x), torch.from_numpy(y),
                        index_min=imin, index_max=imax,
                        method=method).numpy()
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    nfft = sfft.next_fast_len(2 * DAY_N - 1, real=True)
    r = sfft.irfft(sfft.rfft(x64, nfft) * np.conj(sfft.rfft(y64, nfft)),
                   nfft)
    want = r[:, (np.arange(imin, imax) - (DAY_N - 1)) % nfft] / (
        np.linalg.norm(x64, axis=-1) * np.linalg.norm(y64, axis=-1))[:, None]
    assert np.abs(want).max() > 0.85
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F64)
