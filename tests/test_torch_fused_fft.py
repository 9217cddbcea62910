"""The fused stage-B correlation (K1) of the PyTorch port
(``xcorr_tpu_torch.ops.fused_fft``) against the JAX reference kernel
``xcorr_tpu.ops.pallas_fft.plan_fused_corr`` run in Pallas interpret mode
on the CPU, as ``tests/test_ops.py`` runs it.

Tolerance: max |diff| <= 1e-5 of the output's max |value|. Both sides
are float32 transforms of length N2 <= 1024 (the reference at
``precision='highest'``), whose rounding stays near 1e-6 relative.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import fused_fft

RTOL_OF_MAX = 1e-5


@pytest.fixture
def pallas_interpret():
    """Run every ``pl.pallas_call`` in interpret mode (CPU)."""
    from jax.experimental import pallas as pl
    from xcorr_tpu.ops import pallas_fft
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = interp
    pallas_fft.plan_fused_corr.cache_clear()
    try:
        yield pallas_fft
    finally:
        pl.pallas_call = orig
        pallas_fft.plan_fused_corr.cache_clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, H, N2, N, seed=0):
    """Seeded packed planes and the outer twiddle of an N = N1*N2 plan."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(B, 2, H, N2)).astype(np.float32)
    ay = rng.normal(size=(B, 2, H, N2)).astype(np.float32)
    t = np.exp(-2j * np.pi * np.outer(np.arange(H), np.arange(N2)) / N)
    T = np.stack([t.real, t.imag]).astype(np.float32)
    return ax, ay, T


@pytest.mark.parametrize("H,N2", [(16, 256), (24, 1024)])
def test_plain_matches_pallas_reference(pallas_interpret, H, N2):
    import jax.numpy as jnp
    N = 2 * H * N2  # the twiddle of an N1 = 2H plan
    ax, ay, T = _inputs(2, H, N2, N)
    corr = pallas_interpret.plan_fused_corr(H, N2, N, "highest")
    want = np.asarray(corr(jnp.asarray(ax), jnp.asarray(ay)))
    got = fused_fft.fused_corr_plain(torch.from_numpy(ax),
                                     torch.from_numpy(ay),
                                     torch.from_numpy(T)).numpy()
    assert got.shape == want.shape == (2, 2, H, N2)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def test_wrapper_takes_plain_route_on_cpu(monkeypatch):
    monkeypatch.setattr(fused_fft, "launches",
                        dict.fromkeys(fused_fft.KERNELS, 0))
    ax, ay, T = (torch.from_numpy(a) for a in _inputs(2, 5, 64, 640))
    got = fused_fft.fused_corr(ax, ay, T)
    assert not any(fused_fft.launches.values())
    torch.testing.assert_close(got, fused_fft.fused_corr_plain(ax, ay, T),
                               rtol=0, atol=0)


def test_plain_is_the_defining_formula():
    """C = IDFT(DFT(ax·T)·conj(DFT(ay·T)))·conj(T), row by row, against
    a float64 numpy evaluation."""
    ax, ay, T = _inputs(1, 3, 32, 96, seed=4)
    got = fused_fft.fused_corr_plain(*(torch.from_numpy(a)
                                       for a in (ax, ay, T))).numpy()
    t = T[0].astype(np.float64) + 1j * T[1]
    x = (ax[0, 0] + 1j * ax[0, 1].astype(np.float64)) * t
    y = (ay[0, 0] + 1j * ay[0, 1].astype(np.float64)) * t
    c = np.fft.ifft(np.fft.fft(x) * np.conj(np.fft.fft(y))) * np.conj(t)
    np.testing.assert_allclose(got[0, 0], c.real, atol=2e-5)
    np.testing.assert_allclose(got[0, 1], c.imag, atol=2e-5)


@pytest.mark.parametrize("bad", ["N2_not_pow2", "N2_too_long", "T_shape",
                                 "ay_shape", "rank", "float64",
                                 "non_contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ax, ay, T = (torch.from_numpy(a) for a in _inputs(1, 4, 64, 512))
    err = ValueError
    if bad == "N2_not_pow2":
        ax = ay = torch.zeros(1, 2, 4, 250)
        T = torch.zeros(2, 4, 250)
    elif bad == "N2_too_long":
        n2 = 2 * fused_fft.MAX_N2
        ax = ay = torch.zeros(1, 2, 1, n2)
        T = torch.zeros(2, 1, n2)
    elif bad == "T_shape":
        T = T[:, :3].contiguous()
    elif bad == "ay_shape":
        ay = ay[:, :, :3].contiguous()
    elif bad == "rank":
        ax = ax[0]
    elif bad == "float64":
        ax, err = ax.double(), TypeError
    elif bad == "non_contiguous":
        ax = ax.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        fused_fft.fused_corr(ax, ay, T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 24, 256), (4, 2, 529, 8192)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """The CUDA kernel against its plain version on the card, at the
    small shape and the day-scale one."""
    B, _, H, N2 = shape
    ax, ay, T = (torch.from_numpy(a).to(cuda_device)
                 for a in _inputs(B, H, N2, 2 * (H - 1) * N2))
    before = fused_fft.launches["fused_corr"]
    got = fused_fft.fused_corr(ax, ay, T)
    torch.cuda.synchronize()
    assert fused_fft.launches["fused_corr"] == before + 1
    want = fused_fft.fused_corr_plain(ax, ay, T)
    assert ((got - want).abs().max() <= RTOL_OF_MAX
            * want.abs().max()).item()
