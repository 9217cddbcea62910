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
        n2 = 2 * fused_fft.MAX_N2["fused_corr"]
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


def _kernel_args(kernel, N2):
    """The smallest arguments each wrapper takes, rows of length N2."""
    z = torch.zeros
    planes = (z(1, 2, 1, N2), z(1, 2, 1, N2), z(2, 1, N2))
    return {"fused_corr": planes,
            "stageb_fwd": planes[1:],
            "stageb_inv": planes,
            "fused_corr_acc": planes + (z(1, 2),),
            "fused_corr_full": (z(1, 1, N2), z(1, 1, N2), z(2, 1),
                                z(2, 1, N2), z(1, 2))}[kernel]


@pytest.mark.parametrize("kernel", fused_fft.KERNELS)
def test_each_wrapper_refuses_rows_above_its_own_limit(kernel):
    """Every kernel takes rows of 16384 (all keep a row in registers,
    on the passes of csrc/fft_reg.cuh) and refuses 32768."""
    fn = getattr(fused_fft, kernel)
    top = fused_fft.MAX_N2[kernel]
    assert top == 16384
    assert fn(*_kernel_args(kernel, top)).abs().max().item() == 0.0
    with pytest.raises(ValueError, match="power of two"):
        fn(*_kernel_args(kernel, 2 * top))


@pytest.mark.parametrize("N2", [2, 32, 64, 2048, 8192, 16384])
def test_k1_twiddle_table_is_the_thread_maps_lookup(N2):
    """For every pass of K1's row transform with m = L / r > 1, the table
    gives W_L^(lo·p) = A[p][lo % a] · B[p][lo / a] for every lo < m and
    p < r (csrc/fft_reg.cuh), and the block's shared memory (x spectrum,
    table, padded exchange buffer) fits the card's 227 KB."""
    tab = fused_fft._k1_twiddles(N2, "cpu").numpy().astype(np.float64)
    w = tab[:, 0] + 1j * tab[:, 1]
    passes = fused_fft._k1_passes(N2)
    assert sum(r for _, r in passes) == N2.bit_length() - 1
    off = 0
    for ll, lr in passes:
        L, r, m = 1 << ll, 1 << lr, 1 << (ll - lr)
        if m == 1:
            continue
        a, nb = min(32, m), m // min(32, m)
        A = w[off:off + r * a].reshape(r, a)
        off += r * a
        B = np.ones((r, 1))
        if nb > 1:
            B = w[off:off + r * nb].reshape(r, nb)
            off += r * nb
        lo, p = np.arange(m)[None, :], np.arange(r)[:, None]
        got = A[:, lo[0] % a] * B[:, lo[0] // a]
        np.testing.assert_allclose(got, np.exp(-2j * np.pi * lo * p / L),
                                   rtol=0, atol=3e-7)
    assert off == len(w)
    assert 8 * N2 + 8 * len(w) + 4 * (N2 + N2 // 32) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 24, 256), (4, 2, 529, 8192),
                                   (1, 2, 3, 16384), (4, 2, 265, 16384)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """The CUDA kernel against its plain version on the card, at the
    small shape, the n1 = 1056 day-scale one, one row of 16384 and the
    n1 = 528 day-scale one; a second launch gives the same bits."""
    B, _, H, N2 = shape
    ax, ay, T = (torch.from_numpy(a).to(cuda_device)
                 for a in _inputs(B, H, N2, 2 * (H - 1) * N2))
    before = fused_fft.launches["fused_corr"]
    got = fused_fft.fused_corr(ax, ay, T)
    again = fused_fft.fused_corr(ax, ay, T)
    torch.cuda.synchronize()
    assert fused_fft.launches["fused_corr"] == before + 2
    assert torch.equal(got, again)
    want = fused_fft.fused_corr_plain(ax, ay, T)
    assert ((got - want).abs().max() <= RTOL_OF_MAX
            * want.abs().max()).item()
