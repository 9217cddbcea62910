"""The split stage B (K2) of the PyTorch port
(``xcorr_tpu_torch.ops.fused_fft.stageb_fwd`` / ``stageb_inv``) against
the JAX reference kernels ``xcorr_tpu.ops.pallas_fft.plan_fused_stageb``
run in Pallas interpret mode on the CPU, as ``tests/test_ops.py`` runs
them.

The two forward kernels leave the spectrum in different orders: the
reference's at flat index ``k_p·Q + k_q`` holds frequency ``k_p + P·k_q``,
the port's at position ``p`` holds frequency ``spectrum_order(N2)[p]``
(the order in which the threads of the register passes hold it). The
forward test maps both to natural order; the inverse of the forward is in
natural order on both sides and compares element by element.

Tolerance: max |diff| <= 5e-7 of the output's max |value| for the
forward spectra (float32 FFT against the reference's float32 DFT matmuls
at ``precision='highest'``), and 1e-5 of the max for the whole chain, as
``tests/test_torch_fused_fft.py`` holds K1.
"""
import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import fused_fft

FWD_RTOL_OF_MAX = 5e-7
RTOL_OF_MAX = 1e-5


@pytest.fixture
def stageb_reference():
    """``plan_fused_stageb`` with every ``pl.pallas_call`` interpreted."""
    from jax.experimental import pallas as pl
    from xcorr_tpu.ops import pallas_fft
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = interp
    pallas_fft.plan_fused_stageb.cache_clear()
    try:
        yield pallas_fft
    finally:
        pl.pallas_call = orig
        pallas_fft.plan_fused_stageb.cache_clear()


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


def _rows(a):
    """Port planes (B, 2, N1, N2) -> the reference's (B*N1, N2) re, im."""
    B, _, N1, N2 = a.shape
    return a[:, 0].reshape(B * N1, N2), a[:, 1].reshape(B * N1, N2)


def _pq_to_natural(re, im, N2):
    """The reference's (k_p, k_q) spectrum order -> natural frequency."""
    from xcorr_tpu.ops.pallas_fft import _split_pq_pallas
    P, Q = _split_pq_pallas(N2)
    kp, kq = np.divmod(np.arange(N2), Q)
    nat = np.empty((re.shape[0], N2), dtype=np.complex128)
    nat[:, kp + P * kq] = re + 1j * im.astype(np.float64)
    return nat


def _spectrum_to_natural(f):
    """Port spectrum (B, 2, H, N2) in the kernel's order -> natural
    complex rows (B*H, N2)."""
    N2 = f.shape[-1]
    nat = np.empty_like(f)
    nat[..., fused_fft.spectrum_order(N2).numpy()] = f
    c = nat[:, 0].astype(np.float64) + 1j * nat[:, 1]
    return c.reshape(-1, N2)


def _close(got, want, rtol_of_max):
    return np.abs(got - want).max() <= rtol_of_max * np.abs(want).max()


@pytest.mark.parametrize("N1,N2", [(16, 256), (8, 1024), (8, 16384)])
def test_fwd_plain_matches_pallas_reference(stageb_reference, N1, N2):
    import jax.numpy as jnp
    N = N1 * N2
    ax, _, T = _inputs(2, N1, N2, N)
    fwd, _ = stageb_reference.plan_fused_stageb(N1, N2, N, "highest")
    re, im = (np.asarray(a) for a in fwd(*map(jnp.asarray, _rows(ax))))
    want = _pq_to_natural(re, im, N2)
    got = fused_fft.stageb_fwd_plain(torch.from_numpy(ax),
                                     torch.from_numpy(T)).numpy()
    assert got.shape == ax.shape
    assert _close(_spectrum_to_natural(got), want, FWD_RTOL_OF_MAX)


@pytest.mark.parametrize("N1,N2", [(16, 256), (8, 1024), (8, 16384)])
def test_inv_of_fwd_matches_pallas_reference(stageb_reference, N1, N2):
    """inv(fwd(x), fwd(y)) on both sides, natural order, element by
    element."""
    import jax.numpy as jnp
    N = N1 * N2
    ax, ay, T = _inputs(2, N1, N2, N, seed=1)
    fwd, inv = stageb_reference.plan_fused_stageb(N1, N2, N, "highest")
    fx = fwd(*map(jnp.asarray, _rows(ax)))
    fy = fwd(*map(jnp.asarray, _rows(ay)))
    cre, cim = (np.asarray(a) for a in inv(*fx, *fy))
    want = np.stack([cre.reshape(2, N1, N2), cim.reshape(2, N1, N2)],
                    axis=1)
    tT = torch.from_numpy(T)
    px = fused_fft.stageb_fwd_plain(torch.from_numpy(ax), tT)
    py = fused_fft.stageb_fwd_plain(torch.from_numpy(ay), tT)
    got = fused_fft.stageb_inv_plain(px, py, tT).numpy()
    assert got.shape == want.shape
    assert _close(got, want, RTOL_OF_MAX)


def test_inv_of_fwd_is_k1():
    """The two launches compute K1's function (fused_corr_plain)."""
    ax, ay, T = (torch.from_numpy(a) for a in _inputs(2, 7, 128, 1792))
    f = fused_fft.stageb_fwd_plain(ax, T)
    g = fused_fft.stageb_fwd_plain(ay, T)
    got = fused_fft.stageb_inv_plain(f, g, T)
    want = fused_fft.fused_corr_plain(ax, ay, T)
    assert _close(got.numpy(), want.numpy(), RTOL_OF_MAX)


def _bitrev(p, bits):
    r = np.zeros_like(p)
    for i in range(bits):
        r |= ((p >> i) & 1) << (bits - 1 - i)
    return r


def _thread_map_forward(x):
    """The forward passes of csrc/fft_reg.cuh on one row, as its thread
    map runs them: pass i's butterfly (u, t) takes the elements at
    ``pos(u, j, t)``, j < r, does a radix-r DFT (output p in register
    slot ``u·r + bitrev(p)``) and the pass twiddle ``W_L^(lo·p)``; the
    row is then stored as stageb.cu stores it, element k of thread t at
    ``k·P + t``."""
    N2 = x.size
    E = min(32, N2)
    P = N2 // E
    t = np.arange(P)[:, None, None]
    row = x.astype(np.complex128)
    for ll, lr in fused_fft._k1_passes(N2):
        r, lm = 1 << lr, ll - lr
        u = np.arange(E // r)[None, :, None]
        j = np.arange(r)[None, None, :]
        b = u * P + t
        lo = b & ((1 << lm) - 1)
        pos = ((b >> lm) << ll) + lo + (j << lm)
        y = np.fft.fft(row[pos], axis=-1) * np.exp(
            -2j * np.pi * lo * j / (1 << ll))
        row = row.copy()
        row[pos] = y
    regs = np.empty((P, E), complex)  # after the last pass
    slots = np.broadcast_to(u * r + _bitrev(j, lr), y.shape)
    regs[np.broadcast_to(np.arange(P)[:, None, None], y.shape), slots] = y
    out = np.empty(N2, complex)
    out[np.arange(E)[None, :] * P + np.arange(P)[:, None]] = regs
    return out


@pytest.mark.parametrize("N2", [2, 8, 32, 256, 2048, 16384])
def test_spectrum_order_is_the_thread_maps_order(N2):
    """spectrum_order is a permutation and reorders a natural FFT into
    the spectrum the register passes leave, as an emulation of their
    thread map in numpy produces it."""
    idx = fused_fft.spectrum_order(N2).numpy()
    np.testing.assert_array_equal(np.sort(idx), np.arange(N2))
    rng = np.random.default_rng(2)
    x = rng.normal(size=N2) + 1j * rng.normal(size=N2)
    np.testing.assert_allclose(_thread_map_forward(x), np.fft.fft(x)[idx],
                               rtol=0, atol=1e-9 * N2)


def test_wrappers_take_plain_route_on_cpu(monkeypatch):
    monkeypatch.setattr(fused_fft, "launches",
                        dict.fromkeys(fused_fft.KERNELS, 0))
    ax, ay, T = (torch.from_numpy(a) for a in _inputs(2, 5, 64, 640))
    f = fused_fft.stageb_fwd(ax, T)
    g = fused_fft.stageb_fwd(ay, T)
    torch.testing.assert_close(f, fused_fft.stageb_fwd_plain(ax, T),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused_fft.stageb_inv(f, g, T),
                               fused_fft.stageb_inv_plain(f, g, T),
                               rtol=0, atol=0)
    assert not any(fused_fft.launches.values())


@pytest.mark.parametrize("bad", ["N2_not_pow2", "T_shape", "fy_shape",
                                 "float64", "non_contiguous"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    ax, ay, T = (torch.from_numpy(a) for a in _inputs(1, 4, 64, 512))
    err = ValueError
    if bad == "N2_not_pow2":
        ax = ay = torch.zeros(1, 2, 4, 96)
        T = torch.zeros(2, 4, 96)
    elif bad == "T_shape":
        T = T[:, :3].contiguous()
    elif bad == "fy_shape":
        ay = ay[:, :, :3].contiguous()
    elif bad == "float64":
        ax, err = ax.double(), TypeError
    elif bad == "non_contiguous":
        ax = ax.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        fused_fft.stageb_inv(ax, ay, T)
    if bad != "fy_shape":
        with pytest.raises(err):
            fused_fft.stageb_fwd(ax, T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 24, 256), (8, 2, 529, 8192),
                                   (1, 2, 3, 16384), (8, 2, 265, 16384)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    """fwd and inv on the card against their plain versions, element by
    element in the kernel's order, at the small shape, the n1 = 1056
    day-scale one, one row of 16384 and the n1 = 528 pair-day one; a
    second launch of each gives the same bits."""
    B, _, H, N2 = shape
    ax, ay, T = (torch.from_numpy(a).to(cuda_device)
                 for a in _inputs(B, H, N2, 2 * (H - 1) * N2))
    before = dict(fused_fft.launches)
    f = fused_fft.stageb_fwd(ax, T)
    g = fused_fft.stageb_fwd(ay, T)
    c = fused_fft.stageb_inv(f, g, T)
    torch.cuda.synchronize()
    assert fused_fft.launches["stageb_fwd"] == before["stageb_fwd"] + 2
    assert fused_fft.launches["stageb_inv"] == before["stageb_inv"] + 1
    assert torch.equal(f, fused_fft.stageb_fwd(ax, T))
    assert torch.equal(c, fused_fft.stageb_inv(f, g, T))
    for got, want in ((f, fused_fft.stageb_fwd_plain(ax, T)),
                      (c, fused_fft.stageb_inv_plain(f, g, T))):
        assert ((got - want).abs().max()
                <= RTOL_OF_MAX * want.abs().max()).item()
