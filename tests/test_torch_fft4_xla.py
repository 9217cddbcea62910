"""The four-step correlation's ``stageb='fft'|'matmul'`` branches of the
PyTorch port (``xcorr_tpu_torch.ops.fft4.StageBPlan``: K2's plain
versions and the six-step products on the CPU), ``packed``, their
sequence-parallel ``mesh=``, the precision knob and the small carried
functions (``traffic_model``, ``ops.cc.correlate_fn``,
``ops.fft.rfft``/``irfft``/``rfft_freqs``), against the JAX package's
``xcorr_tpu.ops.fft4.plan_correlate4(..., stageb='fft'|'matmul')`` and
its other counterparts on the CPU.

Tolerances (normalized CCF values are O(0.05) at n = 2000):
- against the same JAX branch: rtol 2e-6, atol 5e-8, as
  ``tests/test_ops.py`` holds its pre-padded and seq-sharded plans
  (both sides are float32; only the order of sums differs);
- against the float64 oracle: 1e-6 abs, the repository's bar;
- a split or a pre-padded input against the unsplit, self-padding plan:
  rtol 2e-6, atol 5e-8.

``precision='default'``'s one-pass products are held to the float64
oracle in ``tests/test_torch_split_tf32.py``, beside the emulation of
K3's and K4's products.

The JAX package is imported inside the tests (the ``jfft4`` fixture):
the card's machine, which runs the ``cuda`` tests, has no jax.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from xcorr_tpu_torch.ops import cc as tcc
from xcorr_tpu_torch.ops import fft4 as tfft4
from xcorr_tpu_torch.ops import filter as ops_filter
from xcorr_tpu_torch.ops import fused_fft, precision
from xcorr_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
N = 2000
WINDOWS = [(1999, 3000), (500, 1500), (1500, 2500)]
RTOL, ATOL = 2e-6, 5e-8
ATOL_F64 = 1e-6
# (stageb, packed) of the three branches
BRANCHES = [("fft", False), ("matmul", False), ("fft", True)]
BRANCH_IDS = ["fft", "matmul", "packed"]


def _inputs(b=4, seed=7, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)).astype(np.float32)
    y = rng.normal(size=(b, n)).astype(np.float32)
    return x, y


def _oracle(x, y, imin, imax):
    """Normalized CCFs on the fftshifted lag window, float64 numpy."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    n = x.shape[-1]
    nfft = 1 << (2 * n - 2).bit_length()
    r = np.fft.irfft(np.fft.rfft(x, nfft) * np.conj(np.fft.rfft(y, nfft)),
                     nfft)
    idx = (np.arange(imin, imax) - (n - 1)) % nfft
    norms = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
    return r[:, idx] / norms[:, None]


@pytest.fixture(scope="module")
def jfft4():
    """The JAX package's ``ops.fft4``."""
    from xcorr_tpu.ops import fft4
    return fft4


def _port(plan, x, y):
    return plan(torch.from_numpy(x), torch.from_numpy(y)).numpy()


@pytest.fixture
def k2_spy(monkeypatch):
    """Counts of the K2 wrapper calls the plan makes."""
    calls = {"stageb_fwd": 0, "stageb_inv": 0}

    def spy(name):
        fn = getattr(fused_fft, name)

        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(tfft4, name, wrapped)
    spy("stageb_fwd")
    spy("stageb_inv")
    return calls


# -- the branches against the JAX package's ----------------------------------

@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n1", [16, 32])
@pytest.mark.parametrize("stageb,packed", BRANCHES, ids=BRANCH_IDS)
def test_branch_matches_reference_and_f64(stageb, packed, n1, window,
                                          jfft4):
    imin, imax = window
    x, y = _inputs()
    want = np.asarray(jfft4.plan_correlate4(
        N, imin, imax, n1=n1, stageb=stageb, packed=packed)(x, y))
    plan = tfft4.plan_correlate4(N, imin, imax, n1=n1, stageb=stageb,
                                 packed=packed)
    assert isinstance(plan, tfft4.StageBPlan) and plan.N1 == n1
    got = _port(plan, x, y)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _oracle(x, y, imin, imax), rtol=0,
                               atol=ATOL_F64)


@pytest.mark.parametrize("given", ["cpu tensors", "arrays, device='cpu'"])
@pytest.mark.parametrize("stageb", ["fft", "matmul"])
def test_correlate4_one_shot_matches_reference(stageb, given, jfft4):
    """``correlate4`` with the JAX package's one-shot defaults (n1 =
    512), on CPU tensors (which stay on the CPU) and on arrays sent to
    the CPU by name."""
    x, y = _inputs(b=2, seed=1)
    want = np.asarray(jfft4.correlate4(x, y, index_min=999,
                                       index_max=3000, stageb=stageb))
    if given == "cpu tensors":
        args, kw = (torch.from_numpy(x), torch.from_numpy(y)), {}
    else:
        args, kw = (x, y), {"device": "cpu"}
    got = tfft4.correlate4(*args, index_min=999, index_max=3000,
                           stageb=stageb, **kw)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_correlate4_arrays_default_to_the_card(monkeypatch):
    """Arrays go to the card unless the caller names the CPU, and the
    call raises when torch sees no card: no silent run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _inputs(b=1, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfft4.correlate4(x, y, index_min=999, index_max=3000)


@pytest.mark.parametrize("stageb,packed", BRANCHES, ids=BRANCH_IDS)
def test_pre_padded_matches_self_padding(stageb, packed, jfft4):
    """As ``tests/test_ops.py``'s pre-padded test: ``(B, padded_len(n))``
    inputs with a zero tail give the self-padding plan's result."""
    imin, imax = 1999, 3000
    x, y = _inputs(b=2, seed=5)
    plen = tfft4.padded_len(N, n1=16, stageb=stageb)
    assert plen == jfft4.padded_len(N, n1=16, stageb=stageb)

    def padded(v):
        out = np.zeros((v.shape[0], plen), np.float32)
        out[:, :N] = v
        return out

    kw = dict(n1=16, stageb=stageb, packed=packed)
    want = _port(tfft4.plan_correlate4(N, imin, imax, **kw), x, y)
    got = _port(tfft4.plan_correlate4(N, imin, imax, pre_padded=True, **kw),
                padded(x), padded(y))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = np.asarray(jfft4.plan_correlate4(N, imin, imax, pre_padded=True,
                                           **kw)(padded(x), padded(y)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_day_scale_geometry(jfft4):
    """At n = 4,320,000 the branches take n1 = 576: N2 = 16384 (a power
    of two, K2's largest row; the JAX package's TPU length is 15360) and
    all 576 rows."""
    n = 4_320_000
    for stageb in ("fft", "matmul"):
        assert tfft4.padded_len(n, stageb=stageb) == 264 * 16384
    assert tfft4.padded_len(n) == 264 * 16384  # the kernel route's n1 528
    assert tfft4._pick_factors(2 * n - 1, 576) == (576, 16384)
    assert tfft4._split_pq(16384) == (128, 128)
    assert tfft4._split_pq(256) == jfft4._split_pq(256) == (16, 16)
    assert tfft4._split_pq(128) == jfft4._split_pq(128) == (16, 8)
    with pytest.raises(ValueError, match="factorization"):
        tfft4._split_pq(3)
    # K2 takes rows up to 16384: N2 = 32768 is refused before any table
    with pytest.raises(ValueError, match="power of two"):
        tfft4.plan_correlate4(100_000, n1=8, stageb="fft")


def test_unknown_stageb_raises():
    with pytest.raises(ValueError, match="stageb"):
        tfft4.plan_correlate4(N, stageb="xla")


# -- the seq split --------------------------------------------------------

@pytest.mark.parametrize("stageb", ["fft", "matmul"])
def test_seq_split_matches_unsplit_and_reference_mesh(stageb, jfft4):
    """``("batch", "seq")`` of shape (2, 4) over eight CPU entries,
    against the unsplit plan and (``'matmul'``: the JAX CPU FFT cannot be
    sharded) the JAX package's seq-sharded plan on its 8-device mesh."""
    import jax
    from jax.sharding import Mesh
    n, imin, imax = 2000, 1500, 3000
    x, y = _inputs()
    mesh = make_mesh(devices=["cpu"] * 8, axis_names=("batch", "seq"),
                     shape=(2, 4))
    got = _port(tfft4.plan_correlate4(n, imin, imax, n1=16, stageb=stageb,
                                      mesh=mesh), x, y)
    want = _port(tfft4.plan_correlate4(n, imin, imax, n1=16,
                                       stageb=stageb), x, y)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jmesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(2, 4),
                 ("batch", "seq"))
    ref = np.asarray(jfft4.plan_correlate4(n, imin, imax, n1=16,
                                           stageb="matmul", mesh=jmesh)(x, y))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stageb", ["fft", "matmul"])
def test_seq_only_mesh_and_missing_axis_names(stageb, jfft4):
    """A seq-only mesh (the absent batch axis splits nothing) matches the
    unsplit plan and the JAX package's seq-only plan; axis names the mesh
    lacks split nothing at all (the same bits as no mesh)."""
    import jax
    from jax.sharding import Mesh
    n, imin, imax = 2000, 1999, 3000
    x, y = _inputs(b=2, seed=8)
    unsplit = _port(tfft4.plan_correlate4(n, imin, imax, n1=16,
                                          stageb=stageb), x, y)
    mesh = make_mesh(devices=["cpu"] * 4, axis_names=("seq",))
    got = _port(tfft4.plan_correlate4(n, imin, imax, n1=16, stageb=stageb,
                                      mesh=mesh), x, y)
    np.testing.assert_allclose(got, unsplit, rtol=RTOL, atol=ATOL)
    jmesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("seq",))
    ref = np.asarray(jfft4.plan_correlate4(n, imin, imax, n1=16,
                                           stageb="matmul", mesh=jmesh)(x, y))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    other = make_mesh(devices=["cpu"] * 3, axis_names=("x",))
    for m, axes in ((other, ("batch", "seq")), (mesh, (None, None))):
        same = _port(tfft4.plan_correlate4(n, imin, imax, n1=16,
                                           stageb=stageb, mesh=m,
                                           mesh_axes=axes), x, y)
        np.testing.assert_array_equal(same, unsplit)


def test_mesh_rejects_pallas_and_packed(jfft4):
    """The JAX package's errors, for the same reasons."""
    import jax
    from jax.sharding import Mesh
    mesh = make_mesh(devices=["cpu"] * 4, axis_names=("seq",))
    jmesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("seq",))
    for fft4, m in ((tfft4, mesh), (jfft4, jmesh)):
        with pytest.raises(ValueError, match="single-chip"):
            fft4.plan_correlate4(2000, 1999, 3000, n1=16, stageb="pallas",
                                 mesh=m)
        with pytest.raises(ValueError, match="packed"):
            fft4.plan_correlate4(2000, 1999, 3000, n1=16, stageb="fft",
                                 packed=True, mesh=m)
        with pytest.raises(ValueError, match="packed Hermitian split "
                                             "assumes natural"):
            fft4.plan_correlate4(2000, 1999, 3000, n1=16, stageb="matmul",
                                 packed=True)


def test_split2_shares():
    """The two-axis split: ``batch_sharding``'s linspace shares on each
    axis, empty shares dropped, devices from the mesh's grid."""
    from xcorr_tpu_torch.parallel.mesh import batch_sharding, split2
    mesh = make_mesh(devices=[f"cpu:{i}" for i in range(6)],
                     axis_names=("batch", "seq"), shape=(2, 3))
    got = split2(mesh, 5, 10)
    assert [(a, b) for a, b, _ in got] == batch_sharding(
        make_mesh(devices=["cpu"] * 2), 5)
    assert [[(str(d), c, e) for d, c, e in ent] for _, _, ent in got] == [
        [("cpu:0", 0, 3), ("cpu:1", 3, 6), ("cpu:2", 6, 10)],
        [("cpu:3", 0, 3), ("cpu:4", 3, 6), ("cpu:5", 6, 10)]]
    # more entries than rows or columns: the empty shares go
    got = split2(mesh, 1, 2)
    assert [(a, b, [(str(d), c, e) for d, c, e in ent])
            for a, b, ent in got] == [(0, 1, [("cpu:4", 0, 1),
                                              ("cpu:5", 1, 2)])]
    assert split2(mesh, 4, 2, axes=("seq", "batch"))[0][2][0][0] == \
        torch.device("cpu:0")


# -- K2 on the path -------------------------------------------------------

@pytest.mark.parametrize("case", ["fft", "packed", "mesh"])
def test_fft_branch_calls_k2(k2_spy, monkeypatch, case):
    """``stageb='fft'`` runs its stage B through K2's wrappers: forward
    twice and inverse once (once each with ``packed``), per seq entry;
    on the CPU the wrappers take the plain versions, so no kernel
    launches."""
    monkeypatch.setattr(fused_fft, "launches",
                        dict.fromkeys(fused_fft.KERNELS, 0))
    x, y = _inputs(b=4, seed=3)
    mesh = None
    if case == "mesh":
        mesh = make_mesh(devices=["cpu"] * 6, axis_names=("batch", "seq"),
                         shape=(2, 3))
    plan = tfft4.plan_correlate4(N, 1999, 3000, n1=32, stageb="fft",
                                 packed=case == "packed", mesh=mesh)
    _port(plan, x, y)
    entries = 6 if case == "mesh" else 1
    fwd = 1 if case == "packed" else 2
    assert k2_spy == {"stageb_fwd": fwd * entries, "stageb_inv": entries}
    assert not any(fused_fft.launches.values())


def test_matmul_branch_calls_no_kernel(k2_spy):
    x, y = _inputs(b=2)
    _port(tfft4.plan_correlate4(N, 1999, 3000, n1=16, stageb="matmul"),
          x, y)
    assert k2_spy == {"stageb_fwd": 0, "stageb_inv": 0}


@pytest.mark.parametrize("N1,N2", [(16, 256), (5, 64), (32, 16384)])
def test_packed_reverse_index_in_k2_order(N1, N2, jfft4):
    """The packed branch's gather in K2's order equals the natural-order
    reversal (``_freq_reverse2``) taken through ``spectrum_order``; the
    port's ``_freq_reverse2`` equals the JAX package's."""
    rng = np.random.default_rng(N1 + N2)
    z = rng.normal(size=(2, N1, N2)) + 1j * rng.normal(size=(2, N1, N2))
    nat = torch.from_numpy(z)
    order = fused_fft.spectrum_order(N2)
    k2 = nat[..., order]
    idx = tfft4._packed_reverse_index(N1, N2)
    got = k2.reshape(2, -1)[:, idx].reshape(2, N1, N2)
    want = tfft4._freq_reverse2(nat)[..., order]
    assert torch.equal(got, want)
    if N2 <= 256:
        import jax.numpy as jnp
        np.testing.assert_array_equal(
            tfft4._freq_reverse2(nat).numpy(),
            np.asarray(jfft4._freq_reverse2(jnp.asarray(z))))


def _k2_inv_inputs(B, H, N2, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return f32(B, 2, H, N2), f32(1, 2, H, N2), f32(2, H, N2)


def test_stageb_inv_reads_one_window_of_fy():
    """K2 inv with a one-window ``fy`` (the packed branch's unit
    spectrum) equals the call with ``fy`` repeated over the batch; any
    other batch of ``fy`` raises."""
    fx, fy, T = _k2_inv_inputs(3, 5, 64, 0)
    got = fused_fft.stageb_inv(fx, fy, T)
    want = fused_fft.stageb_inv(fx, fy.expand(3, -1, -1, -1).contiguous(),
                                T)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one window"):
        fused_fft.stageb_inv(fx, fx[:2].contiguous(), T)


def test_six_step_transform_is_a_dft():
    """The ``'matmul'`` branch's forward row transform is the DFT over
    N2 with position ``k_p·Q + k_q`` holding frequency ``k_p + P·k_q``,
    and its inverse the exact inverse."""
    N2 = 256
    P, Q, six = tfft4._six_step_consts(N2)
    six = {k: torch.from_numpy(v).double() for k, v in six.items()}
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, N2)) + 1j * rng.normal(size=(3, N2))
    planes = torch.from_numpy(np.stack([a.real, a.imag], 1)).view(3, 2, P, Q)
    f = tfft4._right(six["fq"], tfft4._cmul(tfft4._left(six["fp"], planes),
                                            six["t2"], -3))
    kp, kq = np.divmod(np.arange(N2), Q)
    want = np.fft.fft(a, axis=-1)[:, kp + P * kq]
    got = f.reshape(3, 2, N2).numpy()
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, atol=1e-5)
    back = tfft4._left(six["ip"], tfft4._cmul(tfft4._right(six["iq"], f),
                                              six["t2"], -3, conj=True))
    np.testing.assert_allclose(back.reshape(3, 2, N2).numpy(),
                               np.stack([a.real, a.imag], 1), atol=1e-6)


# -- precision ------------------------------------------------------------

def test_precision_knob_validated(monkeypatch):
    """As ``tests/test_ops.py``: bad values raise (keyword and
    ``XCORR_CC_PRECISION``); the keyword and the variable give the same
    result, here on the four-step path."""
    monkeypatch.delenv("XCORR_CC_PRECISION", raising=False)
    x = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="precision"):
        tcc.correlate(x, x, precision="bogus")
    with pytest.raises(ValueError, match="precision"):
        tcc.correlate(x, x, precision="high_block")
    with pytest.raises(ValueError, match="precision"):
        tfft4.plan_correlate4(N, precision="bogus")
    monkeypatch.setenv("XCORR_CC_PRECISION", "nope")
    with pytest.raises(ValueError, match="precision"):
        tcc.correlate(x, x)
    a, b = (torch.from_numpy(v) for v in _inputs(b=2, seed=4))
    kw = dict(index_min=1999, index_max=3000, method="fourstep")
    monkeypatch.setenv("XCORR_FFT4_FUSED_INV", "1")
    monkeypatch.setenv("XCORR_CC_PRECISION", "default")
    r_env = tcc.correlate(a, b, **kw)
    monkeypatch.delenv("XCORR_CC_PRECISION")
    r_kw = tcc.correlate(a, b, precision="default", **kw)
    assert torch.equal(r_env, r_kw)
    assert not torch.equal(r_kw, tcc.correlate(a, b, **kw))


def test_cc_precision_option_sets_the_variable(monkeypatch, tmp_path):
    """``xcorr-torch-cc --cc-precision`` sets ``XCORR_CC_PRECISION``
    before the campaign runs, as ``xcorr-cc`` does."""
    from xcorr_tpu.core import lazy as jlazy
    from xcorr_tpu.scripts import cc as jcc
    from xcorr_tpu_torch.core import lazy as tlazy
    from xcorr_tpu_torch.scripts import cc as tcli
    seen = []

    def stub(*a, **k):
        seen.append(os.environ.get("XCORR_CC_PRECISION"))
        return []
    monkeypatch.setattr(jlazy, "lazy_process", stub)
    monkeypatch.setattr(tlazy, "lazy_process", stub)
    args = ["--root", str(tmp_path), "--start", "2014-01-01", "--end",
            "2014-01-01", "--pair", "IM.H03S1..EDH-IM.H03S2..EDH"]
    for main, extra in ((jcc.main, []), (tcli.main, ["--platform", "cpu"])):
        monkeypatch.setenv("XCORR_CC_PRECISION", "high")
        assert main(args + extra) == 0
        assert main(args + extra + ["--cc-precision", "default"]) == 0
    assert seen == ["high", "default"] * 2
    with pytest.raises(SystemExit):
        tcli.main(args + ["--cc-precision", "high_block"])


@pytest.mark.parametrize("stageb,route", [("pallas", "corr"),
                                          ("pallas", "acc"),
                                          ("pallas", "full"),
                                          ("fft", None), ("matmul", None)])
def test_high_block_where_the_reference_takes_it(stageb, route,
                                                 monkeypatch, jfft4):
    """``'high_block'`` is taken by the ``corr`` route (as ``'high'``)
    and raises on every other plan, where the JAX package's plans raise
    (its accumulator and full plans, ``tests/test_ops.py:478-488``, and
    its XLA branches, which have no such precision)."""
    from xcorr_tpu.ops import pallas_fft
    x, y = _inputs(b=2, seed=9)
    kw = dict(n1=16, stageb=stageb, route=route)
    if (stageb, route) == ("pallas", "corr"):
        got = _port(tfft4.plan_correlate4(N, 1999, 3000,
                                          precision="high_block", **kw),
                    x, y)
        want = _port(tfft4.plan_correlate4(N, 1999, 3000, **kw), x, y)
        np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(ValueError, match="high_block"):
        tfft4.plan_correlate4(N, 1999, 3000, precision="high_block", **kw)
    if stageb != "pallas":
        with pytest.raises(KeyError):
            jfft4.plan_correlate4(N, 1999, 3000, n1=16, stageb=stageb,
                                  precision="high_block")
    elif route == "acc":
        with pytest.raises(ValueError, match="high_block"):
            pallas_fft.plan_fused_corr_acc(16, 1024, 16384, 8,
                                           precision="high_block")
    else:
        with pytest.raises(ValueError, match="high_block"):
            pallas_fft.plan_fused_corr_full(16, 1024, 16384, 8, 8,
                                            precision="high_block")


@pytest.mark.parametrize("stageb,route", [("pallas", "corr"),
                                          ("fft", None), ("matmul", None)])
def test_default_precision_sets_tf32_per_product(stageb, route,
                                                 monkeypatch):
    """Which ``torch.matmul`` products run with the TF32 switch on: under
    ``'default'`` every product of the ``corr`` route, and only stage A
    (one product per signal) on the ``'fft'`` and ``'matmul'`` branches;
    under ``'high'`` none. On the CPU torch ignores the switch, so the
    two precisions give the same bits here (only K3's and K4's plain
    versions round to TF32, ``test_torch_split_tf32.py``)."""
    x, y = _inputs(b=2, seed=6)
    kw = dict(n1=16, stageb=stageb, route=route)
    high = tfft4.plan_correlate4(N, 1999, 3000, **kw)
    default = tfft4.plan_correlate4(N, 1999, 3000, precision="default",
                                    **kw)
    matmul, seen = torch.matmul, []

    def spy(a, b):
        seen.append(bool(torch.backends.cuda.matmul.allow_tf32))
        return matmul(a, b)
    monkeypatch.setattr(torch, "matmul", spy)
    want = _port(high, x, y)
    assert seen and not any(seen)
    seen.clear()
    got = _port(default, x, y)
    if stageb == "pallas":
        assert seen == [True] * 3           # stage A twice, the inverse
    else:
        # stage A of x and of y; for 'matmul' each before its six-step
        assert seen[0] and sum(seen) == 2 and not seen[-1]
    assert not tfft4.tf32_enabled()
    np.testing.assert_array_equal(got, want)


def _sosfilt_input():
    """A float32 signal of more than one chunk of ``ops.filter``, so
    that the IIR filter's chunk carry runs its two products."""
    n = ops_filter._CHUNK * 2 + 1000
    return torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, n)).astype(np.float32))


def test_tf32_switch_is_scoped_and_locked(monkeypatch):
    """A ``'default'`` call's TF32 switch is on only inside
    ``ops.precision.products`` under the lock: a float32 plan call and
    the IIR filter's float32 products in other threads wait for it and
    run with the switch off; a plan raises if TF32 was switched on
    outside a plan."""
    x, y = (torch.from_numpy(v) for v in _inputs(b=1, seed=2))
    high = tfft4.plan_correlate4(N, 1999, 3000, n1=16)
    sos = ops_filter.butter_sos(4, (0.01, 10.0), "bandpass", 50.0)
    sig = _sosfilt_input()
    want = ops_filter.sosfilt(sos, sig)
    matmul, seen = torch.matmul, []

    def spy(a, b):
        seen.append(bool(torch.backends.cuda.matmul.allow_tf32))
        return matmul(a, b)
    switches = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    precision.pin_fp32()
    monkeypatch.setattr(torch, "matmul", spy)
    try:
        done, out = threading.Event(), {}

        def work():
            out["ccf"] = high(x, y)
            out["filtered"] = ops_filter.sosfilt(sos, sig)
            done.set()
        with precision.products(tf32=True):
            assert torch.backends.cuda.matmul.allow_tf32
            t = threading.Thread(target=work)
            t.start()
            assert not done.wait(0.3)
        t.join(60)
        assert done.is_set() and not tfft4.tf32_enabled()
        assert seen and not any(seen)
        torch.testing.assert_close(out["filtered"], want, rtol=0, atol=0)
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            high(x, y)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = switches


def test_filter_products_run_without_tf32(monkeypatch):
    """The IIR filter's chunk-carry products run with the TF32 switch
    off, even when the caller left it on, and restore it afterwards."""
    sos = ops_filter.butter_sos(4, 1.0, "highpass", 50.0)
    sig = _sosfilt_input()
    want = ops_filter.sosfilt(sos, sig)
    matmul, seen = torch.matmul, []

    def spy(a, b):
        seen.append(bool(torch.backends.cuda.matmul.allow_tf32))
        return matmul(a, b)
    monkeypatch.setattr(torch, "matmul", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = ops_filter.sosfilt(sos, sig)
    assert seen == [False] * 4     # two sections, two products each
    assert torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the small carried functions ------------------------------------------

@pytest.mark.parametrize("n,n1,window", [(1910, 30, (1000, 2500)),
                                         (1790, 14, None),
                                         (1460, 46, (1459, 2000))])
def test_traffic_model_matches_reference(n, n1, window, jfft4):
    """Where both count the same rows (N1/2 + 1 a multiple of 8, so the
    JAX package's 8-row rounding adds none) and pick the same N2."""
    imin, imax = window or (None, None)
    assert (tfft4._pick_factors(2 * n - 1, n1)
            == jfft4._pick_factors(2 * n - 1, n1))
    assert (tfft4.traffic_model(n, imin, imax, n1=n1, batch=4)
            == jfft4.traffic_model(n, imin, imax, n1=n1, batch=4))


def test_traffic_model_default_geometry():
    """The default n1 is the kernel route's (528 at day scale: H = 265)."""
    n = 4_320_000
    assert tfft4.traffic_model(n) == tfft4.traffic_model(n, n1=528)
    plane = 265 * 16384 * 4
    out_rows = len(tfft4._plan(n, 0, 2 * n - 1, 528)["out_rows"])
    assert tfft4.traffic_model(n, batch=1) == (
        2 * (264 * 16384 * 4 + 2 * plane) + 6 * plane
        + 2 * plane + out_rows * 16384 * 4 + 2 * (2 * n - 1) * 4)


def test_correlate_fn_is_correlate():
    x, y = (torch.from_numpy(v) for v in _inputs(b=2, seed=11, n=300))
    fn = tcc.correlate_fn(300, index_min=100, index_max=400,
                          normalize=False)
    assert torch.equal(fn(x, y), tcc.correlate(x, y, index_min=100,
                                               index_max=400,
                                               normalize=False))


def test_rfft_helpers_match_reference():
    import jax.numpy as jnp
    from xcorr_tpu.ops import fft as jfft
    from xcorr_tpu_torch.ops import fft as tfft
    x = np.random.default_rng(12).normal(size=(3, 100))
    got = tfft.rfft(torch.from_numpy(x), 128)
    want = np.asarray(jfft.rfft(jnp.asarray(x), 128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    back = tfft.irfft(got, 128).numpy()
    np.testing.assert_allclose(back, np.asarray(jfft.irfft(
        jnp.asarray(want), 128)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(back[:, :100], x, atol=1e-12)
    np.testing.assert_array_equal(tfft.rfft_freqs(128, 0.02),
                                  jfft.rfft_freqs(128, 0.02))


def test_slice_runs_without_jax(tmp_path):
    """The branches, ``packed`` and the seq split run in a process that
    never loads jax or the JAX package, and ``chip_smoke.py`` imports
    neither."""
    code = (
        "import sys, numpy as np, torch\n"
        "sys.path.insert(0, %r)\n"
        "import chip_smoke\n"
        "from xcorr_tpu_torch.ops import fft4\n"
        "from xcorr_tpu_torch.parallel import make_mesh\n"
        "x, y = (torch.from_numpy(np.random.default_rng(i).normal(\n"
        "    size=(2, 2000)).astype(np.float32)) for i in (0, 1))\n"
        "m = make_mesh(devices=['cpu'] * 4, axis_names=('batch', 'seq'),\n"
        "              shape=(2, 2))\n"
        "for kw in ({'stageb': 'fft'}, {'stageb': 'fft', 'packed': True},\n"
        "           {'stageb': 'matmul', 'mesh': m},\n"
        "           {'stageb': 'fft', 'mesh': m}):\n"
        "    out = fft4.plan_correlate4(2000, 1999, 3000, n1=16, **kw)(x, y)\n"
        "    assert out.shape == (2, 1001)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'xcorr_tpu'))\n"
        "assert not bad, bad\n") % str(ROOT)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT)] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stageb,packed", BRANCHES, ids=BRANCH_IDS)
def test_branch_on_card_matches_cpu(cuda_device, stageb, packed):
    """The branch on the card (K2 for ``'fft'``: two forward launches and
    one inverse, one each with ``packed``) against the same plan on the
    CPU and the float64 oracle."""
    imin, imax = 1999, 3000
    x, y = _inputs()
    plan = tfft4.plan_correlate4(N, imin, imax, n1=32, stageb=stageb,
                                 packed=packed)
    before = dict(fused_fft.launches)
    got = plan(torch.from_numpy(x).to(cuda_device),
               torch.from_numpy(y).to(cuda_device))
    torch.cuda.synchronize()
    counts = {k: fused_fft.launches[k] - before[k]
              for k in fused_fft.KERNELS}
    want_fwd = 0 if stageb == "matmul" else (1 if packed else 2)
    assert counts["stageb_fwd"] == want_fwd
    assert counts["stageb_inv"] == (stageb == "fft")
    np.testing.assert_allclose(got.cpu().numpy(), _port(plan, x, y),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.cpu().numpy(), _oracle(x, y, imin, imax),
                               rtol=0, atol=ATOL_F64)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N2", [(4, 24, 256), (16, 576, 16384)])
def test_stageb_inv_one_window_fy_on_card(cuda_device, B, H, N2):
    """K2 inv on the card with a one-window ``fy`` against its plain
    version (1e-5 of the max, ``chip_smoke.py``'s K_RTOL) and against
    the launch with ``fy`` repeated over the batch (the same bits)."""
    fx, fy, T = (a.to(cuda_device) for a in _k2_inv_inputs(B, H, N2, 1))
    got = fused_fft.stageb_inv(fx, fy, T)
    full = fused_fft.stageb_inv(
        fx, fy.expand(B, -1, -1, -1).contiguous(), T)
    want = fused_fft.stageb_inv_plain(fx, fy, T)
    assert torch.equal(got, full)
    assert ((got - want).abs().max() <= 1e-5 * want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_corr_acc", "fused_corr_full"])
def test_one_pass_products_on_card(cuda_device, kernel):
    """K3 and K4 with one TF32 pass against their one-pass plain version,
    within TF32's unit roundoff (2^-11) of the max: the kernel's C and
    the plain version's differ in their last float32 bits, so an operand
    near a TF32 rounding boundary rounds to neighbouring TF32 values in
    the two (1.5e-4 of the max on an H100 at this shape). Further from
    the three-pass result than from that plain version."""
    rng = np.random.default_rng(0)
    B, H, N2, rows_in, rows_out = 2, 24, 256, 8, 5

    def cu(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device)
    if kernel == "fused_corr_acc":
        args = (cu(B, 2, H, N2), cu(B, 2, H, N2), cu(2, H, N2),
                cu(rows_out, 2 * H))
    else:
        args = (cu(B, rows_in, N2), cu(B, rows_in, N2), cu(2 * H, rows_in),
                cu(2, H, N2), cu(rows_out, 2 * H))
    fn = getattr(fused_fft, kernel)
    one, three = fn(*args, 1), fn(*args, 3)
    want = getattr(fused_fft, kernel + "_plain")(*args, 1)
    gap = (one - want).abs().max()
    assert (gap <= 2.0 ** -11 * want.abs().max()).item()
    # one pass, not three: further from the three-pass result than from
    # its own plain version
    assert ((one - three).abs().max() > gap).item()
