r"""
:mod:`ops.fused_fft` -- The hand-written stage-B kernels (K1-K4)
================================================================

Counterpart of ``xcorr_tpu/ops/pallas_fft.py``: every Pallas kernel of the
four-step correlation (:mod:`ops.fft4`) as a CUDA kernel for ``sm_90a``
(sources in ``xcorr_tpu_torch/csrc``, built at first use by
:mod:`ops._build`). With ``T = exp(-2πi·k1·n2/N)`` the outer twiddle, for
each ``(b, k1)`` row of the packed stage-A planes:

* **K1** :func:`fused_corr` (``fused_corr.cu``, replaces
  ``plan_fused_corr``): the whole stage B in one launch, natural order::

      C[b,k1,:] = IDFT_N2( DFT_N2(Ax[b,k1,:]·T[k1,:])
                           · conj(DFT_N2(Ay[b,k1,:]·T[k1,:])) ) · conj(T[k1,:])

* **K2** :func:`stageb_fwd` / :func:`stageb_inv` (``stageb.cu``, replace
  ``plan_fused_stageb``'s ``fwd_kernel`` / ``inv_kernel``): K1 as two
  launches. ``fwd`` returns ``DFT_N2(A·T)`` in the order the threads
  hold it after the last forward pass (the passes' digit-reversed order:
  position p holds frequency ``spectrum_order(N2)[p]``, see
  :func:`spectrum_order`); ``inv`` takes two spectra in that order and
  returns ``IDFT_N2(Fx·conj Fy)·conj T`` in natural order. The TPU
  kernel's spectrum was in its own ``(k_p, k_q)`` order instead.
* **K3** :func:`fused_corr_acc` (``fused_corr_acc.cu``, replaces
  ``plan_fused_corr_acc``): K1 with the pruned inverse product
  ``wi @ C``, ``(B, rows_out, N2)`` out, in one call of two launches.
* **K4** :func:`fused_corr_full` (``fused_corr_full.cu``, replaces
  ``plan_fused_corr_full``): stage A, K1 and the pruned inverse, from
  the zero-padded windows to ``(B, rows_out, N2)``, in one call of four
  launches.

K1, K3 and K4 share one row chain (``csrc/corr_rows.cuh``: rows in
registers between the exchanges of radix passes, ``csrc/fft_reg.cuh``);
K2 is that chain split at the cross spectrum, on the same passes and the
same row copies (``csrc/row_copy.cuh``).
K3 and K4 write C to a device scratch of the planes' shape and run their
products (K4's stage A, both pruned inverses) on the tensor cores in
split TF32 (``csrc/gemm_tf32.cu``: ``hi·hi + hi·lo + lo·hi`` per
product, float32 accumulation), each output one sum in ascending k: no
partial planes and no float atomics, so two launches on the same inputs
give the same bits. ``passes=1`` keeps ``hi·hi`` alone: one TF32
product, the precision ``'default'`` of :mod:`ops.fft4`. Not carried
from the TPU: ``ROWS = 8``, the VMEM gates and the ``high_block`` /
Karatsuba precision variants; K4's bf16 hi/lo input split becomes the
TF32 split.

K2 is on the four-step's ``stageb='fft'`` branch (:mod:`ops.fft4`,
``StageBPlan``): two forward launches and one inverse per call, one of
each with ``packed``.

N2 must be a power of two no larger than the kernel's own
:data:`MAX_N2`, 16384 for every kernel. Each kernel has a plain
PyTorch version (``*_plain``, float32 throughout): a wrapper takes it for
CPU tensors only, launches the kernel (or raises) for CUDA tensors, on
the tensors' card (made current for the launch: the C side sizes its
grid on the current device, and torch's default stream, handle 0, is
the current device's), and adds one to ``launches[name]`` per
launch. The tests and
``chip_smoke.py`` hold each kernel against its plain version.

Layouts: stage-A planes, spectra and K1's output are ``(B, 2, H, N2)``
float32 with re/im on axis 1; ``T`` is ``(2, H, N2)``; ``wi`` the
``(rows_out, 2H)`` folded inverse matrix (``ops.fft4``); ``w1`` the
``(2H, rows_in)`` stage-A matrix.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["fused_corr", "fused_corr_plain", "stageb_fwd",
           "stageb_fwd_plain", "stageb_inv", "stageb_inv_plain",
           "fused_corr_acc", "fused_corr_acc_plain", "fused_corr_full",
           "fused_corr_full_plain", "check_geometry", "spectrum_order",
           "tf32_round", "MAX_N2", "KERNELS", "launches", "reset_launches"]

#: largest row length per kernel: each block holds a row in registers
#: and a row, the pass twiddles and an exchange buffer in shared memory
#: (210 KB of 227 KB at 16384)
MAX_N2 = {"fused_corr": 16384, "stageb_fwd": 16384, "stageb_inv": 16384,
          "fused_corr_acc": 16384, "fused_corr_full": 16384}

#: kernel names, as ``launches`` counts them
KERNELS = ("fused_corr", "stageb_fwd", "stageb_inv", "fused_corr_acc",
           "fused_corr_full")

#: kernel launches made by the wrappers in this process, by kernel name
launches = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_consts = {}


def reset_launches():
    """Set every launch count to 0."""
    with _lock:
        for k in KERNELS:
            launches[k] = 0


def check_geometry(N2: int, kernel: str):
    """Raise ``ValueError`` unless ``kernel`` (a name of :data:`KERNELS`)
    takes rows of length N2."""
    top = MAX_N2[kernel]
    if N2 < 2 or N2 & (N2 - 1) or N2 > top:
        raise ValueError(
            f"N2={N2}: {kernel} takes a power of two between 2 and {top}")


def _split_floats(M: int, K: int) -> int:
    """Floats of the scratch in which K3 and K4 hold an (M, K) matrix's
    TF32 hi and lo parts (``csrc/gemm_tf32.cuh``: split_floats): two
    (M, K4) planes, K4 = K rounded up to a multiple of 4."""
    return 2 * M * (-(-K // 4) * 4)


def _cached(key, make):
    with _lock:
        v = _consts.get(key)
        if v is None:
            v = _consts[key] = make()
        return v


def spectrum_order(N2: int, device="cpu"):
    """Frequency held at each position of K2's spectrum, so
    ``natural[..., spectrum_order(N2)] == kernel order``. :func:`stageb_fwd`
    stores element k of thread t at position ``k·P + t`` (``P = N2 / E``
    threads of ``E = min(32, N2)`` elements), as the thread holds it
    after the last pass of ``csrc/fft_reg.cuh``: slot ``u·r + bitrev(p)``
    holds output p of butterfly ``u·P + t`` of that pass (radix r, over
    row positions ``(u·P + t)·r + p``), and row position ``Σ p_i·m_i``
    (pass i's output digit p_i < r_i, m_i = L_i / r_i) holds frequency
    ``Σ p_i·32^i``."""
    def make():
        passes = _k1_passes(N2)
        P = N2 // min(32, N2)
        lr = passes[-1][1]
        k, t = np.divmod(np.arange(N2), P)
        slot = k & ((1 << lr) - 1)
        p = np.zeros_like(slot)
        for i in range(lr):
            p |= ((slot >> i) & 1) << (lr - 1 - i)
        pos = ((k >> lr) * P + t) * (1 << lr) + p
        freq = np.zeros_like(pos)
        for i, (ll, lr_i) in enumerate(passes):
            freq += ((pos >> (ll - lr_i)) & ((1 << lr_i) - 1)) << (5 * i)
        return torch.from_numpy(freq).to(device)
    return _cached(("order", N2, str(device)), make)


def _k1_passes(N2: int):
    """``(log2 L_i, log2 r_i)`` of each radix pass of the row transform
    (``csrc/fft_reg.cuh``): radix 32 but for the last pass, which takes
    the rest."""
    lg = N2.bit_length() - 1
    k = -(-lg // 5)
    return [(lg - 5 * i, 5 if i < k - 1 else lg - 5 * (k - 1))
            for i in range(k)]


def _k1_twiddles(N2: int, device):
    """The pass twiddles of the row transforms of K1-K4 in
    ``csrc/fft_reg.cuh``'s layout, computed in
    float64, stored as interleaved float32 (re, im) pairs on ``device``:
    for each pass with ``m = L / r > 1``, ``A[p][c] = W_L^(c·p)`` for
    ``c < a = min(32, m)``, then, when ``nb = m / a > 1``,
    ``B[p][h] = W_L^(a·h·p)`` for ``h < nb``; ``p < r`` throughout."""
    def make():
        parts = [np.zeros(0, complex)]
        for ll, lr in _k1_passes(N2):
            L, r, m = 1 << ll, 1 << lr, 1 << (ll - lr)
            if m == 1:
                continue
            a = min(32, m)
            p = np.arange(r)[:, None]
            cols = [np.arange(a)] + ([a * np.arange(m // a)] if m > a
                                     else [])
            for c in cols:
                parts.append(np.exp(-2j * np.pi * ((p * c) % L) / L)
                             .ravel())
        w = np.concatenate(parts)
        host = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
        return torch.from_numpy(host).to(device)
    return _cached(("k1tw", N2, str(device)), make)


# -- plain versions -----------------------------------------------------

def tf32_round(a):
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the dropped
    13 bits' range added to the magnitude, then those bits cleared."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, passes):
    """``a @ b`` as K3's and K4's product computes it: float32 for three
    TF32 passes (their split recovers float32's accuracy), one TF32
    product of the rounded operands for one pass."""
    if passes == 1:
        return torch.matmul(tf32_round(a), tf32_round(b))
    return torch.matmul(a, b)


def _cplx(a):
    return torch.complex(a[:, 0], a[:, 1])


def _packed(c):
    return torch.stack([c.real, c.imag], dim=1)


def fused_corr_plain(ax, ay, T):
    """:func:`fused_corr` in plain PyTorch (``torch.fft``)."""
    t = torch.complex(T[0], T[1])
    x = _cplx(ax) * t
    y = _cplx(ay) * t
    s = torch.fft.fft(x, dim=-1) * torch.conj(torch.fft.fft(y, dim=-1))
    return _packed(torch.fft.ifft(s, dim=-1) * torch.conj(t))


def stageb_fwd_plain(a, T):
    """:func:`stageb_fwd` in plain PyTorch: ``torch.fft``, then the
    kernel's order (:func:`spectrum_order`)."""
    t = torch.complex(T[0], T[1])
    f = torch.fft.fft(_cplx(a) * t, dim=-1)
    return _packed(f[..., spectrum_order(a.shape[-1], a.device)])


def stageb_inv_plain(fx, fy, T):
    """:func:`stageb_inv` in plain PyTorch: the cross spectrum back to
    natural order, then ``torch.fft`` (a one-window ``fy`` broadcasts)."""
    t = torch.complex(T[0], T[1])
    s = _cplx(fx) * torch.conj(_cplx(fy))
    nat = torch.empty_like(s)
    nat[..., spectrum_order(fx.shape[-1], fx.device)] = s
    return _packed(torch.fft.ifft(nat, dim=-1) * torch.conj(t))


def fused_corr_acc_plain(ax, ay, T, wi, passes=3):
    """:func:`fused_corr_acc` in plain PyTorch: K1's plain version, then
    ``wi @ C`` over the packed axis (:func:`_product`)."""
    B, _, H, N2 = ax.shape
    return _product(wi, fused_corr_plain(ax, ay, T).view(B, 2 * H, N2),
                    passes)


def fused_corr_full_plain(vx, vy, w1, T, wi, passes=3):
    """:func:`fused_corr_full` in plain PyTorch: the stage-A product,
    K1's plain version and the pruned inverse product."""
    B, _, N2 = vx.shape
    H = w1.shape[0] // 2
    ax = _product(w1, vx, passes).view(B, 2, H, N2)
    ay = _product(w1, vy, passes).view(B, 2, H, N2)
    return fused_corr_acc_plain(ax, ay, T, wi, passes)


# -- checks --------------------------------------------------------------

def _check_tensors(ref, **tensors):
    for name, a in tensors.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != ref.device:
            raise ValueError(f"{name} is on {a.device}, not {ref.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_planes(kernel, T, **planes):
    """Packed ``(B, 2, H, N2)`` planes of one shape and their ``T``, in
    ``kernel``'s geometry; returns ``(B, H, N2)``."""
    first = next(iter(planes.values()))
    if first.dim() != 4 or first.shape[1] != 2:
        raise ValueError(
            f"planes must be (B, 2, H, N2), got {tuple(first.shape)}")
    B, _, H, N2 = first.shape
    check_geometry(N2, kernel)
    for name, a in planes.items():
        if a.shape != first.shape:
            raise ValueError(
                f"{name} {tuple(a.shape)} != {tuple(first.shape)}")
    if T.shape != (2, H, N2):
        raise ValueError(f"T must be (2, {H}, {N2}), got {tuple(T.shape)}")
    _check_tensors(first, T=T, **planes)
    return B, H, N2


def _check_wi(wi, H, ref):
    if wi.dim() != 2 or wi.shape[1] != 2 * H or wi.shape[0] < 1:
        raise ValueError(
            f"wi must be (rows_out, {2 * H}), got {tuple(wi.shape)}")
    _check_tensors(ref, wi=wi)
    return wi.shape[0]


def _check_passes(passes):
    if passes not in (1, 3):
        raise ValueError(f"passes={passes!r}: the products take 1 or 3 "
                         "TF32 passes")


def _device_of(a, name):
    """``'cpu'`` or ``'cuda'``; anything else raises."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    return a.device.type


def _launch(name, device, fn, *args, counts=launches):
    """Call a C entry point with ``device`` current (the C side sizes its
    grid on the current device, and the default stream's handle, 0,
    launches there: on another card the kernel would not be ordered with
    the tensors' stream), raise on a CUDA error, count the launch in
    ``counts[name]`` (this module's :data:`launches` by default)."""
    with torch.cuda.device(device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _lock:
        counts[name] += 1


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


# -- wrappers ------------------------------------------------------------

def fused_corr(ax, ay, T):
    """K1: fused stage-B correlation of the packed planes ``ax``, ``ay``
    -> ``(B, 2, H, N2)``."""
    B, H, N2 = _check_planes("fused_corr", T, ax=ax, ay=ay)
    if _device_of(ax, "fused_corr") == "cpu":
        return fused_corr_plain(ax, ay, T)
    from ._build import load
    lib = load()
    out = torch.empty_like(ax)
    tw = _k1_twiddles(N2, ax.device)
    _launch("fused_corr", ax.device, lib.xc_fused_corr,
            *_ptrs(ax, ay, T, tw, out), B, H, N2, N2.bit_length() - 1,
            _stream(ax))
    return out


def stageb_fwd(a, T):
    """K2 forward: ``DFT_N2(a·T)`` per row, ``(B, 2, H, N2)`` in the
    kernel's order (see :func:`spectrum_order`)."""
    B, H, N2 = _check_planes("stageb_fwd", T, a=a)
    if _device_of(a, "stageb_fwd") == "cpu":
        return stageb_fwd_plain(a, T)
    from ._build import load
    lib = load()
    out = torch.empty_like(a)
    tw = _k1_twiddles(N2, a.device)
    _launch("stageb_fwd", a.device, lib.xc_stageb_fwd,
            *_ptrs(a, T, tw, out), B, H, N2, N2.bit_length() - 1,
            _stream(a))
    return out


def stageb_inv(fx, fy, T):
    """K2 inverse: ``IDFT_N2(fx·conj fy)·conj T`` per row of two spectra
    in :func:`stageb_fwd`'s order, ``(B, 2, H, N2)`` in natural order.
    ``fy`` may also hold one window, ``(1, 2, H, N2)``, which every
    window of ``fx`` reads."""
    B, H, N2 = _check_planes("stageb_inv", T, fx=fx)
    if fy.shape != fx.shape and fy.shape != (1, *fx.shape[1:]):
        raise ValueError(f"fy {tuple(fy.shape)} is neither "
                         f"{tuple(fx.shape)} nor one window of it")
    _check_tensors(fx, fy=fy)
    if _device_of(fx, "stageb_inv") == "cpu":
        return stageb_inv_plain(fx, fy, T)
    from ._build import load
    lib = load()
    out = torch.empty_like(fx)
    tw = _k1_twiddles(N2, fx.device)
    _launch("stageb_inv", fx.device, lib.xc_stageb_inv,
            *_ptrs(fx, fy, T, tw, out), B, H, N2, N2.bit_length() - 1,
            int(fy.shape[0] == B), _stream(fx))
    return out


def fused_corr_acc(ax, ay, T, wi, passes=3):
    """K3: ``wi @ fused_corr(ax, ay, T)`` over the packed axis, the row
    chain then the split-TF32 product in ``passes`` (3 or 1) TF32 passes
    -> ``(B, rows_out, N2)``."""
    B, H, N2 = _check_planes("fused_corr_acc", T, ax=ax, ay=ay)
    rows_out = _check_wi(wi, H, ax)
    _check_passes(passes)
    if _device_of(ax, "fused_corr_acc") == "cpu":
        return fused_corr_acc_plain(ax, ay, T, wi, passes)
    from ._build import load
    lib = load()
    kw = dict(dtype=torch.float32, device=ax.device)
    cscr = torch.empty_like(ax)
    split = torch.empty(_split_floats(rows_out, 2 * H), **kw)
    out = torch.empty((B, rows_out, N2), **kw)
    tw = _k1_twiddles(N2, ax.device)
    _launch("fused_corr_acc", ax.device, lib.xc_fused_corr_acc,
            *_ptrs(ax, ay, T, tw, wi, cscr, split, out), B, H, rows_out, N2,
            N2.bit_length() - 1, passes, _stream(ax))
    return out


def fused_corr_full(vx, vy, w1, T, wi, passes=3):
    """K4: the whole four-step correlation of the zero-padded windows
    ``vx``, ``vy`` (``(B, rows_in, N2)``) -> ``(B, rows_out, N2)``, the
    same function as :func:`fused_corr_full_plain`, its products in
    ``passes`` (3 or 1) TF32 passes."""
    if vx.dim() != 3 or vy.shape != vx.shape:
        raise ValueError(
            f"vx and vy must be one (B, rows_in, N2) shape, got "
            f"{tuple(vx.shape)} and {tuple(vy.shape)}")
    B, rows_in, N2 = vx.shape
    check_geometry(N2, "fused_corr_full")
    if w1.dim() != 2 or w1.shape[1] != rows_in or w1.shape[0] % 2:
        raise ValueError(
            f"w1 must be (2H, {rows_in}), got {tuple(w1.shape)}")
    H = w1.shape[0] // 2
    if T.shape != (2, H, N2):
        raise ValueError(f"T must be (2, {H}, {N2}), got {tuple(T.shape)}")
    _check_tensors(vx, vx=vx, vy=vy, w1=w1, T=T)
    rows_out = _check_wi(wi, H, vx)
    _check_passes(passes)
    if _device_of(vx, "fused_corr_full") == "cpu":
        return fused_corr_full_plain(vx, vy, w1, T, wi, passes)
    from ._build import load
    lib = load()
    kw = dict(dtype=torch.float32, device=vx.device)
    sx = torch.empty((B, 2 * H, N2), **kw)  # stage A of x, then C
    sy = torch.empty((B, 2 * H, N2), **kw)
    split = torch.empty(max(_split_floats(2 * H, rows_in),
                            _split_floats(rows_out, 2 * H)), **kw)
    out = torch.empty((B, rows_out, N2), **kw)
    tw = _k1_twiddles(N2, vx.device)
    _launch("fused_corr_full", vx.device, lib.xc_fused_corr_full,
            *_ptrs(vx, vy, w1, T, tw, wi, sx, sy, split, out), B, H,
            rows_in, rows_out, N2, N2.bit_length() - 1, passes, _stream(vx))
    return out
