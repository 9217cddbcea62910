"""What ``precision='default'`` costs in accuracy, emulated on the CPU.

Run from the repository root::

    python3 tools/tf32_emulation.py [--batch 2] [--threads 4]

On the CPU torch ignores the TF32 switch, so this script replaces
``torch.matmul`` with a product that, while
``torch.backends.cuda.matmul.allow_tf32`` is on, first rounds both
float32 operands to TF32 (10 explicit mantissa bits) and then multiplies
in float32: the products that a ``'default'`` plan of
``xcorr_tpu_torch.ops.fft4`` puts into TF32 are the ones that are
rounded, whatever they are. K3's and K4's plain versions already round
their one-pass operands (``ops.fused_fft.tf32_round``). Each operand is
rounded two ways: to nearest, and towards zero (the low 13 bits
dropped), the bounds of what a tensor-core conversion may do.

Inputs are ``chip_smoke.py`` phase 4's kind at day scale (n =
4,320,000, 24 h at 50 Hz, lags 0-9 h): seeded noise ``x`` and its copy
4 s later plus half as much noise, ``--batch`` windows made with numpy.
For every route and branch at ``'default'`` and ``'high'``, prints the
max abs error of the normalized CCFs against a float64 numpy oracle.
The window norms are the port's own (``ops.cc.row_norm``, within 5e-8
of float64 on the CPU at this n), so the figure is the products'.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from xcorr_tpu_torch.ops import fft4  # noqa: E402
from xcorr_tpu_torch.ops.fused_fft import tf32_round  # noqa: E402

FS, HOURS, DELAY = 50.0, 24.0, 4.0
N = int(HOURS * 3600 * FS)
LAGS = (0.0, 9 * 3600.0)
CASES = {"corr": dict(route="corr"), "acc": dict(route="acc"),
         "full": dict(route="full"), "fft": dict(stageb="fft"),
         "matmul": dict(stageb="matmul")}


def truncate(a):
    """``a`` with the 13 low mantissa bits dropped (towards zero)."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate(rounding):
    """Install the emulating ``torch.matmul``; returns the original."""
    matmul = torch.matmul

    def product(a, b):
        if (torch.backends.cuda.matmul.allow_tf32
                and a.dtype == torch.float32 and b.dtype == torch.float32):
            return matmul(rounding(a), rounding(b))
        return matmul(a, b)
    torch.matmul = product
    return matmul


def oracle(x, y, imin, imax):
    x, y = x.astype(np.float64), y.astype(np.float64)
    nfft = 1 << (2 * N - 2).bit_length()
    r = np.fft.irfft(np.fft.rfft(x, nfft) * np.conj(np.fft.rfft(y, nfft)),
                     nfft)
    idx = (np.arange(imin, imax) - (N - 1)) % nfft
    return r[:, idx] / (np.linalg.norm(x, axis=-1)
                        * np.linalg.norm(y, axis=-1))[:, None]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(args.batch, N)).astype(np.float32)
    y = (np.roll(x, -int(DELAY * FS), axis=1)
         + 0.5 * rng.normal(size=x.shape)).astype(np.float32)
    imin = N - 1 + int(LAGS[0] * FS)
    imax = N - 1 + int(LAGS[1] * FS)
    want = oracle(x, y, imin, imax)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for rname, rounding in (("nearest", tf32_round),
                            ("towards zero", truncate)):
        matmul = emulate(rounding)
        try:
            for name, kw in CASES.items():
                errs = []
                for prec in ("high", "default"):
                    plan = fft4.plan_correlate4(N, imin, imax,
                                                precision=prec, **kw)
                    got = plan(xt, yt).double().numpy()
                    errs.append(float(np.abs(got - want).max()))
                print(f"{name:7s} TF32 operands rounded {rname}: 'high' "
                      f"{errs[0]:.3e}, 'default' {errs[1]:.3e} max abs vs "
                      f"f64 ({args.batch} x {N}, lags {LAGS[0]:.0f}-"
                      f"{LAGS[1]:.0f} s)", flush=True)
        finally:
            torch.matmul = matmul


if __name__ == "__main__":
    main()
