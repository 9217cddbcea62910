"""The timelapse's cell kernels (TL1 and TL2, ``xcorr_tpu_torch/csrc/
cells.cu``) and one batch of cells by step, on one CUDA card.

Run from the repository root::

    python3 tools/tl_kernels.py [--T 60] [--F 81] [--L 9100]

On a seeded stack of ``T`` spectrograms of ``F`` x ``L`` (by default
the shape of ``chip_smoke.py``'s 8d widest band: 60 days, 81 bins, the
lag width of a 10,000 km pair) and its first batch of 64 cells of the
upper triangle, prints (median of 20 CUDA-event timings each, in ms):

- TL2 with its segments per cell as the wrapper picks them, with one
  segment per cell (one block per cell) and with twice the wrapper's,
  each held to its plain version (value bits and index) first;
- TL1, within 1e-6 of its plain version's largest magnitude, and
  beside the kernels the bound of each (bytes: TL1 the spectra the
  batch names read once and the products written once; TL2 its windows
  read once);
- the batch by step on the form of ``correlate_spectrograms`` (the
  stack's spectra, amortized per batch; TL1; ``irfft2``; TL2) and on
  its plain version (gather and normalize both operands, two ``rfft2``,
  product, ``irfft2``, the two fftshift slices, ``argmax``).

Prints the card's name and power limit first, and one JSON line last.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

HBM_BPS = 3.35e12


def median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=60)
    ap.add_argument("--F", type=int, default=81)
    ap.add_argument("--L", type=int, default=9100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from xcorr_tpu_torch.ops import _build, cells
    from xcorr_tpu_torch.ops.fused_fft import _ptrs, _stream
    from xcorr_tpu_torch.scripts import timelapse as tls
    lib = _build.load()
    T, F, L = args.T, args.F, args.L
    nf = tls.ops.fft.next_fast_len(2 * F - 1)
    nl = tls.ops.fft.next_fast_len(2 * L - 1)
    h = nl // 2 + 1
    st = np.random.default_rng(20140201).uniform(0.0, 1.0, (T, F, L)) \
        .astype(np.float32)
    sp = torch.from_numpy(st).cuda()
    iu, ju = np.triu_indices(T)
    ii = torch.from_numpy(iu[:64].astype(np.int64)).cuda()
    jj = torch.from_numpy(ju[:64].astype(np.int64)).cuda()
    B, M = ii.numel(), nf * h
    out = {"shape": [T, F, L], "nf": nf, "nl": nl, "cells": B}

    S = tls._spectra(sp, 0, T, nf, nl)
    P = cells.gather_product(S, ii, S, jj)
    r = torch.fft.irfft2(P, s=(nf, nl))
    want = cells.circular_argmax_plain(r, F, L)
    auto = cells._segments(r.device, B, 2 * F - 1)

    def tl2(segs):
        peak = torch.empty(B, dtype=torch.float32, device="cuda")
        k = torch.empty(B, dtype=torch.int64, device="cuda")
        pv = torch.empty(B * segs, dtype=torch.float32, device="cuda")
        pk = torch.empty(B * segs, dtype=torch.int64, device="cuda")

        def run():
            rc = lib.xc_circular_argmax(*_ptrs(r, peak, k, pv, pk), B, nf,
                                        nl, F, L, segs, _stream(r))
            if rc:
                sys.exit(f"TL2 with {segs} segments: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        if not (torch.equal(k, want[1]) and torch.equal(
                peak.view(torch.int32), want[0].view(torch.int32))):
            sys.exit(f"TL2 with {segs} segments differs from its plain "
                     "version")
        return median_ms(run)

    win = (2 * F - 1) * (2 * L - 1)
    out["tl2_bound_ms"] = B * (win * 4 + 12) / HBM_BPS * 1e3
    out["tl2_ms"] = {f"{s} segments": tl2(s)
                     for s in dict.fromkeys((auto, 1, min(2 * auto,
                                                          2 * F - 1)))}
    out["tl2_auto_segments"] = auto
    out["tl2_plain_ms"] = median_ms(
        lambda: cells.circular_argmax_plain(r, F, L))

    named = np.union1d(iu[:64], ju[:64]).size
    out["tl1_bound_ms"] = (named * M * 8 + B * M * 8 + 2 * B * 8) \
        / HBM_BPS * 1e3
    ref = cells.gather_product_plain(S, ii, S, jj)
    got = cells.gather_product(S, ii, S, jj)
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    if err > 1e-6:
        sys.exit(f"TL1: {err} of its plain version")
    out["tl1_err"] = err
    out["tl1_ms"] = median_ms(lambda: cells.gather_product(S, ii, S, jj))
    out["tl1_plain_ms"] = median_ms(
        lambda: cells.gather_product_plain(S, ii, S, jj))

    out["form_steps_ms"] = {
        "spectra of the stack, per batch": median_ms(
            lambda: tls._spectra(sp, 0, T, nf, nl), reps=5) * 64
        / (T * (T + 1) // 2),
        "TL1": median_ms(lambda: cells.gather_product(S, ii, S, jj)),
        "irfft2": median_ms(lambda: torch.fft.irfft2(P, s=(nf, nl))),
        "TL2": median_ms(lambda: cells.circular_argmax(r, F, L)),
    }
    a = tls._normed(sp[ii])
    A = torch.fft.rfft2(a, s=(nf, nl))
    Bf = torch.fft.rfft2(tls._normed(sp[jj]), s=(nf, nl))
    prod = A * torch.conj(Bf)
    out["plain_steps_ms"] = {
        "gather and normalize, two": 2 * median_ms(
            lambda: tls._normed(sp[ii])),
        "rfft2, two": 2 * median_ms(
            lambda: torch.fft.rfft2(a, s=(nf, nl))),
        "product": median_ms(lambda: A * torch.conj(Bf)),
        "irfft2": median_ms(lambda: torch.fft.irfft2(prod, s=(nf, nl))),
        "slices and argmax": median_ms(
            lambda: cells.circular_argmax_plain(r, F, L)),
    }
    out["form_batch_ms"] = median_ms(lambda: tls._product_peaks(
        [cells.gather_product(S, ii, S, jj)], F, L, nf, nl))
    out["plain_batch_ms"] = median_ms(lambda: tls._cell_peaks(sp, ii, jj))
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
