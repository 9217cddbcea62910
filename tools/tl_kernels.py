"""The timelapse's cell kernels (TL1 and both routes of TL2,
``xcorr_tpu_torch/csrc/cells.cu``) and one batch of cells by step, on
one CUDA card.

Run from the repository root::

    python3 tools/tl_kernels.py [--T 60] [--F 81] [--L 9100 6993]

For each lag width ``L``, on a seeded stack of ``T`` spectrograms of
``F`` x ``L`` (by default the widest band of a 10,000 km pair, nf x nl =
162 x 18,225, and ``chip_smoke.py``'s 8d widest band, 162 x 14,000) and
its first batch of 64 cells of the upper triangle, prints (median of 20
CUDA-event timings each, in ms):

- TL2's row kernel (``inverse_argmax``, on the column inverses ``Y =
  ifft(P, dim=-2, norm="forward")`` in the layout the form keeps on a
  card, divided by ``nf``) against its plain version (peak error,
  indices that differ), its bound (bytes: the kept rows' half spectra
  read once) and the library yardstick: ``torch.fft.irfft`` of the same
  kept rows (``Y``'s, scaled), without the argmax;
- the scan (``circular_argmax``, on ``irfft2``'s map) with its segments
  per cell as the wrapper picks them, with one segment per cell and
  with twice the wrapper's, each held to its plain version (value bits
  and index) first;
- TL1, within 1e-6 of its plain version's largest magnitude, and
  beside the kernels the bound of each;
- cuFFT's ``irfft2`` whole and in its two halves: ``ifft`` over nf,
  then ``irfft`` over nl; and the row route's ``ifft`` over nf, on the
  products with their columns contiguous, unscaled;
- the batch by step on both routes of ``correlate_spectrograms``'s form
  (the stack's spectra, amortized per batch; TL1; then ``ifft`` and the
  row kernel, or ``irfft2`` and the scan) and on its plain version
  (gather and normalize both operands, two ``rfft2``, product,
  ``irfft2``, the two fftshift slices, ``argmax``), and each whole
  batch.

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


def shape_run(lib, T, F, L):
    """One lag width's measurements (see the module's docstring)."""
    from xcorr_tpu_torch.ops import cells
    from xcorr_tpu_torch.ops.fused_fft import _ptrs, _stream
    from xcorr_tpu_torch.scripts import timelapse as tls
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
    out = {"shape": [T, F, L], "nf": nf, "nl": nl, "cells": B,
           "row_plan": cells.row_plan(nl)._asdict()}

    # the scan route's layout: spectra and products (B, nf, h); the row
    # route's, as correlate_spectrograms keeps them on a card: (B, h, nf)
    S = tls._spectra(sp, 0, T, nf, nl)
    P = cells.gather_product(S, ii, S, jj)
    Sc = tls._spectra(sp, 0, T, nf, nl, cols=True)
    Pc = cells.gather_product(Sc, ii, Sc, jj).transpose(-2, -1)
    Y = torch.fft.ifft(Pc, dim=-2, norm="forward")
    r = torch.fft.irfft2(P, s=(nf, nl))
    rows = (np.arange(2 * F - 1) - (F - 1)) % nf
    kept = (Y[:, torch.from_numpy(rows).cuda()] / nf).contiguous()

    got = cells.inverse_argmax(Y, F, L, nl)
    want = cells.inverse_argmax_plain(Y, F, L, nl)
    torch.cuda.synchronize()
    err = ((got[0] - want[0]).abs().max() / want[0].abs().max()).item()
    if not err <= 1e-6:
        sys.exit(f"row kernel at nl = {nl}: peaks {err} of its plain "
                 "version's")
    out["row_err"] = err
    out["row_index_differs"] = int((got[1] != want[1]).sum())
    out["row_bound_ms"] = (B * (2 * F - 1) * h * 8 + 12 * B) \
        / HBM_BPS * 1e3
    out["row_ms"] = median_ms(
        lambda: cells.inverse_argmax(Y, F, L, nl))
    out["row_plain_ms"] = median_ms(
        lambda: cells.inverse_argmax_plain(Y, F, L, nl))
    out["row_library_ms"] = median_ms(
        lambda: torch.fft.irfft(kept, n=nl, dim=-1))
    out["row_pct_of_bound"] = 100 * out["row_bound_ms"] / out["row_ms"]

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
    out["scan_bound_ms"] = B * (win * 4 + 12) / HBM_BPS * 1e3
    out["scan_ms"] = {f"{s} segments": tl2(s)
                      for s in dict.fromkeys((auto, 1, min(2 * auto,
                                                           2 * F - 1)))}
    out["scan_auto_segments"] = auto
    out["scan_plain_ms"] = median_ms(
        lambda: cells.circular_argmax_plain(r, F, L))

    named = np.union1d(iu[:64], ju[:64]).size
    out["tl1_bound_ms"] = (named * M * 8 + B * M * 8 + 2 * B * 8) \
        / HBM_BPS * 1e3
    ref = cells.gather_product_plain(S, ii, S, jj)
    err = ((P - ref).abs().max() / ref.abs().max()).item()
    if err > 1e-6:
        sys.exit(f"TL1: {err} of its plain version")
    out["tl1_err"] = err
    out["tl1_ms"] = median_ms(lambda: cells.gather_product(S, ii, S, jj))
    out["tl1_plain_ms"] = median_ms(
        lambda: cells.gather_product_plain(S, ii, S, jj))

    half = torch.fft.ifft(P, dim=-2)
    out["irfft2_ms"] = {
        "irfft2": median_ms(lambda: torch.fft.irfft2(P, s=(nf, nl))),
        "ifft over nf": median_ms(lambda: torch.fft.ifft(P, dim=-2)),
        "irfft over nl": median_ms(
            lambda: torch.fft.irfft(half, n=nl, dim=-1)),
        "ifft over nf, columns contiguous, unscaled": median_ms(
            lambda: torch.fft.ifft(Pc, dim=-2, norm="forward")),
    }
    del half
    per_batch = 64 / (T * (T + 1) // 2)
    out["form_steps_ms"] = {
        "row route": {
            "spectra of the stack, per batch": per_batch * median_ms(
                lambda: tls._spectra(sp, 0, T, nf, nl, cols=True), reps=5),
            "TL1": median_ms(
                lambda: cells.gather_product(Sc, ii, Sc, jj)),
            "ifft over nf": out["irfft2_ms"][
                "ifft over nf, columns contiguous, unscaled"],
            "row kernel": out["row_ms"]},
        "scan route": {
            "spectra of the stack, per batch": per_batch * median_ms(
                lambda: tls._spectra(sp, 0, T, nf, nl), reps=5),
            "TL1": out["tl1_ms"],
            "irfft2": out["irfft2_ms"]["irfft2"],
            "scan": median_ms(lambda: cells.circular_argmax(r, F, L))},
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

    def scan_batch():
        q = cells.gather_product(S, ii, S, jj)
        return cells.circular_argmax(torch.fft.irfft2(q, s=(nf, nl)), F, L)
    out["form_batch_ms"] = {
        "as correlate_spectrograms runs it": median_ms(
            lambda: tls._product_peaks(
                [cells.gather_product(Sc, ii, Sc, jj)], F, L, nl, True)),
        "scan route": median_ms(scan_batch)}
    out["plain_batch_ms"] = median_ms(lambda: tls._cell_peaks(sp, ii, jj))
    del S, P, Sc, Pc, Y, r, kept, sp
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=60)
    ap.add_argument("--F", type=int, default=81)
    ap.add_argument("--L", type=int, nargs="+", default=[9100, 6993])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from xcorr_tpu_torch.ops import _build
    lib = _build.load()
    runs = []
    for L in args.L:
        out = shape_run(lib, args.T, args.F, L)
        for k, v in out.items():
            print(f"{k}: {v}", flush=True)
        runs.append(out)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
