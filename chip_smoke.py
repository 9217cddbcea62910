"""Smoke run of the PyTorch port (``xcorr_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch, CUDA and the TF32 switches;
2. build the hand-written kernels from ``xcorr_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and, beside the build,
   ``nvcc -Xptxas -v`` of K1, K2, K3 and K4 for the registers, shared
   memory and spills of their row chains (K2's forward and inverse) at
   N2 = 8192 and 16384 and of K3's and K4's split-TF32 product
   (``gemm_tf32.cu``); then the count of TF32
   ``HMMA`` instructions in the built library's SASS (``cuobjdump
   -sass``), on its own line;
3. every kernel against its plain PyTorch version, max |diff| / max
   |plain| <= 1e-5 (K2: 1e-6), with CUDA-event times of both (median of
   20 launches after warm-up) and the card's bound for the same work: K1
   at the device engine's launch shape (32, 2, 265, 16384), at the host
   engine pair-day's shape (8, 2, 265, 16384: n1 = 528), at
   (4, 2, 265, 16384), at the n1 = 1056 shape (8, 2, 529, 8192) and at a
   small one; K3 and K4 at the pair-day's shape of their routes (B = 8,
   H = 265, N2 = 16384, rows_in = 264, rows_out = 99, with the n1 = 528
   plan's own w1, T and wi), at the n1 = 1056 one (B = 8, H = 529,
   N2 = 8192, rows_in = 528, rows_out = 198, that plan's constants) and
   at a small one; K2 (forward and inverse) at the pair-day's shape
   (8, 2, 265, 16384), at the n1 = 1056 one and at the small one, each
   with its bound, its share of it and, for context, ``torch.fft.fft``
   over the same complex rows (less work: no twiddle, no planar layout),
   and the inverse of the forward held to ``fused_corr_plain`` (1e-5 of
   its max). Every kernel runs twice on the same inputs and must give
   the same bits. At the two 8-window K1 shapes,
   K1's phase clock (``xc_fused_corr_phases``): SM cycles per row, phase
   by phase;
4. ``ops.cc.correlate`` on 16 synthetic 24 h windows at 50 Hz
   (n = 4,320,000) with the 0-9 h lag window, once per route of the
   four-step path, each chosen as a user chooses it (no variable: K1;
   ``XCORR_FFT4_FUSED_INV=1``: K3; ``XCORR_FFT4_FULL=1``: K4), each in
   its route's default geometry: only the route's kernel launched, 2
   windows within 1e-6 abs of a float64 numpy oracle, the peak on the
   injected delay, ms per window and peak working memory; the K1 route's
   time split into stage-A product, K1, inverse product and lag slice at
   its default n1 = 528 and at n1 = 1056; the K3 route's into stage-A
   product, K3 and lag slice and the K4 route's into K4 and lag slice, at
   n1 = 528; the monolithic cuFFT route beside them;
5. the slice, once per route after a first (cold) run on the K1 route:
   ``init`` -> ``process(device='cuda')`` of one production-geometry
   pair-day from ``SyntheticClient``: every status 1, all 8 CCF peaks on
   the injected delay, the CCFs within 1e-6 abs of the K1 route's, the
   route's kernel launched and no other; wall seconds and device share.
   On the K1 route also ``write`` -> ``read`` where h5py is installed;
6. the device engine (``parallel.engine.device_process_bulk`` +
   ``finalize``) at production width: 4 consecutive pair-days of the EDH
   pair, raw 250 Hz through the production EDH chain of
   ``xcorr_tpu/scripts/cc.py:79-91`` (remove_sensitivity, 3-20 Hz
   bandpass, decimate x5, trim, demean, taper) to 50 Hz, 24 h windows,
   0-9 h lags: one launch of 32 windows, run cold then warm. Every status
   1, every peak on the injected delay, K1 launched once and nothing
   else; wall per pair-day, device share (torch.profiler), host->device
   bytes, peak device memory, the stage timer's report and the device
   time of the 8 costliest kernels. Day 1 again
   through the host engine (``process``): CCFs within 1e-6 abs, equal
   offsets. The BHZ chain's device stages (filters, remove_response with
   a PAZ, Lanczos 40 -> 50 Hz) on two day-scale windows of 40 Hz noise,
   float32 on the card against float64 on the CPU, stage by stage; a
   miniSEED round trip through ``SDSArchive(format="mseed")``. Then one
   BHZ-EDH pair-day, ``IM.H03S1..EDH-IU.RAR.10.BHZ``: the BHZ side raw at
   40 Hz with a PAZ response through the production BHZ chain of
   ``xcorr_tpu/scripts/cc.py:46-60`` (``remove_response`` in float32 on
   the card), through the device engine and the host engine, CCFs within
   1e-6 abs. Then the BHR fallback: one ``device_process_bulk`` call of
   an EDH-EDH pair-day and ``IM.H03S1..EDH-IU.RAR.10.BHR`` (BH1, BH2, BHZ
   raw at 40 Hz through the production BHR chain, whose rotations have
   no device stage): the BHR pair-day on the fallback list, the EDH-EDH
   one on the device engine, then the fallback through
   ``process(device='cuda')``: every status 1, every peak on the
   injected delay (the BHR-EDH one plus the lag between the two
   production chains, measured on noise-free arrivals), wall seconds of
   each;
7. the analysis slice on the card. (a) Full lag width: phase 6's 4
   pair-days (32 windows x 1.62 M lags, float32) through ``postprocess``
   (0-9 h lags, the scripts' 3 Hz highpass, no celerity clip) and ``snr``
   (envelope; signal window at the injected delay, noise at 6-9 h), held
   to the same calls on the CPU (``cc`` within 1e-5 of its peak; ``snr``,
   ``s``, ``n`` within 1e-5 relative; ``lag_s_max`` equal), with card ms
   per pair-day for each stage of the chain. (b) The campaign at the
   production celerity window: the 8 pairs of ``scripts/cc.py`` for 7
   days (56 pair-days) built with ``init`` at the production geometry and
   filled from a seeded generator (noise plus one arrival at
   distance / 1480 m/s, strong on two runs of windows), one day held at a
   time; per pair ``scripts.snr.pair_snr`` (``postprocess(clim=(1460,
   1500))`` + ``snr(envelope=True)``), then ``combine_by_coords`` over the
   days and ``coincidence_trigger``; per triggered period and pair
   ``scripts.psd.pair_psd`` (``postprocess(time_lim=period)`` +
   ``spectrogram(duration=2.5, padding_factor=4)`` to 20 Hz). All held to
   the same run on the CPU (``snr`` 1e-5 relative, periods identical, PSD
   within 1e-5 of its max), with wall per pair-day on the card and on the
   CPU, the device share and the device operations per pair-day, and the
   last day's card wall taken apart: ``postprocess``, ``snr`` and each
   stage of the chain on the clipped lag window. The Z and R pairs of one
   receiver share a distance, and so do the three array pairs, whose
   arrivals carry the delays of a plane wave (250 deg, 1480 m/s) across
   the H03S triad of ``ARRAY_STATIONS``;
8. the rest of the analysis tier on the card, each part held to the same
   calls on the CPU, with card and CPU wall per unit, the device share
   and the device operations per unit (torch.profiler). In 7b's day loop:
   (a) ``scripts.beamform.beamform_datasets`` of the three array pairs
   per day, envelope off and on: ``s_x``, ``s_y``, ``vel``, ``err``
   within 1e-9 relative and ``doa`` within 1e-9 degrees of the CPU's,
   the injected wave within 5 deg and 10% on the event windows;
   (b) ``scripts.plmax.pair_plmax`` of the first day's 8 pair-days with
   the STFT and with the scaleogram: the spectrogram within 1e-5 of its
   max, the peak sets equal but for near-ties, counted; (c)
   ``scripts.swresp.swresp_datasets`` of the two (Z, R) pairs per day:
   ratio and phase within 1e-3 (relative, rad) on the bins where both
   spectra exceed 1e-2 of their max. Then (d) the timelapse of the array
   pairs H10N1-H03S1 and H10N2-H03S2 over 60 days x 4 bands (3-6, 6-9,
   9-12, 12-20 Hz; 2.5 s, padding 4): ``pair_spectrograms`` and
   ``correlate_spectrograms`` of all 14,640 cells on the card, cells/s,
   stack shapes, peak device memory; the CPU makes 12 seeded days'
   spectrograms per pair (within 1e-5 of their max) and 64 seeded cells
   of them per (pair, band) (``cc2`` within 1e-5, shifts equal but for
   near-ties, counted);
9. the multi-device layer on the one card, over a logical mesh that
   names ``cuda:0`` twice (so its times are the split's overhead, not a
   multi-card speed). (a) ``parallel.sharded_correlate`` of phase 4's 16
   day-scale windows once per route: the route's kernel once per entry,
   rows 0, 1 and 8 within 1e-6 abs of float64, the difference from the
   unsharded ``correlate`` (bit-identity reported), ms per window both
   ways with the host gather. (b) Phase 6's 4 pair-days through
   ``device_process_bulk(mesh=)`` inside ``util.profiler.trace``: K1
   once per entry, statuses equal and CCFs within 1e-6 of phase 6's warm
   mesh=None run (bit-identity reported), wall, host->device bytes, peak
   memory, ``device_memory``, and ``parse_device_trace``'s busy seconds
   (> 0, <= wall) and device spans beside the profiler's own device
   time. (c) Two worker processes (``chip_smoke.py --worker RANK PORT
   DIR``, each with a timeout) form a gloo group on a free localhost
   port, each runs its ``host_slice`` of the 4 pair-days through
   ``device_process_bulk`` on cuda:0 and writes its CCFs to an ``.npz``;
   their union is held to phase 6's run (1e-6, bit-identity reported).
   (d) ``correlate_spectrograms(mesh=)`` of one (pair, band) stack of
   8d: peaks within 1e-5 relative of 8d's, shifts equal but for
   near-ties, checked in float64 and counted. Then phase 9's launches,
   each count reset before its run, on a line of their own, and its
   command time.

The line before the last is the kernels' JSON record (K1's launches from
phase 6, the others' from their route's phase-5 pair-day); the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import pandas as pd
import torch

FS = 50.0
WINDOW = 86400.0
N = int(WINDOW * FS)                 # 4,320,000 samples per window
CLIP_LAG = (0.0, 9 * 3600.0)
DELAY = 4.0                          # s, injected on the first receiver
PAIR = "IM.H03S1..EDH-IM.H03S2..EDH"
K_RTOL = 1e-5                        # kernel vs plain: max|diff| / max|plain|
K2_RTOL = 1e-6                       # the same for K2's launches
CCF_ATOL = 1e-6                      # normalized CCF vs float64 oracle
SEED = 20140201
#: the EDH preprocess chain of the production benchmark
EDH = [("detrend", {"type": "demean"}),
       ("filter", {"type": "highpass", "freq": 0.05}),
       ("detrend", {"type": "demean"}),
       ("taper", {"type": "cosine", "max_percentage": 0.05,
                  "max_length": 30.0})]
#: route of the four-step path -> (kernel it launches, environment)
ROUTES = {"corr": ("fused_corr", {}),
          "acc": ("fused_corr_acc", {"XCORR_FFT4_FUSED_INV": "1"}),
          "full": ("fused_corr_full", {"XCORR_FFT4_FULL": "1"})}
ROUTE_VARS = ("XCORR_FFT4_FULL", "XCORR_FFT4_FUSED_INV")
#: one H100 SXM's published peaks: HBM bytes/s, float32 FLOP/s outside
#: the tensor cores, dense TF32 FLOP/s on the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
#: the TPU kernel body each kernel replaces
REPLACES = {
    "fused_corr": "xcorr_tpu/ops/pallas_fft.py:446",
    "stageb_fwd": "xcorr_tpu/ops/pallas_fft.py:407",
    "stageb_inv": "xcorr_tpu/ops/pallas_fft.py:415",
    "fused_corr_acc": "xcorr_tpu/ops/pallas_fft.py:535",
    "fused_corr_full": "xcorr_tpu/ops/pallas_fft.py:684",
}
SOURCES = {
    "fused_corr": "xcorr_tpu_torch/csrc/fused_corr.cu",
    "stageb_fwd": "xcorr_tpu_torch/csrc/stageb.cu",
    "stageb_inv": "xcorr_tpu_torch/csrc/stageb.cu",
    "fused_corr_acc": "xcorr_tpu_torch/csrc/fused_corr_acc.cu",
    "fused_corr_full": "xcorr_tpu_torch/csrc/fused_corr_full.cu",
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(i, msg):
    print(f"[phase {i}] {msg}", flush=True)


def set_route(route):
    """Set the route's environment variables as a user would."""
    for var in ROUTE_VARS:
        os.environ.pop(var, None)
    os.environ.update(ROUTES[route][1])


def median_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn()`` in ms."""
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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_bytes, out_bytes, flops, product_flops=0.0):
    """Least time (ms) of the work on the card, what bounds it, and the
    older float32 form of the bound (ms). The least time is the largest
    of three: each input read once and each output written once at the
    HBM rate; the transforms' float32 operations (``flops``) at the CUDA
    cores' peak; the matrix products' operations (``product_flops``) as
    three TF32 passes at the tensor cores' peak, as accurate as float32
    and counted so whatever implements them. The float32 form puts the
    products at the CUDA cores' peak too."""
    t_bytes = (in_bytes + out_bytes) / HBM_BPS
    t_ops = max(flops / FP32_FLOPS, 3 * product_flops / TF32_FLOPS)
    t_fp32 = max(t_bytes, (flops + product_flops) / FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_fp32 * 1e3)


def stageb_flops(B, H, N2):
    """Operations of K1 over B*H rows: three length-N2 complex FFTs
    (5 N log2 N each) and four complex products per element plus the
    scale."""
    return B * H * (3 * 5 * N2 * math.log2(N2) + 26 * N2)


def kernel_inputs(B, H, N2, rows_in, rows_out, seed, consts=None):
    """Seeded stage-A-like planes, windows and (unless the plan's
    ``(w1, wi, T)`` are given) constants of the right shapes, on the
    card."""
    rng = np.random.default_rng(seed)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    d = {"ax": cu(rng.standard_normal((B, 2, H, N2), np.float32)),
         "ay": cu(rng.standard_normal((B, 2, H, N2), np.float32)),
         "vx": cu(rng.standard_normal((B, rows_in, N2), np.float32)),
         "vy": cu(rng.standard_normal((B, rows_in, N2), np.float32))}
    if consts is None:
        ph = rng.uniform(0.0, 2 * np.pi, size=(H, N2))
        d["T"] = cu(np.stack([np.cos(ph), np.sin(ph)]))
        d["w1"] = cu(rng.standard_normal((2 * H, rows_in)) / rows_in ** .5)
        d["wi"] = cu(rng.standard_normal((rows_out, 2 * H)) / H ** .5)
    else:
        d["w1"], d["wi"], d["T"] = consts
    return d


#: the phases of K1's phase clock (csrc/fused_corr.cu: tick)
K1_PHASES = ("x in", "x*T", "forward x", "y in, half y*T", "half y*T",
             "forward y, cross", "inverse", "conj T, out")


def k1_phase_clock(fn, ff, d, shape):
    """K1's SM cycles per row, phase by phase, from its phase-clock entry
    point ``fn`` (``xc_fused_corr_phases``) on the inputs ``d``."""
    B, _, H, N2 = shape
    out = torch.empty_like(d["ax"])
    tw = ff._k1_twiddles(N2, out.device)
    clock = torch.zeros(B * H * 8, dtype=torch.int64, device="cuda")

    def run():
        rc = fn(d["ax"].data_ptr(), d["ay"].data_ptr(), d["T"].data_ptr(),
                tw.data_ptr(), out.data_ptr(), B, H, N2,
                N2.bit_length() - 1, torch.cuda.current_stream().cuda_stream,
                clock.data_ptr())
        check(rc == 0, f"K1 phase clock launch failed: CUDA error {rc}")

    clock_ms = median_ms(run)  # what the clock costs, beside K1's time
    clock.zero_()
    run()
    torch.cuda.synchronize()
    per_row = clock.view(-1, 8).sum(0).double().cpu().numpy() / (B * H)
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    phase(3, f"fused_corr {shape} phase clock, SM cycles per row: "
             + ", ".join(f"{k} {v:.0f}" for k, v in zip(K1_PHASES, per_row))
             + f"; all {per_row.sum():.0f}; {B * H} rows; SM clock {sm}; "
               f"the clocked kernel takes {clock_ms:.4f} ms")


def hold(ff, name, label, args, rerun=False, rtol=K_RTOL):
    """One kernel against its plain version: error (at most ``rtol`` of
    the plain version's max), times, output; with ``rerun``, a second
    launch on the same inputs must give the same bits."""
    fn, plain = getattr(ff, name), getattr(ff, name + "_plain")
    got = fn(*args)
    if rerun:
        check(torch.equal(got, fn(*args)),
              f"{name} {label}: two launches differ")
    torch.cuda.synchronize()
    want = plain(*args)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    ms = median_ms(lambda: fn(*args))
    plain_ms = median_ms(lambda: plain(*args))
    phase(3, f"{name} {label}: max_abs_err {err:.3e} rel {rel:.3e} "
             f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    check(rel <= rtol, f"{name} {label} rel err {rel} > {rtol}")
    return got, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase3_k2(ff, label, ax, ay, T):
    """K2's two launches against their plain versions at one shape
    (within ``K2_RTOL``, bit-identical reruns), with their bounds and,
    for context, ``torch.fft.fft`` over the same complex rows; the
    inverse of the forward held to ``fused_corr_plain``. Returns each
    launch's record."""
    B, _, Hs, N2s = ax.shape
    fft = 5 * N2s * math.log2(N2s)
    rec = {}
    f, rec["stageb_fwd"] = hold(ff, "stageb_fwd", label, (ax, T),
                                rerun=True, rtol=K2_RTOL)
    g = ff.stageb_fwd(ay, T)
    c, rec["stageb_inv"] = hold(ff, "stageb_inv", label, (f, g, T),
                                rerun=True, rtol=K2_RTOL)
    rows = torch.complex(ax[:, 0], ax[:, 1])
    fft_ms = median_ms(lambda: torch.fft.fft(rows, dim=-1))
    del rows
    for name, in_bytes, ops in [
            ("stageb_fwd", nbytes(ax, T), B * Hs * (fft + 6 * N2s)),
            ("stageb_inv", nbytes(f, g, T), B * Hs * (fft + 14 * N2s))]:
        r = rec[name]
        r["bound_ms"], r["bound_by"], _ = bound(in_bytes, nbytes(ax), ops)
        phase(3, f"{name} {label}: bound {r['bound_ms']:.4f} ms by "
                 f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% "
                 f"of bound), two launches bit-identical; torch.fft.fft "
                 f"over the same {B * Hs} complex rows {fft_ms:.4f} ms")
    want = ff.fused_corr_plain(ax, ay, T)
    err = ((c - want).abs().max() / want.abs().max()).item()
    same = torch.equal(c, ff.fused_corr(ax, ay, T))
    phase(3, f"stageb_inv of stageb_fwd {label}: {err:.3e} of max "
             f"|fused_corr_plain| (bar {K_RTOL}); bit-identical to "
             f"fused_corr: {same}")
    check(err <= K_RTOL, f"K2 {label}: inverse of the forward {err} from "
                         f"fused_corr_plain > {K_RTOL}")
    return rec


def phase3_kernels(ff, plan, plan_1056, clock_fn):
    """Every kernel against its plain version; returns the pair-day
    shape's record per kernel. ``plan`` is the n1 = 528 plan every route
    takes, ``plan_1056`` the n1 = 1056 one (rows of 8192), ``clock_fn``
    K1's phase-clock entry point."""
    rec = {}
    H, N2, rows_in, rows_out = plan.half, plan.N2, plan.rows_in, \
        plan.rows_out
    H8, N28, rows_in8, rows_out8 = plan_1056.half, plan_1056.N2, \
        plan_1056.rows_in, plan_1056.rows_out
    # K1: the device engine's launch (32 windows) first, the record keeps
    # it; then the host engine's pair-day (8 windows)
    for shape in [(32, 2, H, N2), (8, 2, H, N2), (4, 2, H, N2),
                  (8, 2, H8, N28), (2, 2, 24, 256)]:
        d = kernel_inputs(shape[0], shape[2], shape[3], 8, 5, SEED)
        _, r = hold(ff, "fused_corr", shape, (d["ax"], d["ay"], d["T"]),
                    rerun=True)
        B = shape[0]
        r["bound_ms"], r["bound_by"], _ = bound(
            nbytes(d["ax"], d["ay"], d["T"]), nbytes(d["ax"]),
            stageb_flops(B, shape[2], shape[3]))
        phase(3, f"fused_corr {shape}: bound {r['bound_ms']:.4f} ms by "
                 f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% "
                 f"of bound), two launches bit-identical")
        if B == 8:
            k1_phase_clock(clock_fn, ff, d, shape)
        rec.setdefault("fused_corr", r)
        del d
    # K2, K3 and K4 at their pair-day's shape with the plan's constants,
    # then at the n1 = 1056 one and a small one
    for B, Hs, N2s, ri, ro, consts in [
            (8, H, N2, rows_in, rows_out, plan.device_consts("cuda")),
            (8, H8, N28, rows_in8, rows_out8,
             plan_1056.device_consts("cuda")),
            (2, 24, 256, 8, 5, None)]:
        d = kernel_inputs(B, Hs, N2s, ri, ro, SEED, consts)
        label = f"B={B} H={Hs} N2={N2s} rows_in={ri} rows_out={ro}"
        ax, ay, T, w1, wi, vx, vy = (d[k] for k in (
            "ax", "ay", "T", "w1", "wi", "vx", "vy"))
        out_rows = B * ro * N2s * 4
        k1_ops = stageb_flops(B, Hs, N2s)
        inv_ops = 2 * B * ro * 2 * Hs * N2s
        a_ops = 2 * 2 * B * 2 * Hs * ri * N2s
        rec.update({k: v for k, v in phase3_k2(ff, label, ax, ay, T).items()
                    if k not in rec})
        for name, args, in_bytes, ops, prods in [
                ("fused_corr_acc", (ax, ay, T, wi), nbytes(ax, ay, T, wi),
                 k1_ops, inv_ops),
                ("fused_corr_full", (vx, vy, w1, T, wi),
                 nbytes(vx, vy, w1, T, wi), k1_ops, a_ops + inv_ops)]:
            _, r = hold(ff, name, label, args, rerun=True)
            r["bound_ms"], r["bound_by"], fp32 = bound(
                in_bytes, out_rows, ops, prods)
            phase(3, f"{name} {label}: bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}"
                     f"% of bound; float32 form {fp32:.4f} ms, "
                     f"{100 * fp32 / r['ms']:.1f}%), two launches "
                     f"bit-identical")
            rec.setdefault(name, r)
        del d, ax, ay, vx, vy
    for name, r in rec.items():
        phase(3, f"{name} at the pair-day shape: {r['ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
                 f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound)")
    torch.cuda.empty_cache()
    return rec


#: translation units whose ``nvcc -Xptxas -v`` phase 2 reports, by the
#: kernel they hold: the row chain of K1, K3 and K4 (one copy each, from
#: csrc/corr_rows.cuh), K2's two launches and K3's and K4's split-TF32
#: product
PTXAS_UNITS = {"K1": "fused_corr.cu", "K2": "stageb.cu",
               "K3": "fused_corr_acc.cu", "K4": "fused_corr_full.cu",
               "K3/K4 product": "gemm_tf32.cu"}
#: gemm_tf32.cu's dynamic shared memory: two stages of two (hi, lo)
#: 128 x (32 + 4) A tiles and a 32 x (128 + 8) B tile, float32
GEMM_SMEM = 2 * (2 * 128 * 36 + 32 * 136) * 4


def ptxas_entries(report):
    """``{mangled entry: (registers, spill line)}`` from ``nvcc -Xptxas
    -v``."""
    out, name, frame = {}, None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, frame = m.group(1), ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "Used" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[name] = (regs, frame)
            name = None
    return out


def ptxas_summary(unit, report, ff):
    """Lines for one unit: the row chain's instances without the phase
    clock (K2: its forward and its inverse) at N2 = 8192 and 16384
    (registers, spills, the block's dynamic shared memory: a row, pass
    twiddles, exchange buffer), or the product's two instances (B in
    16-byte copies, as at the pair-day's shapes, or in 4-byte ones)."""
    lines = []
    for name, (regs, frame) in sorted(ptxas_entries(report).items()):
        m = re.search(r"(fused_corr|stageb)_kernelILi(\d+)ELb([01])E", name)
        if m and int(m.group(2)) in (13, 14) and (
                m.group(1) == "stageb" or m.group(3) == "0"):
            n = 1 << int(m.group(2))
            what = {"fused_corr": "rows", "stageb": ("fwd", "inv")[
                int(m.group(3))] + " rows"}[m.group(1)]
            smem = 8 * n + 8 * len(ff._k1_twiddles(n, "cpu")) \
                + 4 * (n + n // 32)
            lines.append(f"{what}, N2 = {n}: {regs} registers, {frame}, "
                         f"{smem} bytes of dynamic shared memory")
        m = re.search(r"gemm_tf32_kernelILb([01])E", name)
        if m:
            copies = "16-byte" if m.group(1) == "1" else "4-byte"
            lines.append(f"product, B in {copies} copies: {regs} "
                         f"registers, {frame}, {GEMM_SMEM} bytes of "
                         f"dynamic shared memory")
    check(len(lines) == (4 if unit == "K2" else 2),
          f"ptxas report of {unit}: {lines}")
    return lines


def tf32_hmma(path, nvcc):
    """TF32 ``HMMA`` instructions per function in the SASS of the library
    at ``path`` (``cuobjdump -sass``, beside ``nvcc``), and the distinct
    HMMA forms."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, forms, fn = {}, set(), None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b(HMMA\S*)", ln)
        if m and fn:
            forms.add(m.group(1))
            if "TF32" in m.group(1):
                counts[fn] = counts.get(fn, 0) + 1
    return counts, sorted(forms)


def f64_oracle(x, y, imin, imax):
    """Normalized CCF on the lag window, float64 numpy rfft."""
    n = x.shape[-1]
    nfft = 1 << (2 * n - 2).bit_length()
    r = np.fft.irfft(np.fft.rfft(x, nfft) * np.conj(np.fft.rfft(y, nfft)),
                     nfft)
    idx = (np.arange(imin, imax) - (n - 1)) % nfft
    return r[idx] / (np.linalg.norm(x) * np.linalg.norm(y))


def phase4_correlate(ff, cc, fft4, imin, imax):
    """Day-scale correlate, once per route; the K1 route's split at its
    default geometry and at n1 = 1056. Returns the float64 oracle of the
    first two windows."""
    B = 16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((B, N), generator=gen, device="cuda")
    shift = int(DELAY * FS)
    y = torch.roll(x, -shift, dims=1) + \
        0.5 * torch.randn((B, N), generator=gen, device="cuda")
    xh = x[:2].double().cpu().numpy()
    yh = y[:2].double().cpu().numpy()
    oracle = [f64_oracle(xh[i], yh[i], imin, imax) for i in range(2)]

    def corr():
        return cc.correlate(x, y, index_min=imin, index_max=imax)

    per_window = {}
    for route, (kname, _) in ROUTES.items():
        set_route(route)
        ff.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = corr()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = dict(ff.launches)
        check(counts[kname] == 1 and sum(counts.values()) == 1,
              f"route {route}: correlate launched {counts}, expected "
              f"{kname} once")
        check(tuple(out.shape) == (B, imax - imin), f"shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite CCF")
        oh = out[:2].double().cpu().numpy()
        err = max(float(np.abs(oh[i] - oracle[i]).max()) for i in range(2))
        check(err <= CCF_ATOL, f"route {route}: CCF error {err} > "
                               f"{CCF_ATOL}")
        peak = int(out[0].argmax()) + imin - (N - 1)
        check(peak == shift, f"route {route}: peak at lag {peak} samples, "
                             f"expected {shift}")
        t_all = median_ms(corr, 10)
        per_window[route] = t_all / B
        phase(4, f"route {route} ({kname}): correlate {B} x {N} lags "
                 f"[{imin}, {imax}) ({imax - imin} per row): max abs vs "
                 f"f64 {err:.3e}, peak working memory {peak_gb:.2f} GB, "
                 f"{t_all / B:.4f} ms per window")
        del out

    set_route("corr")
    t_mono = median_ms(lambda: cc.correlate(x, y, index_min=imin,
                                            index_max=imax,
                                            method="monolithic"), 10)
    # the K1 route split at its default geometry, then at n1 = 1056: what
    # the geometry brought apart from what the kernel brought
    for n1 in (None, 1056):
        plan = fft4.plan_correlate4(N, imin, imax, n1=n1, normalize=True,
                                    route="corr")
        w1, wi, t = plan.device_consts(x.device)
        ax, ay = plan.stage_a(x, w1), plan.stage_a(y, w1)
        c = ff.fused_corr(ax, ay, t)
        flat = plan.inverse(c, wi)
        err = max(float(np.abs(_finish(fft4, plan, flat, x, y)[i]
                               - oracle[i]).max()) for i in range(2))
        check(err <= CCF_ATOL, f"route corr n1={plan.N1}: CCF error {err}")
        t_a = median_ms(lambda: (plan.stage_a(x, w1), plan.stage_a(y, w1)),
                        10)
        t_k = median_ms(lambda: ff.fused_corr(ax, ay, t), 10)
        t_i = median_ms(lambda: plan.inverse(c, wi), 10)
        t_s = median_ms(lambda: fft4._finish_ccf(flat, x, y, plan.segs_flat,
                                                 True), 10)
        t_p = median_ms(lambda: plan(x, y), 10)
        phase(4, f"route corr, ms per window (B={B}, N1={plan.N1}, "
                 f"N2={plan.N2}, H={plan.half}, rows_in={plan.rows_in}, "
                 f"rows_out={plan.rows_out}): stage-A {t_a / B:.4f}, K1 "
                 f"{t_k / B:.4f}, inverse {t_i / B:.4f}, lag slice+norm "
                 f"{t_s / B:.4f}; whole plan {t_p / B:.4f}; max abs vs f64 "
                 f"{err:.3e}; monolithic cuFFT {t_mono / B:.4f}")
        del ax, ay, c, flat
    # the K3 and K4 routes split at their default geometry
    plan = fft4.plan_correlate4(N, imin, imax, normalize=True, route="acc")
    w1, wi, t = plan.device_consts(x.device)
    ax, ay = plan.stage_a(x, w1), plan.stage_a(y, w1)
    vx, vy = plan.padded(x), plan.padded(y)
    flat = ff.fused_corr_acc(ax, ay, t, wi).view(B, -1)
    t_a = median_ms(lambda: (plan.stage_a(x, w1), plan.stage_a(y, w1)), 10)
    t_k3 = median_ms(lambda: ff.fused_corr_acc(ax, ay, t, wi), 10)
    t_k4 = median_ms(lambda: ff.fused_corr_full(vx, vy, w1, t, wi), 10)
    t_s = median_ms(lambda: fft4._finish_ccf(flat, x, y, plan.segs_flat,
                                             True), 10)
    phase(4, f"ms per window (B={B}, N1={plan.N1}, N2={plan.N2}, "
             f"H={plan.half}, rows_in={plan.rows_in}, rows_out="
             f"{plan.rows_out}): route acc = stage-A {t_a / B:.4f} + K3 "
             f"{t_k3 / B:.4f} + lag slice+norm {t_s / B:.4f}, correlate "
             f"{per_window['acc']:.4f}; route full = K4 {t_k4 / B:.4f} + "
             f"lag slice+norm {t_s / B:.4f}, correlate "
             f"{per_window['full']:.4f}; route corr correlate "
             f"{per_window['corr']:.4f}")
    del x, y, ax, ay, vx, vy, flat
    torch.cuda.empty_cache()
    return oracle


def _finish(fft4, plan, flat, x, y):
    """The first two windows' normalized CCFs of a split run, float64."""
    return fft4._finish_ccf(flat[:2], x[:2], y[:2], plan.segs_flat,
                            True).double().cpu().numpy()


def phase5_pair_days(xt, ff):
    """One production-geometry pair-day through process per route;
    returns each kernel's launches on its route's path. K2 is on no
    route: every run below checks that it launched no time."""
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
    from torch.profiler import ProfilerActivity, profile
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9),
    ])
    client = SyntheticClient(
        sampling_rate=FS,
        delays={"IM.H03S1..EDH": DELAY, "IM.H03S2..EDH": 0.0},
        source_period=600.0, source_amplitude=20.0)
    launches, ref = dict.fromkeys(ff.KERNELS, 0), None
    # the first pair-day of the process also pays one-time set-up (the
    # profiler's start, first calls into scipy and torch); it runs on
    # the K1 route and is reported apart
    for run, route in enumerate(["corr", *ROUTES]):
        kname = ROUTES[route][0]
        label = f"route {route}" + (" (first, cold)" if run == 0 else "")
        set_route(route)
        ds = xt.init(pair=PAIR, starttime="2014-02-01",
                     endtime="2014-02-02", preprocess={"EDH": EDH},
                     attrs={"institution": "smoke", "author": "smoke",
                            "source": "SyntheticClient"},
                     sampling_rate=FS, window_length=WINDOW,
                     window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                     inventory=inv)
        nwin = ds.dims["time"]
        check(nwin == 8, f"{nwin} windows per pair-day, expected 8")
        ff.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xt.process(ds, client, device="cuda", verb=0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        check(counts[kname] > 0, f"{label}: process never launched {kname}")
        others = {k: v for k, v in counts.items() if k != kname and v}
        check(not others, f"{label}: process also launched {others}")
        launches[kname] = counts[kname]
        status = ds["status"].values
        check(bool((status == 1).all()), f"status {status.tolist()}")
        ccv = ds["cc"].values
        check(bool(np.isfinite(ccv).all()), "non-finite CCF in the dataset")
        lag = ds.coords["lag"].values
        peaks = [float(lag[int(np.argmax(ccv[0, i]))]) for i in range(nwin)]
        check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
              f"{label}: CCF peaks {peaks} s, injected delay {DELAY} s")
        if ref is None:
            ref = ccv
        diff = float(np.abs(ccv - ref).max())
        check(diff <= CCF_ATOL, f"{label}: CCFs differ from the K1 "
                                f"route's by {diff} > {CCF_ATOL}")
        dev = sum(e.self_device_time_total for e in prof.key_averages()) \
            / 1e3
        share = f"{dev / 1e3 / wall:.4f}" if dev > 0 else "not measured"
        phase(5, f"{label}: pair-day {nwin} windows x "
                 f"{ccv.shape[-1]} lags: {wall:.2f} s wall, device "
                 f"{dev:.1f} ms, device share {share}, {kname} launches "
                 f"{counts[kname]}, max |CCF - K1 route| {diff:.3e}, peaks "
                 f"at {sorted(set(peaks))} s")
        if run != 1:
            continue
        if importlib.util.find_spec("h5py") is not None:
            with tempfile.TemporaryDirectory() as tmp:
                path = xt.write(ds, os.path.join(tmp, "shard.nc"), verb=0)
                back = xt.read(path)
                check(back is not None, "read returned None")
                check(np.array_equal(back["cc"].values, ccv),
                      "read != written")
                check(bool((back["status"].values == 1).all()),
                      "read status")
            phase(5, "write -> read round trip equal")
        else:
            phase(5, "write -> read not run: h5py is not installed")
    set_route("corr")
    return launches


#: the production EDH chain of xcorr_tpu/scripts/cc.py:79-91 (the
#: hydrophones' raw 250 Hz -> 50 Hz)
EDH_PROD = [("merge", {"method": 1, "fill_value": "interpolate",
                       "interpolation_samples": 0}),
            ("detrend", {"type": "demean"}),
            ("remove_sensitivity", {}),
            ("filter", {"type": "bandpass", "freqmin": 3., "freqmax": 20.}),
            ("decimate", {"factor": 5}),
            ("trim", {}),
            ("detrend", {"type": "demean"}),
            ("taper", {"type": "cosine", "max_percentage": 0.05,
                       "max_length": 30.})]
#: the device stages of the BHZ chain (xcorr_tpu/scripts/cc.py:46-60),
#: held stage by stage at 40 Hz raw
BHZ_STAGES = [("filter", {"type": "highpass", "freq": .05}),
              ("detrend", {"type": "demean"}),
              ("remove_response", {"output": "VEL"}),
              ("filter", {"type": "highpass", "freq": 3.}),
              ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                               "a": 20}),
              ("filter", {"type": "lowpass", "freq": 20.}),
              ("detrend", {"type": "demean"}),
              ("taper", {"type": "cosine", "max_percentage": 0.05,
                         "max_length": 30.})]
RAW_FS = 250.0
ENGINE_DAYS = 4


def engine_setup(xt):
    """Phase 6's pair-days: ``(inventory, client, days, dataset)``, where
    ``dataset(day)`` is the EDH pair's production-geometry dataset of the
    day, its data 250 Hz raw from the seeded client."""
    from xcorr_tpu_torch.stream import (Channel, Inventory, PAZResponse,
                                        SyntheticClient)
    resp = PAZResponse(sensitivity=1.5e9)
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=resp),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9,
                response=resp)])
    client = SyntheticClient(
        sampling_rate=RAW_FS,
        delays={"IM.H03S1..EDH": DELAY, "IM.H03S2..EDH": 0.0},
        source_period=600.0, source_amplitude=20.0)
    days = [np.datetime64("2014-02-01") + np.timedelta64(i, "D")
            for i in range(ENGINE_DAYS)]

    def dataset(day):
        return xt.init(pair=PAIR, starttime=str(day),
                       endtime=str(day + np.timedelta64(1, "D")),
                       preprocess={"EDH": EDH_PROD},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "SyntheticClient"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)
    return inv, client, days, dataset


def phase6_device_engine(xt, ff):
    """The device engine at production width: 4 consecutive pair-days of
    the EDH pair at 250 Hz raw through ``device_process_bulk`` +
    ``finalize`` (one launch of 32 windows), then day 1 through the host
    engine; the BHZ chain's stages against float64 on the CPU; a miniSEED
    round trip; a BHZ-EDH pair-day on both engines. Returns K1's launches
    on the engine's run, the warm run's 4 datasets and its wall
    seconds."""
    from torch.profiler import ProfilerActivity, profile
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.stream import PAZResponse, Stream
    from xcorr_tpu_torch.stream.compile import compile_operations
    from xcorr_tpu_torch.util.profiler import StageTimer
    inv, client, days, dataset = engine_setup(xt)
    resp = inv.channels[0].response

    k1 = 0
    for run in ("first, cold", "warm"):
        dss = [dataset(d) for d in days]
        nwin = sum(d.dims["time"] for d in dss)
        check(nwin == 32, f"{nwin} windows in {ENGINE_DAYS} pair-days")
        timer = StageTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ff.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            finalize, fallback = device_process_bulk(
                dss, client, inventory=inv, timer=timer, verb=0,
                device="cuda")
            finalize()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        check(not fallback, f"device engine fell back: {fallback}")
        check(counts["fused_corr"] == 1 and sum(counts.values()) == 1,
              f"engine launched {counts}, expected fused_corr once for "
              f"one pack of 32 windows")
        k1, warm_wall = counts["fused_corr"], wall
        for d in dss:
            status = d["status"].values
            check(bool((status == 1).all()), f"status {status.tolist()}")
            ccv = d["cc"].values
            check(bool(np.isfinite(ccv).all()), "non-finite CCF")
            lag = d.coords["lag"].values
            peaks = [float(lag[int(np.argmax(ccv[0, i]))])
                     for i in range(ccv.shape[1])]
            check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
                  f"engine CCF peaks {peaks} s, injected {DELAY} s")
        dev = sum(e.self_device_time_total for e in prof.key_averages()) \
            / 1e3
        share = f"{dev / 1e3 / wall:.4f}" if dev > 0 else "not measured"
        h2d = timer.as_dict()["device-dispatch"].get("GB", 0.0)
        phase(6, f"device engine ({run}): {ENGINE_DAYS} pair-days, {nwin} "
                 f"windows, 250 Hz raw -> 50 Hz, 1 launch of K1: "
                 f"{wall:.2f} s wall, {wall / ENGINE_DAYS:.3f} s per "
                 f"pair-day, device {dev:.1f} ms, device share {share}, "
                 f"host->device {h2d:.3f} GB, peak device memory "
                 f"{peak_gb:.2f} GB above {base / 1e9:.2f}; launches "
                 f"{counts}")
        for line in timer.report().splitlines():
            phase(6, f"  {line.strip()}")
        top = sorted((e for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:8]
        phase(6, "  device time by kernel, ms (calls): " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} "
            f"({e.count})" for e in top))

    # day 1 through the host engine on the card, same client
    host = dataset(days[0])
    t0 = time.perf_counter()
    xt.process(host, client, inventory=inv, device="cuda", verb=0)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    check(bool((host["status"].values == 1).all()), "host engine status")
    diff = float(np.abs(dss[0]["cc"].values - host["cc"].values).max())
    check(diff <= CCF_ATOL, f"device engine vs host engine: {diff} > "
                            f"{CCF_ATOL}")
    for var in ("pair_offset", "time_offset"):
        check(np.array_equal(dss[0][var].values, host[var].values),
              f"{var} differs between the engines")
    phase(6, f"day 1: device engine vs host engine (process, "
             f"{host_wall:.2f} s wall): max |CCF diff| {diff:.3e} "
             f"(bar {CCF_ATOL}), pair_offset and time_offset equal")

    # the BHZ chain's device stages on two day-scale windows of 40 Hz
    # noise, float32 on the card against float64 on the CPU
    fs, n = 40.0, int(round((WINDOW * 1.1) * 40.0))
    paz = PAZResponse(poles=[-0.037 + 0.037j, -0.037 - 0.037j],
                      zeros=[0j, 0j], gain=1.0, sensitivity=2.5e8)
    x = np.random.default_rng(SEED).standard_normal((2, n)) * 1e3
    errs = []
    for op in BHZ_STAGES:
        fn, n_out, fs_out = compile_operations([op], x.shape[-1], fs,
                                               response=paz)
        want = fn(torch.from_numpy(x)).numpy()
        got = fn(torch.from_numpy(x).float().cuda()).cpu().double().numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        errs.append(f"{op[0]}({op[1].get('type', op[1].get('output', ''))}"
                    f" {fs:g} Hz) {rel:.2e}")
        x, fs = want, fs_out
    phase(6, "BHZ chain stage by stage, 2 windows, float32 card vs "
             "float64 CPU, max rel err: " + "; ".join(errs))

    # miniSEED through the SDS archive on this machine
    from xcorr_tpu_torch.stream import Stats, Trace
    from xcorr_tpu_torch.stream.sds import SDSArchive
    rng = np.random.default_rng(SEED)
    tr = Trace(np.round(1e4 * rng.standard_normal(int(86400 * FS)))
               .astype(np.int32),
               Stats(network="IM", station="H03S1", location="",
                     channel="EDH", starttime="2014-02-01T00:00:00",
                     sampling_rate=FS))
    with tempfile.TemporaryDirectory() as tmp:
        archive = SDSArchive(tmp, format="mseed")
        archive.write(Stream([tr]))
        back = archive.read(tr.id, "2014-02-01T12:00:00")
        cov = archive.coverage(tr.id, "2014-02-01T12:00:00")
    check(len(back) == 1 and np.array_equal(back[0].data, tr.data),
          "miniSEED round trip differs")
    check(sum(s[2] for s in cov) == tr.stats.npts, f"coverage {cov[:2]}")
    phase(6, f"miniSEED SDS round trip of {tr.stats.npts} samples equal; "
             f"header scan covers them in {len(cov)} records")
    bhz_pair_day(xt, ff, resp, paz)
    bhr_fallback(xt, ff, resp, paz)
    return k1, dss, warm_wall


BHZ_PAIR = "IM.H03S1..EDH-IU.RAR.10.BHZ"


def bhz_pair_day(xt, ff, edh_resp, paz):
    """One BHZ-EDH pair-day through the device engine and the host engine
    on the card: the EDH side raw at 250 Hz, the BHZ side raw at 40 Hz
    with ``paz`` through the production BHZ chain (``remove_response`` in
    float32 on the card). The synthetic source trains of the two raw rates
    are not aligned, so the CCFs are noise: the check is the two engines'
    agreement."""
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient

    class ClientByChannel(SyntheticClient):
        """SyntheticClient with the BHZ channels raw at 40 Hz."""

        def __init__(self, **kw):
            super().__init__(sampling_rate=RAW_FS, **kw)
            self.bhz = SyntheticClient(sampling_rate=40.0, **kw)

        def _synthesize_day(self, receiver, date):
            if receiver.endswith(".BHZ"):
                return self.bhz._synthesize_day(receiver, date)
            return super()._synthesize_day(receiver, date)

    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=edh_resp),
        Channel("IU", "RAR", "10", "BHZ", latitude=-21.2,
                longitude=-159.8, response=paz)])
    client = ClientByChannel(delays={"IM.H03S1..EDH": DELAY},
                             source_period=600.0, source_amplitude=20.0)
    chains = default_config()[0]["preprocess"]

    def dataset():
        return xt.init(pair=BHZ_PAIR, starttime="2014-02-01",
                       endtime="2014-02-02",
                       preprocess={"EDH": chains["EDH"],
                                   "BHZ": chains["BHZ"]},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "SyntheticClient"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)

    dev = dataset()
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk([dev], client, inventory=inv,
                                             verb=0, device="cuda")
    finalize()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    check(not fallback, f"BHZ-EDH: device engine fell back: {fallback}")
    check(ff.launches["fused_corr"] == 1, f"BHZ-EDH: {ff.launches}")
    host = dataset()
    t0 = time.perf_counter()
    xt.process(host, client, inventory=inv, device="cuda", verb=0)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    for name, d in (("device", dev), ("host", host)):
        check(bool((d["status"].values == 1).all()),
              f"BHZ-EDH {name} engine status {d['status'].values.tolist()}")
        check(bool(np.isfinite(d["cc"].values).all()),
              f"BHZ-EDH {name} engine: non-finite CCF")
    a, b = dev["cc"].values, host["cc"].values
    diff = float(np.abs(a - b).max())
    phase(6, f"BHZ-EDH pair-day {BHZ_PAIR} (BHZ 40 Hz raw, PAZ, the "
             f"production BHZ chain): device engine {dev_wall:.2f} s, host "
             f"engine {host_wall:.2f} s; max |CCF diff| {diff:.3e} (bar "
             f"{CCF_ATOL}), max |CCF| {float(np.abs(b).max()):.3e}, rms "
             f"diff {float(np.sqrt(np.mean((a - b) ** 2))):.3e}")
    check(diff <= CCF_ATOL, f"BHZ-EDH: device engine vs host engine "
                            f"{diff} > {CCF_ATOL}")


BHR_PAIR = "IM.H03S1..EDH-IU.RAR.10.BHR"
#: the back azimuth of the production BHR chain's NE->RT rotation
#: (xcorr_tpu/scripts/cc.py:66)
BHR_BAZ = 250.39


def bhr_fallback(xt, ff, edh_resp, paz):
    """One BHR-EDH pair-day, ``IM.H03S1..EDH-IU.RAR.10.BHR``, through the
    production BHR chain (``xcorr_tpu/scripts/cc.py:61-76``: response
    removed, ``->ZNE`` and ``NE->RT`` rotations, ``select``, filters and
    the Lanczos 40 -> 50 Hz interpolation), in one ``device_process_bulk``
    call with an EDH-EDH pair-day of ``PAIR``. The rotations have no
    device stage, so the BHR pair-day must come back on the fallback list
    while the EDH-EDH one runs on the device engine (K1 once); then the
    fallback runs through ``process(..., device="cuda")`` as the device
    engine's batch driver runs it (``core/lazy.py``: ``_device_bulk_run``).
    The data: every receiver gets its own noise and one source train,
    placed in seconds, so raw rates of 250 Hz (EDH) and 40 Hz (BH1, BH2,
    BHZ) carry the same arrivals; the horizontals carry the source as the
    radial component of ``BHR_BAZ``. The EDH-EDH pair-day peaks at the
    delay injected on ``IM.H03S1..EDH``; the BHR-EDH one at that delay
    plus the lag between the two production chains, which the EDH
    chain's causal anti-alias filter of its decimation (the reference's,
    as in obspy) sets: measured here on the host by running both chains
    on the same arrivals without noise."""
    import zlib
    from xcorr_tpu_torch.parallel.engine import device_process_bulk
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.stream import (Channel, Inventory, Stats, Stream,
                                        SyntheticClient, Trace)
    from xcorr_tpu_torch.stream.process import process as run_chain

    baz = math.radians(BHR_BAZ)
    gain = {"1": -math.cos(baz), "2": -math.sin(baz), "Z": 0.0}

    class ArrivalClient(SyntheticClient):
        """Noise plus a shared Ricker train, rate by channel."""

        def _synthesize_day(self, receiver, date):
            date = pd.Timestamp(date).normalize()
            net, sta, loc, cha = receiver.split(".")
            fs = 40.0 if cha.startswith("BH") else RAW_FS
            day = date.strftime("%Y%j")
            rng = np.random.default_rng(zlib.crc32(f"{receiver}{day}"
                                                   .encode()))
            data = (self.noise_amplitude * rng.standard_normal(
                int(86400 * fs))).astype(np.float32)
            onsets = np.random.default_rng(zlib.crc32(day.encode())) \
                .uniform(60.0, 540.0, 144) + 600.0 * np.arange(144)
            weight = 1.0 if cha == "EDH" else gain[cha[-1]]
            for t0 in onsets + self._delay_of(receiver):
                i = np.arange(int((t0 - 1.0) * fs), int((t0 + 1.0) * fs))
                a = (np.pi * 4.0 * (i / fs - t0)) ** 2
                data[i] += weight * 20.0 * (1 - 2 * a) * np.exp(-a)
            stats = Stats(network=net, station=sta, location=loc,
                          channel=cha, starttime=date, sampling_rate=fs)
            return Stream([Trace(data, stats)])

    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8,
                response=edh_resp),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9,
                response=edh_resp)] + [
        Channel("IU", "RAR", "10", cha, latitude=-21.2, longitude=-159.8,
                response=paz) for cha in ("BHR", "BH1", "BH2", "BHZ")])
    client = ArrivalClient(delays={"IM.H03S1..EDH": DELAY})
    chains = default_config()[0]["preprocess"]

    def dataset(pair):
        return xt.init(pair=pair, starttime="2014-02-01",
                       endtime="2014-02-02",
                       preprocess={k: chains[k] for k in ("EDH", "BHR")},
                       attrs={"institution": "smoke", "author": "smoke",
                              "source": "seeded generator"},
                       sampling_rate=FS, window_length=WINDOW,
                       window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                       inventory=inv)

    def chain_lag(hours=4):
        """Lag (s) of the CCF peak of the EDH and BHR chains' outputs for
        the same noise-free arrivals, the first `hours` of a day."""
        quiet = ArrivalClient(noise_amplitude=0.0)

        def chain(cha, receivers):
            traces = [quiet._synthesize_day(r, "2014-02-01")[0]
                      for r in receivers]
            for tr in traces:
                tr.data = tr.data[:int(hours * 3600
                                       * tr.stats.sampling_rate)]
                tr.stats.npts = tr.data.size
            ops = [o for o in chains[cha] if o[0] not in ("merge", "trim")]
            out = run_chain(Stream(traces), ops, inventory=inv)
            return out.select(channel=cha)[0].data

        a = chain("EDH", ["IM.H03S1..EDH"])
        b = chain("BHR", [f"IU.RAR.10.BH{c}" for c in "12Z"])
        n = min(a.size, b.size)
        c = np.fft.irfft(np.fft.rfft(a[:n], 2 * n)
                         * np.conj(np.fft.rfft(b[:n], 2 * n)))
        k = int(np.argmax(c))
        return (k if k < n else k - 2 * n) / FS

    def held(d, label, want):
        status = d["status"].values
        check(bool((status == 1).all()), f"{label}: status "
                                         f"{status.tolist()}")
        ccv = d["cc"].values
        check(bool(np.isfinite(ccv).all()), f"{label}: non-finite CCF")
        lag = d.coords["lag"].values
        peaks = [float(lag[int(np.argmax(ccv[0, i]))])
                 for i in range(ccv.shape[1])]
        check(all(abs(p - want) < 1.0 / FS + 1e-9 for p in peaks),
              f"{label}: CCF peaks {peaks} s, expected {want} s")
        return sorted(set(peaks))

    edh, bhr = dataset(PAIR), dataset(BHR_PAIR)
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk([edh, bhr], client,
                                             inventory=inv, verb=0,
                                             device="cuda")
    finalize()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    check(len(fallback) == 1 and fallback[0] is bhr,
          f"fallback list {[d.pair.values.tolist() for d in fallback]}, "
          f"expected the BHR pair-day alone")
    counts = dict(ff.launches)
    check(counts["fused_corr"] == 1 and sum(counts.values()) == 1,
          f"EDH-EDH pair-day beside BHR launched {counts}")
    edh_peaks = held(edh, "EDH-EDH beside BHR (device engine)", DELAY)
    check(bool((bhr["status"].values == 0).all()),
          "the device engine touched the BHR pair-day")
    t0 = time.perf_counter()
    xt.process(bhr, client=client, inventory=inv, retry_missing=True,
               verb=0, device="cuda")
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    lag = chain_lag()
    bhr_peaks = held(bhr, "BHR-EDH fallback (host engine)", DELAY + lag)
    phase(6, f"BHR fallback: one device_process_bulk call of {PAIR} and "
             f"{BHR_PAIR} (BH1/BH2/BHZ raw at 40 Hz, PAZ, the production "
             f"BHR chain): {dev_wall:.2f} s, fallback list [{BHR_PAIR}], "
             f"EDH-EDH on the device engine (launches {counts}), status "
             f"1, peaks at {edh_peaks} s; the fallback through process("
             f"device='cuda') {host_wall:.2f} s, status 1 on all "
             f"{bhr.dims['time']} windows, peaks at {bhr_peaks} s "
             f"(injected {DELAY} s, plus {lag:.2f} s between the EDH and "
             f"BHR chains for noise-free arrivals)")


#: the analysis scripts' postprocess filter and celerity window
HIGHPASS = {"frequency": 3.0, "btype": "highpass", "order": 2}
CELERITY = (1460.0, 1500.0)
P7_TOL = 1e-5            # card vs CPU: relative, or of the peak
ANALYSIS_ATTRS = {"institution": "smoke", "author": "smoke",
                  "source": "seeded generator"}


def device_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_ops(prof):
    """(device ms, kernels, copies) of a profiled run."""
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    copies = sum(e.count for e in events if e.key.startswith("Memcpy")
                 or e.key.startswith("Memset"))
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events) - copies, copies)


def timed(fn):
    """``(fn(), wall seconds)``, the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(got, want, peak=False):
    """max |got - want| over max |want| (``peak``), else elementwise
    relative."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if peak:
        return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))
    return float(np.nanmax(np.abs(got - want) / np.abs(want)))


def hold_snr(got, want, label):
    """An SNR dataset on the card against the CPU's; returns the worst
    relative error."""
    err = max(rel_err(got[k].values, want[k].values) for k in
              ("snr", "s", "n"))
    check(err <= P7_TOL, f"{label}: snr/s/n relative error {err}")
    check(np.array_equal(got["lag_s_max"].values, want["lag_s_max"].values),
          f"{label}: lag_s_max differs")
    return err


def stage_ms(cc, delay):
    """``[(stage, ms)]``: the warm wall on the card of each stage of
    postprocess's chain after its selection, each stage fed the previous
    one's output, and of the envelope that ``snr`` takes of the result.
    Each wall holds the stage's host work and its copies."""
    stages = [
        ("unbias", lambda x: x.signal.unbias()),
        ("demean", lambda x: x.signal.demean(device="cuda")),
        ("taper 5 s", lambda x: x.signal.taper(max_length=5.0)),
        ("timeshift", lambda x: x.signal.timeshift(
            delay=delay, dim="lag", fast=True, device="cuda")),
        ("filter", lambda x: x.signal.filter(**HIGHPASS, device="cuda")),
        ("taper 1.5 s", lambda x: x.signal.taper(max_length=1.5)),
        ("hilbert (snr)", lambda x: x.signal.hilbert(device="cuda")),
    ]
    ms = []
    for name, fn in stages:
        y, t = timed(lambda: fn(cc))
        ms.append((name, 1e3 * t))
        if name != "hilbert (snr)":
            cc = y
    return ms


def phase7a_full_width(xt, dss, ndays):
    """``postprocess`` and ``snr`` of phase 6's pair-days at full lag
    width on the card, against the CPU; ms per pair-day by stage."""
    from xcorr_tpu_torch import ndlabel
    from xcorr_tpu_torch.signal import snr
    ds = ndlabel.combine_by_coords(dss)
    shape = ds["cc"].shape
    kw = {"lag_lim": CLIP_LAG, "filter_kwargs": HIGHPASS}

    def run(device):
        post = xt.postprocess(ds, device=device, **kw)
        lag = post.coords["lag"]
        sn = snr(post["cc"], (lag >= DELAY - 1.0) & (lag <= DELAY + 1.0),
                 (lag >= 6 * 3600.0) & (lag <= 9 * 3600.0), dim="lag",
                 extend=True, envelope=True, device=device,
                 **ANALYSIS_ATTRS)
        return post, sn

    (post, sn), card = timed(lambda: run("cuda"))
    (post_c, sn_c), cpu = timed(lambda: run("cpu"))
    want = post_c["cc"].values
    check(post["cc"].shape == want.shape == shape,
          f"postprocessed shape {post['cc'].shape}, {want.shape}, {shape}")
    check(bool(np.isfinite(post["cc"].values).all()), "non-finite cc")
    cc_err = rel_err(post["cc"].values, want, peak=True)
    check(cc_err <= P7_TOL, f"7a: postprocessed cc {cc_err} of the peak")
    snr_err = hold_snr(sn, sn_c, "7a")
    lag_max = np.unique(sn["lag_s_max"].values)
    ms = stage_ms(ds["cc"], -(ds["pair_offset"] + ds["time_offset"]))
    phase(7, f"7a full width, {ndays} pair-days, cc {shape} float32: "
             f"postprocess + snr card {card:.2f} s ({card / ndays:.3f} s "
             f"per pair-day), CPU {cpu:.2f} s ({cpu / ndays:.3f}); card vs "
             f"CPU: cc {cc_err:.2e} of the peak, snr/s/n {snr_err:.2e} "
             f"relative, lag_s_max equal ({lag_max.tolist()} s)")
    phase(7, "7a card ms per pair-day by stage (warm): " + "; ".join(
        f"{name} {t / ndays:.1f}" for name, t in ms))


CAMPAIGN_DAYS = 7
CAMPAIGN_START = pd.Timestamp("2014-03-01")
NOISE = 1e-3
#: (campaign day, first window, last window) of the strong arrivals
EVENTS = [(1, 1, 6), (4, 2, 5)]


def campaign_day(xt, init_args, pairs, dists, offsets, iday, which=None):
    """One day's CCF datasets of the production pairs, one per pair (or
    per index of ``which``): seeded noise plus one 8 Hz Ricker arrival at
    distance / 1480 m/s + the pair's ``offsets`` (s) per window, 40 times
    the noise on the windows of ``EVENTS`` and twice it elsewhere; status
    1, seeded sub-sample time offsets. Each pair-day has its own seed."""
    day = CAMPAIGN_START + pd.Timedelta(days=iday)
    t = (np.arange(50) - 25) / FS
    a = (np.pi * 8.0 * t) ** 2
    wavelet = ((1 - 2 * a) * np.exp(-a)).astype(np.float32)
    out = []
    for ip in range(len(pairs)) if which is None else which:
        rng = np.random.default_rng([SEED, iday, ip])
        ds = xt.init(pair=pairs[ip], starttime=day,
                     endtime=day + pd.Timedelta(days=1), **init_args)
        cc = ds["cc"].values
        rng.standard_normal(out=cc, dtype=np.float32)
        cc *= np.float32(NOISE)
        nt = cc.shape[1]
        amp = np.full(nt, 2 * NOISE, dtype=np.float32)
        for d, i0, i1 in EVENTS:
            if d == iday:
                amp[i0:i1 + 1] = 40 * NOISE
        k = int(np.searchsorted(ds.coords["lag"].values,
                                dists[ip] * 1e3 / 1480.0
                                + offsets[ip])) - 25
        cc[0, :, k:k + wavelet.size] += amp[:, None] * wavelet
        ds["status"].values[...] = 1
        ds["distance"].values[...] = dists[ip]
        ds["time_offset"].values[...] = rng.uniform(-0.01, 0.01, (1, nt))
        out.append(ds)
    return out


def campaign_split(xt, dss, pair_snr):
    """One campaign day on the card taken apart, ms per pair-day:
    ``pair_snr``; the ``postprocess`` it starts with; ``pair_snr`` of the
    postprocessed dataset, which postprocess hands back as it is, so the
    SNR alone; each stage of :func:`stage_ms` on the lag window that
    postprocess clips."""
    def run(d):
        return pair_snr(d, celerity=CELERITY, filter_kwargs=HIGHPASS,
                        attrs=ANALYSIS_ATTRS, device="cuda")

    split = {"pair_snr": 0.0, "postprocess": 0.0, "snr": 0.0}
    for d in dss:
        split["pair_snr"] += 1e3 * timed(lambda: run(d))[1]
        post, t = timed(lambda: xt.postprocess(
            d, clim=CELERITY, filter_kwargs=HIGHPASS, device="cuda"))
        split["postprocess"] += 1e3 * t
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "already postprocessed"
            split["snr"] += 1e3 * timed(lambda: run(post))[1]
        lag, kept = d.coords["lag"], post.coords["lag"].values
        clipped = d["cc"].where((lag >= kept[0]) & (lag <= kept[-1]),
                                drop=True)
        check(clipped.shape == post["cc"].shape,
              f"7b split: clipped {clipped.shape}, {post['cc'].shape}")
        for name, ms in stage_ms(clipped,
                                 -(d["pair_offset"] + d["time_offset"])):
            split[name] = split.get(name, 0.0) + ms
    return {k: v / len(dss) for k, v in split.items()}


def campaign_geometry(pairs, inv):
    """Seeded pair distances (km) and arrival offsets (s) of the campaign:
    the Z and R pairs of one receiver share a distance, and so do the
    three array pairs, whose arrivals carry the delays of the plane wave
    ``WAVE_AZ``, ``WAVE_VEL`` across their H03S receivers, in the local
    coordinates that ``beamform_datasets`` builds."""
    from xcorr_tpu_torch.util.receiver import (get_pair_xy_coordinates,
                                               split_pair)
    dists = np.random.default_rng(SEED).uniform(5000.0, 10000.0, len(pairs))
    for iz, ir in SWRESP_PAIRS:
        dists[ir] = dists[iz]
    dists[ARRAY_PAIRS] = dists[ARRAY_PAIRS[0]]
    array = [pairs[i] for i in ARRAY_PAIRS]
    receivers, x, y = get_pair_xy_coordinates(array, inv, km=False)
    k = [receivers.index(split_pair(pair)[1]) for pair in array]
    az = np.radians(WAVE_AZ)
    offsets = np.zeros(len(pairs))
    offsets[ARRAY_PAIRS] = ((x[k] - x[k].mean()) * np.sin(az)
                            + (y[k] - y[k].mean()) * np.cos(az)) / WAVE_VEL
    return dists, offsets


def array_inventory():
    from xcorr_tpu_torch.stream import Channel, Inventory
    return Inventory([Channel(*sid.split("."), latitude=lat, longitude=lon)
                      for sid, (lat, lon) in ARRAY_STATIONS.items()])


def phase7b_campaign(xt, p8):
    """The SNR -> trigger -> PSD path over the campaign days of the 8
    production pairs at the production celerity window, card against
    CPU; on the same days, phase 8's beamform (8a), plmax (8b, first day)
    and swresp (8c), accumulated in ``p8``."""
    from xcorr_tpu_torch import ndlabel
    from xcorr_tpu_torch.scripts.cc import default_config
    from xcorr_tpu_torch.scripts.psd import pair_psd
    from xcorr_tpu_torch.scripts.snr import pair_snr
    from xcorr_tpu_torch.signal import coincidence_trigger, trigger_periods
    init_args, _, pairs, _ = default_config()
    inv = array_inventory()
    dists, offsets = campaign_geometry(pairs, inv)
    p8.update(init_args=init_args, pairs=pairs, dists=dists,
              offsets=offsets, inv=inv)

    def snr_day(dss, device):
        out = [pair_snr(d, celerity=CELERITY, filter_kwargs=HIGHPASS,
                        attrs=ANALYSIS_ATTRS, device=device) for d in dss]
        check(all(o is not None for o in out), f"{device}: a pair had no "
                                               f"data after postprocess")
        return ndlabel.concat(out, "pair")

    days = {"cuda": [], "cpu": []}
    wall = {"cuda": 0.0, "cpu": 0.0}
    dev_ms, kernels, copies, err, first = 0.0, 0, 0, 0.0, None
    for iday in range(CAMPAIGN_DAYS):
        dss = campaign_day(xt, init_args, pairs, dists, offsets, iday)
        with device_profile() as prof:
            card, t = timed(lambda: snr_day(dss, "cuda"))
        wall["cuda"] += t
        first = t if first is None else first
        ms, k, c = device_ops(prof)
        dev_ms, kernels, copies = dev_ms + ms, kernels + k, copies + c
        cpu, t = timed(lambda: snr_day(dss, "cpu"))
        wall["cpu"] += t
        err = max(err, hold_snr(card, cpu, f"7b day {iday}"))
        days["cuda"].append(card)
        days["cpu"].append(cpu)
        if iday == CAMPAIGN_DAYS - 1:
            split = campaign_split(xt, dss, pair_snr)
        t8 = time.perf_counter()
        phase8a_beamform(dss, iday, p8)
        if iday == 0:
            phase8b_plmax(xt, dss, p8)
        phase8c_swresp(xt, dss, p8)
        p8["seconds"] += time.perf_counter() - t8
        del dss
    npd = CAMPAIGN_DAYS * len(pairs)
    share = f"{dev_ms / 1e3 / wall['cuda']:.4f}" if dev_ms > 0 \
        else "not measured"
    phase(7, f"7b snr, {len(pairs)} pairs x {CAMPAIGN_DAYS} days = {npd} "
             f"pair-days at clim {CELERITY}: card {wall['cuda']:.2f} s "
             f"({1e3 * wall['cuda'] / npd:.1f} ms per pair-day; first day "
             f"{first:.2f} s, profiled), CPU {wall['cpu']:.2f} s "
             f"({1e3 * wall['cpu'] / npd:.1f} ms per pair-day); device "
             f"{dev_ms:.1f} ms, share {share}; device operations per "
             f"pair-day {(kernels + copies) / npd:.1f} (kernels "
             f"{kernels / npd:.1f}, copies {copies / npd:.1f}); card vs "
             f"CPU snr/s/n {err:.2e} relative, lag_s_max equal")
    whole = ("pair_snr", "postprocess", "snr")
    stages = {k: v for k, v in split.items() if k not in whole}
    chain = sum(v for k, v in stages.items() if k != "hilbert (snr)")
    phase(7, f"7b day {CAMPAIGN_DAYS} taken apart on the card (warm, "
             f"unprofiled), ms per pair-day: pair_snr "
             f"{split['pair_snr']:.1f}; its postprocess "
             f"{split['postprocess']:.1f} and snr {split['snr']:.1f}; "
             f"postprocess's selection and lag clip (by difference) "
             f"{split['postprocess'] - chain:.1f}; on the clipped window "
             + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))

    periods = {}
    for device in ("cuda", "cpu"):
        snr_all = ndlabel.combine_by_coords(days[device])
        ct = coincidence_trigger(snr_all["snr"], thr_on=10.0, dim="time")
        periods[device] = (trigger_periods(ct) if ct.attrs["nperiods"]
                           else None, snr_all)
    want = periods["cpu"][0]
    check(want is not None and len(want) == len(EVENTS),
          f"7b: {0 if want is None else len(want)} triggered periods on the "
          f"CPU, {len(EVENTS)} designed")
    check(periods["cuda"][0] is not None
          and periods["cuda"][0].equals(want),
          f"7b: trigger periods differ: {periods['cuda'][0]} vs {want}")

    wall = {"cuda": 0.0, "cpu": 0.0}
    err, npsd, shape = 0.0, 0, None
    for _, row in want.iterrows():
        start, end = row["start"], row["end"]
        check(start.normalize() == end.normalize(),
              f"7b: period {start} - {end} spans days")
        dss = campaign_day(xt, init_args, pairs, dists, offsets,
                           (start.normalize() - CAMPAIGN_START).days)
        for ip, pair in enumerate(pairs):
            out = {}
            for device in ("cuda", "cpu"):
                out[device], t = timed(lambda: pair_psd(
                    dss[ip], pair, start, end, clim=CELERITY,
                    duration=2.5, padding_factor=4, filter_kwargs=HIGHPASS,
                    snr=periods[device][1]["snr"], fmax=20.0,
                    device=device))
                wall[device] += t
            check(out["cuda"] is not None and out["cpu"] is not None,
                  f"7b: no PSD for {pair}")
            g, w = out["cuda"]["psd"].values, out["cpu"]["psd"].values
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"7b: PSD {g.shape} vs {w.shape}")
            err = max(err, rel_err(g, w, peak=True))
            npsd, shape = npsd + 1, g.shape
        del dss
    check(err <= P7_TOL, f"7b: PSD {err} of its max")
    spans = "; ".join(f"{r.start} - {r.end}" for r in want.itertuples())
    phase(7, f"7b psd: {len(want)} triggered periods ({spans}) "
             f"identical on card and CPU; {npsd} (pair, period) "
             f"spectrograms (last {shape}): card {wall['cuda']:.2f} s, CPU "
             f"{wall['cpu']:.2f} s; card vs CPU PSD {err:.2e} of its max")


#: the six stations of the production array pairs
#: (``xcorr_tpu/scripts/cc.py:111-113``), latitude and longitude: the IMS
#: hydrophone triads H10N, north of Ascension Island, and H03S, south of
#: the Juan Fernandez Islands, placed to about 100 m
ARRAY_STATIONS = {
    "IM.H10N1..EDH": (-7.8445, -14.4690),
    "IM.H10N2..EDH": (-7.8590, -14.4980),
    "IM.H10N3..EDH": (-7.8350, -14.4950),
    "IM.H03S1..EDH": (-33.8220, -78.8130),
    "IM.H03S2..EDH": (-33.8390, -78.8340),
    "IM.H03S3..EDH": (-33.8120, -78.8360),
}
#: indices in ``default_config``'s pairs: the array pairs
#: IM.H10N{1,2,3}..EDH-IM.H03S{1,2,3}..EDH; the (Z, R) pairs of RAR with
#: H10N1 and with H03S1; the timelapse pairs H10N1-H03S1, H10N2-H03S2
ARRAY_PAIRS = [4, 5, 6]
SWRESP_PAIRS = [(0, 1), (2, 3)]
TL_PAIRS = (4, 5)
#: the plane wave across the H03S triad that 8a recovers: propagation
#: azimuth (degrees from north) and horizontal velocity (m/s)
WAVE_AZ, WAVE_VEL = 250.0, 1480.0
#: swresp's ratio and phase are held on bins where |Y_Z| and |Y_R| both
#: exceed this share of their window's max, at P7_TOL / SW_LEVEL: a
#: float32 spectrum within P7_TOL of its max is that much off there
SW_LEVEL = 1e-2
#: 8d at the size of VERDICT r5's ask: 60 consecutive days, 4 bands
TL_DAYS = 60
TL_BANDS = ((3.0, 6.0), (6.0, 9.0), (9.0, 12.0), (12.0, 20.0))
TL_SAMPLE_TIMES, TL_SAMPLE_CELLS = 12, 64
BF_TOL = 1e-9            # beamform card vs CPU: relative, degrees for doa


def new_phase8():
    """Phase 8's accumulators, filled by 7b's day loop and 8d."""
    return {"seconds": 0.0, "bf": {}, "plm": {}, "sw": {}}


def tally(acc, key, card, cpu, prof, units):
    """Add one profiled card run's wall, device ms and operations, and
    its CPU twin's wall, to ``acc[key]``."""
    ms, k, c = device_ops(prof)
    r = acc.setdefault(key, {"card": 0.0, "cpu": 0.0, "dev_ms": 0.0,
                             "ops": 0, "units": 0, "err": 0.0})
    r["card"] += card
    r["cpu"] += cpu
    r["dev_ms"] += ms
    r["ops"] += k + c
    r["units"] += units
    return r


def tally_line(label, r, unit):
    share = f"{r['dev_ms'] / 1e3 / r['card']:.4f}" if r["dev_ms"] > 0 \
        else "not measured"
    n = r["units"]
    return (f"{label}: card {1e3 * r['card'] / n:.1f} ms per {unit}, CPU "
            f"{1e3 * r['cpu'] / n:.1f} ms per {unit} ({n} {unit}s); device "
            f"{r['dev_ms']:.1f} ms, share {share}, device operations per "
            f"{unit} {r['ops'] / n:.1f}")


def hold_close(got, want, tol, label, angle=False):
    """``got`` against ``want`` elementwise: relative (absolute for an
    ``angle`` in degrees, modulo 360), equal where not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    check(np.array_equal(fin, np.isfinite(got))
          and np.array_equal(got[~fin], want[~fin]),
          f"{label}: non-finite entries differ")
    if angle:
        d = np.abs((got[fin] - want[fin] + 180.0) % 360.0 - 180.0)
    else:
        d = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                      1e-300)
    err = float(d.max()) if d.size else 0.0
    check(err <= tol, f"{label}: {err} > {tol}")
    return err


def phase8a_beamform(dss, iday, p8):
    """``beamform_datasets`` of one campaign day's three array pairs,
    envelope off and on, card against CPU; on the ``EVENTS`` windows the
    injected plane wave must come back."""
    from xcorr_tpu_torch.scripts.beamform import beamform_datasets
    arr = [dss[i] for i in ARRAY_PAIRS]
    for envelope in (False, True):
        kw = dict(clim=CELERITY, envelope=envelope, attrs=ANALYSIS_ATTRS,
                  filter_kwargs=HIGHPASS)
        with device_profile() as prof:
            card, t = timed(lambda: beamform_datasets(
                arr, p8["inv"], device="cuda", **kw))
        cpu, tc = timed(lambda: beamform_datasets(
            arr, p8["inv"], device="cpu", **kw))
        check(card is not None and cpu is not None, "8a: no estimate")
        r = tally(p8["bf"], envelope, t, tc, prof, 1)
        same = all(np.array_equal(card[v].values, cpu[v].values)
                   for v in ("s_x", "s_y", "doa", "vel", "err"))
        r["identical"] = r.get("identical", 0) + same
        for v in ("s_x", "s_y", "vel", "err"):
            r["err"] = max(r["err"], hold_close(
                card[v].values, cpu[v].values, BF_TOL, f"8a {v}"))
        r["err"] = max(r["err"], hold_close(
            card["doa"].values, cpu["doa"].values, BF_TOL, "8a doa", True))
        for d, i0, i1 in EVENTS:
            if d != iday:
                continue
            doa = card["doa"].values[i0:i1 + 1]
            vel = card["vel"].values[i0:i1 + 1]
            want = (WAVE_AZ + 180.0) % 360.0
            ddoa = float(np.abs((doa - want + 180.0) % 360.0 - 180.0).max())
            dvel = float(np.abs(vel / WAVE_VEL - 1.0).max())
            check(ddoa < 5.0 and dvel < 0.1,
                  f"8a day {iday}: event windows doa {doa}, vel {vel}; "
                  f"injected {want} deg, {WAVE_VEL} m/s")
            r["wave"] = max(r.get("wave", (0.0, 0.0)), (ddoa, dvel))


def tie_count(diff, w, err_abs, md):
    """How many of the peaks ``diff`` (index tuples present in one
    device's mask only) are near-ties in ``w``: the peak and the largest
    other value of its (2·md+1)² window differ by at most 2·err_abs. Any
    other difference fails."""
    for p in diff:
        lead, (i, j) = p[:-2], p[-2:]
        win = w[lead][max(0, i - md):i + md + 1,
                      max(0, j - md):j + md + 1].copy()
        win[min(i, md), min(j, md)] = -np.inf
        gap = abs(float(w[p]) - float(win.max()))
        check(gap <= 2 * err_abs, f"8b: peak {p} differs between card and "
                                  f"CPU by more than a tie ({gap})")
    return len(diff)


def phase8b_plmax(xt, dss, p8):
    """``pair_plmax`` of one campaign day's 8 pair-days, with the STFT and
    with the scaleogram, card against CPU: the spectrogram within P7_TOL
    of its max, the peak sets equal but for near-ties."""
    from xcorr_tpu_torch.scripts.plmax import pair_plmax
    from xcorr_tpu_torch.signal import scaleogram, spectrogram
    md = 25
    for wavelet in (False, True):
        kw = dict(clim=CELERITY, min_distance=md, wavelet=wavelet,
                  duration=2.5, padding_factor=4, filter_kwargs=HIGHPASS)
        ties = npeaks = 0
        for d in dss:
            with device_profile() as prof:
                dfc, t = timed(lambda: pair_plmax(d, device="cuda", **kw))
            dfp, tc = timed(lambda: pair_plmax(d, device="cpu", **kw))
            r = tally(p8["plm"], wavelet, t, tc, prof, 1)
            check(dfc is not None and dfp is not None, "8b: no peaks")
            psd = {}
            for dev in ("cuda", "cpu"):
                cc = xt.postprocess(d, clim=CELERITY, filter_kwargs=HIGHPASS,
                                    device=dev)["cc"]
                psd[dev] = (scaleogram(cc, dim="lag", device=dev) if wavelet
                            else spectrogram(cc, duration=2.5,
                                             padding_factor=4, device=dev))
            g, w = psd["cuda"].values, psd["cpu"].values
            err = rel_err(g, w, peak=True)
            check(err <= P7_TOL, f"8b: psd {err} of its max")
            r["err"] = max(r["err"], err)
            dims = psd["cpu"].dims

            def index(df):
                cols = [np.searchsorted(psd["cpu"].coords[k].values,
                                        df[k].values) for k in dims]
                return set(zip(*cols))
            diff = index(dfc) ^ index(dfp)
            ties += tie_count(diff, w, float(np.abs(g - w).max()), md)
            npeaks += len(dfp)
            r["shape"] = g.shape
        r["ties"] = r.get("ties", 0) + ties
        r["peaks"] = r.get("peaks", 0) + npeaks


def phase8c_swresp(xt, dss, p8):
    """``swresp_datasets`` of one campaign day's two (Z, R) pairs, card
    against CPU, on the bins where both spectra are above SW_LEVEL of
    their max; the errors on the bins where |Y_Z| > 1e-3 of its max are
    printed, not held."""
    from xcorr_tpu_torch.scripts.swresp import swresp_datasets
    kw = dict(clim=CELERITY, attrs=ANALYSIS_ATTRS, filter_kwargs=HIGHPASS)
    for iz, ir in SWRESP_PAIRS:
        with device_profile() as prof:
            card, t = timed(lambda: swresp_datasets(dss[iz], dss[ir],
                                                    device="cuda", **kw))
        cpu, tc = timed(lambda: swresp_datasets(dss[iz], dss[ir],
                                                device="cpu", **kw))
        r = tally(p8["sw"], "swresp", t, tc, prof, 1)
        check(card is not None and cpu is not None, "8c: no response")
        nt, nf = cpu["ratio"].shape
        mags = []
        for i in (iz, ir):
            cc = xt.postprocess(dss[i], clim=CELERITY, filter_kwargs=HIGHPASS,
                                device="cpu")["cc"].values[0, :nt]
            Y = np.abs(np.fft.rfft(cc[:, :2 * (nf - 1)], axis=-1))
            mags.append(Y / Y.max(axis=-1, keepdims=True))
        keep = (mags[0] > SW_LEVEL) & (mags[1] > SW_LEVEL)
        loose = mags[0] > 1e-3
        g, w = card["ratio"].values, cpu["ratio"].values
        with np.errstate(divide="ignore", invalid="ignore"):
            dr = np.abs(g - w) / np.abs(w)
        dp = np.abs(np.angle(np.exp(1j * (card["phase"].values
                                          - cpu["phase"].values))))
        bar = P7_TOL / SW_LEVEL
        check(dr[keep].max() <= bar and dp[keep].max() <= bar,
              f"8c: ratio {dr[keep].max()}, phase {dp[keep].max()} rad on "
              f"the held bins, bar {bar}")
        r["err"] = max(r["err"], float(dr[keep].max()))
        r["phase"] = max(r.get("phase", 0.0), float(dp[keep].max()))
        r["loose"] = max(r.get("loose", (0.0, 0.0)),
                         (float(np.nanmax(dr[loose])),
                          float(dp[loose].max())))
        r["held"] = r.get("held", 0) + int(keep.sum())
        r["bins"] = r.get("bins", 0) + keep.size


def phase8_report(p8):
    for env, r in sorted(p8["bf"].items()):
        phase(8, tally_line(f"8a beamform, envelope {env}", r, "array-day")
              + f"; card vs CPU {r['err']:.2e} (bar {BF_TOL}), "
              f"bit-identical on {r['identical']} of {r['units']} "
              f"array-days; event windows: doa within {r['wave'][0]:.2f} "
              f"deg of {(WAVE_AZ + 180.0) % 360.0:g}, vel within "
              f"{100 * r['wave'][1]:.2f}% of {WAVE_VEL:g} m/s")
    for wavelet, r in sorted(p8["plm"].items()):
        name = "scaleogram" if wavelet else "STFT"
        phase(8, tally_line(f"8b plmax ({name}, {r['shape']} per "
                            f"pair-day)", r, "pair-day")
              + f"; card vs CPU psd {r['err']:.2e} of its max; "
              f"{r['peaks']} peaks, {r['ties']} differ as near-ties")
    r = p8["sw"]["swresp"]
    phase(8, tally_line("8c swresp", r, "pair-day")
          + f"; card vs CPU on {r['held']} of {r['bins']} bins: ratio "
          f"{r['err']:.2e} relative, phase {r['phase']:.2e} rad (bar "
          f"{P7_TOL / SW_LEVEL:g}); where |Y_Z| > 1e-3 of its max: ratio "
          f"{r['loose'][0]:.2e}, phase {r['loose'][1]:.2e} rad")


def shift_value(a, b, df, dl):
    """The normalized 2-D correlation of spectrograms ``a`` and ``b`` at
    the shift (``df``, ``dl``), in float64 on the host:
    sum of a[f + df, l + dl] * b[f, l] over the overlap, as
    ``correlate_spectrograms`` defines its peak and shifts."""
    a = a / np.linalg.norm(a.astype(np.float64))
    b = b / np.linalg.norm(b.astype(np.float64))
    F, L = a.shape
    return float(np.sum(
        a[max(df, 0):F + min(df, 0), max(dl, 0):L + min(dl, 0)]
        * b[max(-df, 0):F + min(-df, 0), max(-dl, 0):L + min(-dl, 0)],
        dtype=np.float64))


def phase8d_timelapse(xt, p8):
    """The timelapse of two array pairs over TL_DAYS days and TL_BANDS:
    the spectrogram cache and every cell on the card; on the CPU the
    spectrograms of TL_SAMPLE_TIMES seeded times and a seeded sample of
    TL_SAMPLE_CELLS of their cells per (pair, band), held to the card:
    equal shifts but for near-ties, where the float64 correlation of the
    CPU's spectrograms at the card's shift and at the CPU's differ by at
    most 2 P7_TOL; counted."""
    from xcorr_tpu_torch.scripts.timelapse import (correlate_spectrograms,
                                                   pair_spectrograms)
    times = pd.date_range(CAMPAIGN_START, periods=TL_DAYS, freq="1D")
    iu, ju = np.triu_indices(TL_DAYS)
    cell_of = {(a, b): k for k, (a, b) in enumerate(zip(iu, ju))}
    rng = np.random.default_rng([SEED, 8])
    kw = dict(clim=CELERITY, duration=2.5, padding_factor=4,
              filter_kwargs=HIGHPASS)
    gen = [0.0]

    def days(ip, idx):
        """The pair's datasets of the days ``idx``, made as iterated; the
        making is timed apart."""
        for i in idx:
            t0 = time.perf_counter()
            ds = campaign_day(xt, p8["init_args"], p8["pairs"], p8["dists"],
                              p8["offsets"], int(i), which=[ip])[0]
            gen[0] += time.perf_counter() - t0
            yield ds

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cache = {"card": 0.0, "dev_ms": 0.0, "ops": 0}
    cells = {"card": 0.0, "dev_ms": 0.0, "ops": 0, "n": 0}
    err = {"spec": 0.0, "cc2": 0.0}
    shapes, ties = {}, 0
    for ip in TL_PAIRS:
        gen[0] = 0.0
        with device_profile() as prof:
            (specs, freq), t = timed(lambda: pair_spectrograms(
                days(ip, range(TL_DAYS)), times, device="cuda", **kw))
        ms, k, c = device_ops(prof)
        cache["card"] += t - gen[0]
        cache["dev_ms"] += ms
        cache["ops"] += k + c
        check(all(s is not None for s in specs), "8d: a day had no data")
        sample = np.sort(rng.choice(TL_DAYS, TL_SAMPLE_TIMES, replace=False))
        cpu_specs, _ = pair_spectrograms(days(ip, sample), times[sample],
                                         device="cpu", **kw)
        for k, i in enumerate(sample):
            err["spec"] = max(err["spec"], rel_err(specs[i], cpu_specs[k],
                                                   peak=True))
        la, lb = np.triu_indices(TL_SAMPLE_TIMES)
        pick = np.sort(rng.choice(la.size, TL_SAMPLE_CELLS, replace=False))
        la, lb = la[pick], lb[pick]
        for f0, f1 in TL_BANDS:
            sel = (freq >= f0) & (freq <= f1)
            stack = np.stack([s[sel] for s in specs])
            shapes[(f0, f1)] = stack.shape
            with device_profile() as prof:
                (pk, df_, dl_), t = timed(lambda: correlate_spectrograms(
                    stack, iu, ju, device="cuda"))
            ms, k, c = device_ops(prof)
            cells["card"] += t
            cells["dev_ms"] += ms
            cells["ops"] += k + c
            cells["n"] += iu.size
            # one (pair, band) stack and its cells go on to phase 9d
            p8.setdefault("tl_stack", (stack, (pk, df_, dl_),
                                       f"{p8['pairs'][ip]} {f0:g}-{f1:g} "
                                       "Hz"))
            cstack = np.stack([s[sel] for s in cpu_specs])
            cpk, cdf, cdl = correlate_spectrograms(cstack, la, lb,
                                                   device="cpu")
            idx = [cell_of[(sample[a], sample[b])] for a, b in zip(la, lb)]
            err["cc2"] = max(err["cc2"],
                             float(np.abs(pk[idx] - cpk).max()))
            for n in np.flatnonzero((df_[idx] != cdf) | (dl_[idx] != cdl)):
                a, b = cstack[la[n]], cstack[lb[n]]
                gap = abs(shift_value(a, b, df_[idx][n], dl_[idx][n])
                          - shift_value(a, b, cdf[n], cdl[n]))
                check(gap <= 2 * P7_TOL,
                      f"8d {p8['pairs'][ip]} band {f0}-{f1} Hz: shifts "
                      f"({df_[idx][n]}, {dl_[idx][n]}) on the card, "
                      f"({cdf[n]}, {cdl[n]}) on the CPU, {gap} apart")
                ties += 1
            check(bool(np.isfinite(pk).all()), "8d: non-finite cc2")
            diag = pk[iu == ju]
            check(bool(np.abs(diag - 1.0).max() < 1e-5),
                  f"8d: self-correlation peaks {diag.min()} - {diag.max()}")
        del specs, cpu_specs
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(err["spec"] <= P7_TOL and err["cc2"] <= P7_TOL,
          f"8d: spectrograms {err['spec']} of their max, cc2 {err['cc2']}")
    npd = len(TL_PAIRS) * TL_DAYS

    def share(r, wall):
        return f"{r['dev_ms'] / 1e3 / wall:.4f}" if r["dev_ms"] > 0 \
            else "not measured"
    phase(8, f"8d timelapse, {len(TL_PAIRS)} pairs x {TL_DAYS} days x "
             f"{len(TL_BANDS)} bands: spectrogram cache {npd} pair-days, "
             f"card {1e3 * cache['card'] / npd:.1f} ms per pair-day "
             f"(postprocess + spectrogram; making the data timed apart), "
             f"device share {share(cache, cache['card'])}, device "
             f"operations per pair-day {cache['ops'] / npd:.1f}")
    phase(8, f"8d cells on the card: {cells['n']} in {cells['card']:.2f} s "
             f"= {cells['n'] / cells['card']:.0f} cells/s, device share "
             f"{share(cells, cells['card'])}, device operations per cell "
             f"{cells['ops'] / cells['n']:.2f}; stacks (times, freqs, lags) "
             + "; ".join(f"{f0:g}-{f1:g} Hz {v}"
                         for (f0, f1), v in shapes.items())
             + f"; peak device memory {peak_gb:.2f} GB above "
               f"{base / 1e9:.2f}")
    phase(8, f"8d card vs CPU: spectrograms of {TL_SAMPLE_TIMES} times per "
             f"pair within {err['spec']:.2e} of their max; "
             f"{TL_SAMPLE_CELLS} cells per (pair, band): cc2 within "
             f"{err['cc2']:.2e}, delta_freq and delta_lag equal but for "
             f"{ties} near-ties")

# -- 9. the multi-device layer on the one card -------------------------------

#: phase 9's logical mesh: the one card, named twice
MESH_DEVICES = ("cuda:0", "cuda:0")
#: seconds a 9c worker may take
WORKER_TIMEOUT = 300


def wall_ms(fn, reps=5):
    """Median wall ms of ``fn()`` after one warm-up, the device
    synchronized at both ends."""
    fn()
    return float(np.median([1e3 * timed(fn)[1] for _ in range(reps)]))


def phase9a_sharded(ff, cc, mesh, imin, imax, oracle):
    """``sharded_correlate`` of phase 4's 16 day-scale windows over the
    logical mesh, once per route: the route's kernel once per entry and
    nothing else, rows 0 and 1 (phase 4's oracle) and 8 (the second
    entry's first) within CCF_ATOL of float64, the peak on the injected
    delay, the difference from the unsharded ``correlate`` and wall times
    per window, the host gather included: sharded, unsharded with the
    same pinned readback (``Readback``), and unsharded with a plain
    ``.cpu()``. Returns the launches by route."""
    from xcorr_tpu_torch.parallel import sharded_correlate
    from xcorr_tpu_torch.parallel.pipeline import Readback
    B = 16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((B, N), generator=gen, device="cuda")
    shift = int(DELAY * FS)
    y = torch.roll(x, -shift, dims=1) + \
        0.5 * torch.randn((B, N), generator=gen, device="cuda")
    oracle = dict(enumerate(oracle))
    oracle[8] = f64_oracle(x[8].double().cpu().numpy(),
                           y[8].double().cpu().numpy(), imin, imax)
    lags = dict(index_min=imin, index_max=imax)
    launches = {}
    for route, (kname, _) in ROUTES.items():
        set_route(route)
        ff.reset_launches()
        got = sharded_correlate(x, y, mesh=mesh, **lags)
        counts = dict(ff.launches)
        check(counts[kname] == mesh.size
              and sum(counts.values()) == mesh.size,
              f"9a route {route}: sharded_correlate launched {counts}, "
              f"expected {kname} once per mesh entry")
        launches[route] = {kname: counts[kname]}
        check(got.shape == (B, imax - imin) and bool(np.isfinite(got).all()),
              f"9a route {route}: result {got.shape}, or not finite")
        err = max(float(np.abs(got[i] - o).max()) for i, o in oracle.items())
        check(err <= CCF_ATOL, f"9a route {route}: CCF error {err} > "
                               f"{CCF_ATOL}")
        peak = int(got[0].argmax()) + imin - (N - 1)
        check(peak == shift, f"9a route {route}: peak at {peak} samples")
        plain = cc.correlate(x, y, **lags).cpu().numpy()
        diff = float(np.abs(got - plain).max())
        check(diff <= CCF_ATOL, f"9a route {route}: {diff} from the "
                                "unsharded correlate")
        t_mesh = wall_ms(lambda: sharded_correlate(x, y, mesh=mesh, **lags))
        t_one = wall_ms(lambda: Readback(cc.correlate(x, y, **lags)).wait())
        t_cpu = wall_ms(lambda: cc.correlate(x, y, **lags).cpu())
        phase(9, f"9a route {route} ({kname}): sharded_correlate {B} x {N} "
                 f"over {mesh.size} entries: {kname} launches "
                 f"{counts[kname]}, max abs vs f64 {err:.3e} (rows "
                 f"{sorted(oracle)}), vs unsharded {diff:.3e} "
                 f"(bit-identical: {diff == 0.0}); ms per window with the "
                 f"host gather (median of 5): sharded {t_mesh / B:.4f}, "
                 f"unsharded {t_one / B:.4f} (same pinned readback; split "
                 f"overhead {(t_mesh - t_one) / B:+.4f}), unsharded with "
                 f".cpu() {t_cpu / B:.4f}")
    set_route("corr")
    del x, y
    torch.cuda.empty_cache()
    return launches


def phase9b_mesh_engine(xt, ff, mesh, ref, ref_wall):
    """Phase 6's 4 pair-days through ``device_process_bulk(mesh=)`` under
    ``util.profiler.trace``: K1 once per entry, statuses and CCFs held to
    phase 6's warm mesh=None run (``ref``), the trace's busy time and
    device spans beside the profiler's own device time, wall,
    host->device bytes, peak memory and ``device_memory``. Returns the
    launches."""
    from xcorr_tpu_torch.parallel import device_process_bulk
    from xcorr_tpu_torch.util import profiler
    inv, client, days, dataset = engine_setup(xt)
    dss = [dataset(d) for d in days]
    timer = profiler.StageTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as logdir:
        ff.reset_launches()
        with profiler.trace(logdir) as prof:
            t0 = time.perf_counter()
            finalize, fallback = device_process_bulk(
                dss, client, inventory=inv, timer=timer, verb=0, mesh=mesh)
            finalize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(ff.launches)
        busy = profiler.parse_device_trace(logdir)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(not fallback, f"9b: the device engine fell back: {fallback}")
    check(counts["fused_corr"] == mesh.size
          and sum(counts.values()) == mesh.size,
          f"9b: launched {counts}, expected fused_corr once per entry")
    diff, same = 0.0, True
    for d, (cc_ref, status_ref) in zip(dss, ref):
        check(np.array_equal(d["status"].values, status_ref),
              f"9b: statuses {d['status'].values.tolist()}")
        diff = max(diff, float(np.abs(d["cc"].values - cc_ref).max()))
        same &= bool(np.array_equal(d["cc"].values, cc_ref))
    check(diff <= CCF_ATOL, f"9b: CCFs {diff} from mesh=None")
    check(busy is not None and 0 < busy["device_busy_s"] <= wall
          and busy["launches"] > 0, f"9b: trace {busy}, wall {wall}")
    # the trace holds host operations too, whose device time repeats
    # their kernels': only the card's own events are summed
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ndev = sum(e.count for e in dev)
    mem = profiler.device_memory(mesh)
    h2d = timer.as_dict()["device-dispatch"].get("GB", 0.0)
    phase(9, f"9b device_process_bulk(mesh=) of phase 6's {len(dss)} "
             f"pair-days: {wall:.2f} s wall (mesh=None, phase 6 warm: "
             f"{ref_wall:.2f} s), fused_corr launches "
             f"{counts['fused_corr']}, statuses equal, max |CCF - "
             f"mesh=None| {diff:.3e} (bit-identical: {same}), "
             f"host->device {h2d:.3f} GB, peak device memory "
             f"{peak_gb:.2f} GB above {base / 1e9:.2f}")
    phase(9, f"9b util.profiler.trace: parse_device_trace busy "
             f"{busy['device_busy_s']:.4f} s in {busy['launches']} device "
             f"spans (busy / wall {busy['device_busy_s'] / wall:.4f}); "
             f"torch.profiler key_averages of the same run, the card's "
             f"events: {dev_ms:.1f} ms in {ndev} kernels and copies")
    phase(9, "9b device_memory(mesh): " + "; ".join(
        f"{k}: peak allocated {v['allocated_bytes.all.peak'] / 1e9:.2f} GB,"
        f" reserved {v['reserved_bytes.all.current'] / 1e9:.2f} GB"
        for k, v in mem.items()))
    return {"fused_corr": counts["fused_corr"]}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank, port, outdir):
    """A 9c process: join the two-process gloo group, take this rank's
    ``host_slice`` of phase 6's 4 pair-days, run them through
    ``device_process_bulk`` on cuda:0 and write their CCFs and statuses
    to ``<outdir>/rank<rank>.npz``; the last line is a JSON record."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import fused_fft as ff
    from xcorr_tpu_torch.parallel import (device_process_bulk, distributed,
                                          host_slice)
    check(distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                                 process_id=rank),
          "initialize() returned False")
    inv, client, days, dataset = engine_setup(xt)
    mine = host_slice(list(range(len(days))))
    dss = [dataset(days[i]) for i in mine]
    ff.reset_launches()
    t0 = time.perf_counter()
    finalize, fallback = device_process_bulk(dss, client, inventory=inv,
                                             verb=0, device="cuda")
    finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not fallback, f"worker {rank}: fell back {fallback}")
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), days=np.asarray(mine),
             cc=np.stack([d["cc"].values for d in dss]),
             status=np.stack([d["status"].values for d in dss]))
    distributed.shutdown()
    check("jax" not in sys.modules, "the worker imported jax")
    print(json.dumps({"rank": rank, "days": mine,
                      "launches": dict(ff.launches), "wall_s": wall}))


def phase9c_processes(ref, ref_wall):
    """Two worker processes on the one card form a gloo group, each runs
    its ``host_slice`` of phase 6's 4 pair-days; their union is held to
    phase 6's warm one-process run (``ref``). Returns the launches by
    rank."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as outdir:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(rank), str(port), outdir], cwd=here, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]
        outs = []
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    fail(f"9c: a worker ran past {WORKER_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        recs = []
        for rank, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"9c worker {rank} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
        parts = [np.load(os.path.join(outdir, f"rank{r}.npz"))
                 for r in range(2)]
        union = {}
        for part in parts:
            for k, day in enumerate(part["days"]):
                check(int(day) not in union, f"9c: day {day} twice")
                union[int(day)] = (part["cc"][k], part["status"][k])
    check(sorted(union) == list(range(len(ref))),
          f"9c: the workers took days {sorted(union)}")
    diff, same = 0.0, True
    for day, (cc_ref, status_ref) in enumerate(ref):
        got_cc, got_status = union[day]
        check(np.array_equal(got_status, status_ref),
              f"9c: day {day} statuses {got_status.tolist()}")
        diff = max(diff, float(np.abs(got_cc - cc_ref).max()))
        same &= bool(np.array_equal(got_cc, cc_ref))
    check(diff <= CCF_ATOL, f"9c: CCFs {diff} from the one-process run")
    for r in recs:
        check(r["launches"]["fused_corr"] >= 1,
              f"9c worker {r['rank']} launched {r['launches']}")
    phase(9, f"9c two processes on the card (gloo group on 127.0.0.1:"
             f"{port}): days " + ", ".join(
                 f"rank {r['rank']} {r['days']} ({r['wall_s']:.2f} s in "
                 f"device_process_bulk, launches "
                 f"{ {k: v for k, v in r['launches'].items() if v} })"
                 for r in recs)
             + f"; {wall:.2f} s from start to both exits (one process, "
               f"phase 6 warm: {ref_wall:.2f} s in device_process_bulk); "
               f"union max |CCF - one process| {diff:.3e} (bit-identical: "
               f"{same})")
    return {f"rank {r['rank']}": {k: v for k, v in r["launches"].items()
                                  if v} for r in recs}


def phase9d_timelapse(mesh, p8):
    """``correlate_spectrograms(mesh=)`` of one (pair, band) stack of
    phase 8d, held to 8d's mesh=None cells: peaks within P7_TOL
    relative, shifts equal but for near-ties, checked in float64 as 8d
    checks them and counted."""
    from xcorr_tpu_torch.scripts.timelapse import correlate_spectrograms
    stack, (pk, df_, dl_), label = p8["tl_stack"]
    iu, ju = np.triu_indices(stack.shape[0])
    (gpk, gdf, gdl), t_mesh = timed(
        lambda: correlate_spectrograms(stack, iu, ju, mesh=mesh))
    _, t_one = timed(
        lambda: correlate_spectrograms(stack, iu, ju, device="cuda"))
    err = rel_err(gpk, pk)
    check(err <= P7_TOL, f"9d: peaks {err} from mesh=None")
    ties = 0
    for n in np.flatnonzero((gdf != df_) | (gdl != dl_)):
        a, b = stack[iu[n]], stack[ju[n]]
        gap = abs(shift_value(a, b, gdf[n], gdl[n])
                  - shift_value(a, b, df_[n], dl_[n]))
        check(gap <= 2 * P7_TOL, f"9d cell {n}: shifts ({gdf[n]}, "
                                 f"{gdl[n]}) and ({df_[n]}, {dl_[n]}), "
                                 f"{gap} apart")
        ties += 1
    phase(9, f"9d correlate_spectrograms(mesh=) of {label}, stack "
             f"{stack.shape}, {iu.size} cells: peaks within {err:.2e} of "
             f"mesh=None (bit-identical: {bool(np.array_equal(gpk, pk))}), "
             f"shifts equal but for {ties} near-ties; {t_mesh:.3f} s "
             f"sharded, {t_one:.3f} s unsharded")



def main():
    t_start = time.perf_counter()
    # -- 1. the card ---------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import _build, cc, fft4
    from xcorr_tpu_torch.ops import fused_fft as ff
    check("jax" not in sys.modules, "the port imported jax")
    set_route("corr")
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} "
             f"count {torch.cuda.device_count()}")

    # -- 2. build ----------------------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    ptxas = {unit: subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.path.join(tmp.name, f"{i}.o"), str(_build._CSRC / src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for i, (unit, src) in enumerate(PTXAS_UNITS.items())}
    t0 = time.perf_counter()
    lib = _build.load()
    phase(2, f"kernels built in {_build.build_seconds:.2f} s "
             f"(load {time.perf_counter() - t0:.2f} s)")
    for unit, proc in ptxas.items():
        report = proc.communicate()[1]
        check(proc.returncode == 0, f"nvcc -Xptxas -v of {unit} failed: "
                                    f"{report}")
        for line in ptxas_summary(unit, report, ff):
            phase(2, f"{unit} ptxas, {line}")
    tmp.cleanup()
    hmma, forms = tf32_hmma(_build._library_path(), _build._nvcc())
    gemm = {k: v for k, v in hmma.items() if "gemm_tf32_kernel" in k}
    check(len(gemm) == 2 and min(gemm.values()) > 0,
          f"TF32 HMMA per product instance: {gemm} (forms {forms})")
    phase(2, f"TF32 HMMA in the library's SASS: K3's and K4's product "
             f"(gemm_tf32.cu) {sum(gemm.values())} in {len(gemm)} "
             f"instances ({', '.join(str(v) for v in gemm.values())}); "
             f"elsewhere {sum(hmma.values()) - sum(gemm.values())}; HMMA "
             f"forms {forms}")

    # -- 3. every kernel against its plain version ------------------------
    # lag window and four-step plan of the production geometry
    ds_geom = xt.init(pair=PAIR, starttime="2014-02-01",
                      endtime="2014-02-01T03:00", preprocess={"EDH": EDH},
                      attrs={"institution": "x", "author": "x",
                             "source": "x"},
                      sampling_rate=FS, window_length=WINDOW,
                      window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG)
    lag_attrs = ds_geom.coords["lag"].attrs
    imin, imax = int(lag_attrs["index_min"]), int(lag_attrs["index_max"])
    check(int(lag_attrs["npts"]) == N, f"npts {lag_attrs['npts']} != {N}")
    plans = {route: fft4.plan_correlate4(N, imin, imax, normalize=True,
                                         route=route) for route in ROUTES}
    check(all((p.N1, p.N2, p.half) == (528, 16384, 265)
              for p in plans.values()),
          f"default geometry {[(p.N1, p.N2) for p in plans.values()]}")
    plan = plans["corr"]
    plan_1056 = fft4.plan_correlate4(N, imin, imax, n1=1056,
                                     normalize=True, route="acc")
    check(not fft4.tf32_enabled(), "TF32 is on after building a plan")
    phase(3, f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
             f"float32_matmul_precision="
             f"{torch.get_float32_matmul_precision()}")
    rec = phase3_kernels(ff, plan, plan_1056, lib.xc_fused_corr_phases)

    # -- 4. day-scale correlate, once per route ---------------------------
    oracle = phase4_correlate(ff, cc, fft4, imin, imax)

    # -- 5. the slice: one production-geometry pair-day per route ----------
    launches = phase5_pair_days(xt, ff)

    # -- 6. the device engine: 4 pair-days in one launch -------------------
    t6 = time.perf_counter()
    launches["fused_corr"], dss, engine_wall = phase6_device_engine(xt, ff)
    # phase 9 holds its mesh and its processes to this mesh=None run
    engine_ref = [(d["cc"].values.copy(), d["status"].values.copy())
                  for d in dss]

    # -- 7. the analysis slice: full width, then the campaign --------------
    t7 = time.perf_counter()
    phase7a_full_width(xt, dss, ENGINE_DAYS)
    del dss
    t7b = time.perf_counter()
    p8 = new_phase8()
    phase7b_campaign(xt, p8)
    t8d = time.perf_counter()

    # -- 8. the rest of the analysis tier: 8a-8c ran in 7b's day loop ------
    phase8_report(p8)
    phase8d_timelapse(xt, p8)
    t_end = time.perf_counter()
    phase(8, f"command time: phases 1-5 {t6 - t_start:.1f} s, phase 6 "
             f"{t7 - t6:.1f} s, 7a {t7b - t7:.1f} s, 7b "
             f"{t8d - t7b - p8['seconds']:.1f} s, 8a-8c "
             f"{p8['seconds']:.1f} s, 8d {t_end - t8d:.1f} s, all "
             f"{t_end - t_start:.1f} s")

    # -- 9. the multi-device layer: a logical mesh, two processes ----------
    from xcorr_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=MESH_DEVICES)
    phase(9, f"{mesh}: a logical mesh, {torch.cuda.device_count()} card "
             "visible; both entries run on cuda:0, one after the other, "
             "so the times below are the split's overhead, not a "
             "multi-card speed")
    path = {f"9a {route}": v for route, v in phase9a_sharded(
        ff, cc, mesh, imin, imax, oracle).items()}
    path["9b engine"] = phase9b_mesh_engine(xt, ff, mesh, engine_ref,
                                            engine_wall)
    t9c = time.perf_counter()
    path.update({f"9c {k}": v for k, v in phase9c_processes(
        engine_ref, engine_wall).items()})
    t9d = time.perf_counter()
    phase9d_timelapse(mesh, p8)
    t9_end = time.perf_counter()
    phase(9, "launches on this slice's path, each count reset just before "
             "its run and read just after: " + json.dumps(path))
    phase(9, f"command time: 9a-9b {t9c - t_end:.1f} s, 9c "
             f"{t9d - t9c:.1f} s, 9d {t9_end - t9d:.1f} s, phase 9 "
             f"{t9_end - t_end:.1f} s, all {t9_end - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": None,
    } for name in ff.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
