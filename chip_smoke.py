"""Smoke run of the PyTorch port (``xcorr_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch, CUDA and the TF32 switches;
2. build the hand-written kernels from ``xcorr_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and, beside the build,
   ``nvcc -Xptxas -v`` of K1, K3 and K4 for the registers, shared memory
   and spills of their row chains at N2 = 8192 and 16384 and of K3's and
   K4's split-TF32 product (``gemm_tf32.cu``); then the count of TF32
   ``HMMA`` instructions in the built library's SASS (``cuobjdump
   -sass``), on its own line;
3. every kernel against its plain PyTorch version, max |diff| / max
   |plain| <= 1e-5, with CUDA-event times of both (median of 20 launches
   after warm-up) and the card's bound for the same work: K1 at the
   pair-day's shape of its route (8, 2, 265, 16384: n1 = 528), at
   (4, 2, 265, 16384), at the n1 = 1056 shape (8, 2, 529, 8192) and at a
   small one; K3 and K4 at the pair-day's shape of their routes (B = 8,
   H = 265, N2 = 16384, rows_in = 264, rows_out = 99, with the n1 = 528
   plan's own w1, T and wi), at the n1 = 1056 one (B = 8, H = 529,
   N2 = 8192, rows_in = 528, rows_out = 198, that plan's constants) and
   at a small one; K2 (forward and inverse, rows up to 8192) at the
   n1 = 1056 and the small shapes. K1, K3 and K4 run twice on the same
   inputs and must give the same bits. At the two 8-window K1 shapes,
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
   On the K1 route also ``write`` -> ``read`` where h5py is installed.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
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

import numpy as np
import torch

FS = 50.0
WINDOW = 86400.0
N = int(WINDOW * FS)                 # 4,320,000 samples per window
CLIP_LAG = (0.0, 9 * 3600.0)
DELAY = 4.0                          # s, injected on the first receiver
PAIR = "IM.H03S1..EDH-IM.H03S2..EDH"
K_RTOL = 1e-5                        # kernel vs plain: max|diff| / max|plain|
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


def hold(ff, name, label, args, rerun=False):
    """One kernel against its plain version: error, times, output; with
    ``rerun``, a second launch on the same inputs must give the same
    bits."""
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
    check(rel <= K_RTOL, f"{name} {label} rel err {rel} > {K_RTOL}")
    return got, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase3_kernels(ff, plan, plan_1056, clock_fn):
    """Every kernel against its plain version; returns the pair-day
    shape's record per kernel. ``plan`` is the n1 = 528 plan every route
    takes, ``plan_1056`` the n1 = 1056 one (rows of 8192, K2's limit),
    ``clock_fn`` K1's phase-clock entry point."""
    rec = {}
    H, N2, rows_in, rows_out = plan.half, plan.N2, plan.rows_in, \
        plan.rows_out
    H8, N28, rows_in8, rows_out8 = plan_1056.half, plan_1056.N2, \
        plan_1056.rows_in, plan_1056.rows_out
    # K1: the pair-day's shape (8 windows) first; the record keeps it
    for shape in [(8, 2, H, N2), (4, 2, H, N2), (8, 2, H8, N28),
                  (2, 2, 24, 256)]:
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
    # K3 and K4 at their pair-day's shape with the plan's constants, then
    # K2 (rows up to 8192), K3 and K4 at the n1 = 1056 one and a small one
    for B, Hs, N2s, ri, ro, consts, with_k2 in [
            (8, H, N2, rows_in, rows_out, plan.device_consts("cuda"), False),
            (8, H8, N28, rows_in8, rows_out8,
             plan_1056.device_consts("cuda"), True),
            (2, 24, 256, 8, 5, None, True)]:
        d = kernel_inputs(B, Hs, N2s, ri, ro, SEED, consts)
        label = f"B={B} H={Hs} N2={N2s} rows_in={ri} rows_out={ro}"
        ax, ay, T, w1, wi, vx, vy = (d[k] for k in (
            "ax", "ay", "T", "w1", "wi", "vx", "vy"))
        plane = nbytes(ax)
        out_rows = B * ro * N2s * 4
        k1_ops = stageb_flops(B, Hs, N2s)
        inv_ops = 2 * B * ro * 2 * Hs * N2s
        a_ops = 2 * 2 * B * 2 * Hs * ri * N2s
        fft = 5 * N2s * math.log2(N2s)
        if with_k2:
            f, r = hold(ff, "stageb_fwd", label, (ax, T))
            r["bound_ms"], r["bound_by"], _ = bound(
                nbytes(ax, T), plane, B * Hs * (fft + 6 * N2s))
            rec.setdefault("stageb_fwd", r)
            g = ff.stageb_fwd(ay, T)
            _, r = hold(ff, "stageb_inv", label, (f, g, T))
            r["bound_ms"], r["bound_by"], _ = bound(
                nbytes(f, g, T), plane, B * Hs * (fft + 14 * N2s))
            rec.setdefault("stageb_inv", r)
            del f, g
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
#: csrc/corr_rows.cuh) and K3's and K4's split-TF32 product
PTXAS_UNITS = {"K1": "fused_corr.cu", "K3": "fused_corr_acc.cu",
               "K4": "fused_corr_full.cu", "K3/K4 product": "gemm_tf32.cu"}
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
    clock at N2 = 8192 and 16384 (registers, spills, the block's dynamic
    shared memory: x spectrum, pass twiddles, exchange buffer), or the
    product's two instances (B in 16-byte copies, as at the pair-day's
    shapes, or in 4-byte ones)."""
    lines = []
    for name, (regs, frame) in sorted(ptxas_entries(report).items()):
        m = re.search(r"fused_corr_kernelILi(\d+)ELb0E", name)
        if m and int(m.group(1)) in (13, 14):
            n = 1 << int(m.group(1))
            smem = 8 * n + 8 * len(ff._k1_twiddles(n, "cpu")) \
                + 4 * (n + n // 32)
            lines.append(f"rows, N2 = {n}: {regs} registers, {frame}, "
                         f"{smem} bytes of dynamic shared memory")
        m = re.search(r"gemm_tf32_kernelILb([01])E", name)
        if m:
            copies = "16-byte" if m.group(1) == "1" else "4-byte"
            lines.append(f"product, B in {copies} copies: {regs} "
                         f"registers, {frame}, {GEMM_SMEM} bytes of "
                         f"dynamic shared memory")
    check(len(lines) == 2, f"ptxas report of {unit}: {lines}")
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
    default geometry and at n1 = 1056."""
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


def main():
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
    phase4_correlate(ff, cc, fft4, imin, imax)

    # -- 5. the slice: one production-geometry pair-day per route ----------
    launches = phase5_pair_days(xt, ff)

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
    main()
