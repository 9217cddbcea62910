"""Smoke run of the PyTorch port (``xcorr_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch, CUDA and the TF32 switches;
2. build the hand-written kernels from ``xcorr_tpu_torch/csrc``;
3. the fused stage-B kernel (K1) against its plain PyTorch version at the
   pair-day's shape (8, 2, 529, 8192), at (4, 2, 529, 8192) and at a small
   one, max |diff| / max |plain| <= 1e-5, with CUDA-event times of both
   (median of 20 launches after warm-up);
4. ``ops.cc.correlate`` on 16 synthetic 24 h windows at 50 Hz
   (n = 4,320,000) with the 0-9 h lag window: the four-step path through
   K1, 2 windows within 1e-6 abs of a float64 numpy oracle, and the time
   per window split into stage-A product, K1, inverse product and lag
   slice;
5. the slice: ``init`` -> ``process(device='cuda')`` (-> ``write`` ->
   ``read`` where h5py is installed) of one production-geometry pair-day
   from ``SyntheticClient``: every status 1, the CCF peak on the injected
   delay, K1 launched, wall seconds and device share.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import importlib.util
import json
import os
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
K1_RTOL = 1e-5                       # K1 vs plain: max|diff| / max|plain|
CCF_ATOL = 1e-6                      # normalized CCF vs float64 oracle
SEED = 20140201
#: the EDH preprocess chain of the production benchmark
EDH = [("detrend", {"type": "demean"}),
       ("filter", {"type": "highpass", "freq": 0.05}),
       ("detrend", {"type": "demean"}),
       ("taper", {"type": "cosine", "max_percentage": 0.05,
                  "max_length": 30.0})]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(i, msg):
    print(f"[phase {i}] {msg}", flush=True)


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


def k1_inputs(shape, seed):
    """Seeded stage-A-like planes and a unit-modulus twiddle on the card."""
    rng = np.random.default_rng(seed)
    ax = rng.standard_normal(shape, dtype=np.float32)
    ay = rng.standard_normal(shape, dtype=np.float32)
    ph = rng.uniform(0.0, 2 * np.pi, size=shape[2:])
    T = np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (ax, ay, T)]


def f64_oracle(x, y, imin, imax):
    """Normalized CCF on the lag window, float64 numpy rfft."""
    n = x.shape[-1]
    nfft = 1 << (2 * n - 2).bit_length()
    r = np.fft.irfft(np.fft.rfft(x, nfft) * np.conj(np.fft.rfft(y, nfft)),
                     nfft)
    idx = (np.arange(imin, imax) - (n - 1)) % nfft
    return r[idx] / (np.linalg.norm(x) * np.linalg.norm(y))


def device_ms(prof):
    """Device time (ms) of the kernels and copies a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def main():
    # -- 1. the card ---------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    import xcorr_tpu_torch as xt
    from xcorr_tpu_torch.ops import _build, cc, fft4, fused_fft
    from xcorr_tpu_torch.stream import Channel, Inventory, SyntheticClient
    check("jax" not in sys.modules, "the port imported jax")
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} "
             f"count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase(2, f"kernels built in {_build.build_seconds:.2f} s "
             f"(load {time.perf_counter() - t0:.2f} s)")

    # -- 3. K1 against its plain version ----------------------------------
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
    plan = fft4.plan_correlate4(N, imin, imax, normalize=True)
    check(not fft4.tf32_enabled(), "TF32 is on after building a plan")
    phase(3, f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
             f"float32_matmul_precision="
             f"{torch.get_float32_matmul_precision()}")
    k1 = {}
    # the pair-day's shape (8 windows) first: the JSON record keeps it
    for shape in [(8, 2, plan.half, plan.N2), (4, 2, plan.half, plan.N2),
                  (2, 2, 24, 256)]:
        ax, ay, T = k1_inputs(shape, SEED)
        got = fused_fft.fused_corr(ax, ay, T)
        torch.cuda.synchronize()
        want = fused_fft.fused_corr_plain(ax, ay, T)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = median_ms(lambda: fused_fft.fused_corr(ax, ay, T))
        plain_ms = median_ms(lambda: fused_fft.fused_corr_plain(ax, ay, T))
        phase(3, f"K1 {shape}: max_abs_err {err:.3e} rel {rel:.3e} "
                 f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        check(rel <= K1_RTOL, f"K1 {shape} rel err {rel} > {K1_RTOL}")
        k1.setdefault("err", err)
        k1.setdefault("ms", ms)
        k1.setdefault("plain_ms", plain_ms)
        del ax, ay, T, got, want

    # -- 4. day-scale correlate through the four-step path -----------------
    B = 16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((B, N), generator=gen, device="cuda")
    shift = int(DELAY * FS)
    y = torch.roll(x, -shift, dims=1) + \
        0.5 * torch.randn((B, N), generator=gen, device="cuda")
    fused_fft.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = cc.correlate(x, y, index_min=imin, index_max=imax)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(fused_fft.launches == 1,
          f"correlate launched K1 {fused_fft.launches} times, expected 1")
    check(tuple(out.shape) == (B, imax - imin), f"shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "non-finite CCF")
    xh = x[:2].double().cpu().numpy()
    yh = y[:2].double().cpu().numpy()
    oh = out[:2].double().cpu().numpy()
    err = max(float(np.abs(oh[i] - f64_oracle(xh[i], yh[i], imin, imax))
                    .max()) for i in range(2))
    phase(4, f"correlate {B} x {N} lags [{imin}, {imax}) "
             f"({imax - imin} per row): max abs vs f64 {err:.3e}, "
             f"peak working memory {peak_gb:.2f} GB")
    check(err <= CCF_ATOL, f"CCF error {err} > {CCF_ATOL}")
    peak = int(out[0].argmax()) + imin - (N - 1)
    check(peak == shift, f"peak at lag {peak} samples, expected {shift}")

    w1, wi, t = plan.device_consts(x.device)
    ax, ay = plan.stage_a(x, w1), plan.stage_a(y, w1)
    c = fused_fft.fused_corr(ax, ay, t)
    flat = plan.inverse(c, wi)
    t_a = median_ms(lambda: (plan.stage_a(x, w1), plan.stage_a(y, w1)), 10)
    t_k = median_ms(lambda: fused_fft.fused_corr(ax, ay, t), 10)
    t_i = median_ms(lambda: plan.inverse(c, wi), 10)
    t_s = median_ms(lambda: fft4._finish_ccf(flat, x, y, plan.segs_flat,
                                             True), 10)
    t_all = median_ms(lambda: cc.correlate(x, y, index_min=imin,
                                           index_max=imax), 10)
    t_mono = median_ms(lambda: cc.correlate(x, y, index_min=imin,
                                            index_max=imax,
                                            method="monolithic"), 10)
    phase(4, f"ms per window (B={B}, N1={plan.N1}, N2={plan.N2}, "
             f"H={plan.half}): stage-A {t_a / B:.4f}, K1 {t_k / B:.4f}, "
             f"inverse {t_i / B:.4f}, lag slice+norm {t_s / B:.4f}; "
             f"correlate {t_all / B:.4f}; monolithic cuFFT "
             f"{t_mono / B:.4f}")
    del x, y, out, ax, ay, c, flat
    torch.cuda.empty_cache()

    # -- 5. the slice: one production-geometry pair-day ---------------------
    inv = Inventory([
        Channel("IM", "H03S1", "", "EDH", latitude=-33.6, longitude=-78.8),
        Channel("IM", "H03S2", "", "EDH", latitude=-33.7, longitude=-78.9),
    ])
    client = SyntheticClient(
        sampling_rate=FS,
        delays={"IM.H03S1..EDH": DELAY, "IM.H03S2..EDH": 0.0},
        source_period=600.0, source_amplitude=20.0)
    ds = xt.init(pair=PAIR, starttime="2014-02-01", endtime="2014-02-02",
                 preprocess={"EDH": EDH},
                 attrs={"institution": "smoke", "author": "smoke",
                        "source": "SyntheticClient"},
                 sampling_rate=FS, window_length=WINDOW,
                 window_overlap=21.0 / 24.0, clip_lag=CLIP_LAG,
                 inventory=inv)
    nwin = ds.dims["time"]
    check(nwin == 8, f"{nwin} windows per pair-day, expected 8")
    from torch.profiler import ProfilerActivity, profile
    fused_fft.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xt.process(ds, client, device="cuda", verb=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = fused_fft.launches
    check(main_launches > 0, "process never launched K1")
    status = ds["status"].values
    check(bool((status == 1).all()), f"status {status.tolist()}")
    ccv = ds["cc"].values
    check(bool(np.isfinite(ccv).all()), "non-finite CCF in the dataset")
    lag = ds.coords["lag"].values
    peaks = [float(lag[int(np.argmax(ccv[0, i]))]) for i in range(nwin)]
    check(all(abs(p - DELAY) < 1.0 / FS + 1e-9 for p in peaks),
          f"CCF peaks {peaks} s, injected delay {DELAY} s")
    dev = device_ms(prof)
    share = (f"{dev / 1e3 / wall:.4f}" if dev > 0 else "not measured")
    phase(5, f"pair-day {nwin} windows x {ccv.shape[-1]} lags: "
             f"{wall:.2f} s wall, device {dev:.1f} ms, device share {share}, "
             f"K1 launches {main_launches}, peaks at {sorted(set(peaks))} s")
    if importlib.util.find_spec("h5py") is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = xt.write(ds, os.path.join(tmp, "shard.nc"), verb=0)
            back = xt.read(path)
            check(back is not None, "read returned None")
            check(np.array_equal(back["cc"].values, ccv), "read != written")
            check(bool((back["status"].values == 1).all()), "read status")
        phase(5, "write -> read round trip equal")
    else:
        phase(5, "write -> read not run: h5py is not installed")

    print(json.dumps({"kernels": [{
        "name": "fused_corr",
        "route": "cuda",
        "source": "xcorr_tpu_torch/csrc/fused_corr.cu",
        "replaces": "xcorr_tpu/ops/pallas_fft.py:446",
        "launches": main_launches,
        "max_abs_err": k1["err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
