"""Where the time of K2 (``xcorr_tpu_torch/csrc/stageb.cu``) goes, on one
CUDA card.

Run from the repository root::

    python3 tools/k2_variants.py

Builds variants of ``stageb.cu`` side by side (one ``nvcc`` each, all
started together, into ``build/k2_variants/``), each a shared library
with K2's C entry points, and times their forward and inverse launches
in turns (median of 20 CUDA-event timings per turn, four turns, the
order reversed every other turn) at the pair-day's shape
(8, 2, 265, 16384) and at (8, 2, 529, 8192):

- ``as built``: ``stageb.cu`` as it is;
- ``no L2 hints``: T's copies without the evict-last policy and plain
  output stores instead of streaming ones;
- ``rows in chunks``: each block takes a contiguous run of rows of the
  k1-major order (so it reads each T row up to B times in a row)
  instead of every G-th row;
- ``no T``: without staging and multiplying T (a wrong result, for
  timing only);
- ``no transform``: without the radix passes (a wrong result, for
  timing only).

The variants that compute K2's function are held to the plain versions
(1e-6 of their max) before they are timed. Prints the card's name and
power limit first.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from xcorr_tpu_torch.ops import _build  # noqa: E402
from xcorr_tpu_torch.ops import fused_fft as ff  # noqa: E402

OUT = os.path.join("build", "k2_variants")


def edit(src, pairs):
    for old, new in pairs:
        if old not in src:
            sys.exit(f"stageb.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants():
    src = (_build._CSRC / "stageb.cu").read_text()
    no_hints = edit(src, [
        ("stage_t<LG, true>(", "stage_t<LG>("),
        ("store_stream(out + re + k * P + t, v[k].x);",
         "out[re + k * P + t] = v[k].x;"),
        ("store_stream(out + im + k * P + t, v[k].y);",
         "out[im + k * P + t] = v[k].y;"),
        ("store_stream(out + re + k, c.x * scale);",
         "out[re + k] = c.x * scale;"),
        ("store_stream(out + im + k, c.y * scale);",
         "out[im + k] = c.y * scale;")])
    chunks = edit(src, [
        ("  if (static_cast<int>(blockIdx.x) < rows) {\n"
         "    const size_t re = row_offset(blockIdx.x, B, H, n);",
         "  const int lo = static_cast<int>(1LL * blockIdx.x * rows / G);\n"
         "  const int hi = static_cast<int>(1LL * (blockIdx.x + 1) * rows"
         " / G);\n"
         "  if (lo < hi) {\n"
         "    const size_t re = row_offset(lo, B, H, n);"),
        ("for (int row = blockIdx.x; row < rows; row += G) {",
         "for (int row = lo; row < hi; ++row) {"),
        ("const bool more = row + G < rows;",
         "const bool more = row + 1 < hi;"),
        ("row_offset(row + G, B, H, n)", "row_offset(row + 1, B, H, n)")])
    no_t = edit(src, [
        ("      stage_t<LG, true>(ex, t_re, t_im, 0, t);\n"
         "      stage_t<LG, true>(xin, t_re, t_im, 1, t);\n"
         "      copy_async_wait();\n"
         "      __syncthreads();\n"
         "      mul_t<LG>(v, ex, 0, t);\n"
         "      mul_t<LG>(v, xin, 1, t);\n", ""),
        ("      stage_t<LG, true>(xin, t_re, t_im, 0, t);\n"
         "      stage_t<LG, true>(xin + n, t_re, t_im, 1, t);\n", ""),
        ("R::cmul_conj(v[h * (E / 2) + j],\n"
         "                                        make_float2(st[kh], "
         "st[n / 2 + kh]))", "v[h * (E / 2) + j]")])
    no_transform = edit(src, [
        ("      R::forward<LG>(v, ws, ex, t);\n", ""),
        ("      R::inverse<LG, R::num_passes(LG) - 1>(v, ws, ex, t);\n",
         "")])
    return {"as built": (src, True), "no L2 hints": (no_hints, True),
            "rows in chunks": (chunks, True), "no T": (no_t, False),
            "no transform": (no_transform, False)}


def build(found):
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for i, (name, (src, _)) in enumerate(found.items()):
        d = os.path.join(OUT, str(i))
        os.makedirs(d)
        for h in _build._CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        with open(os.path.join(d, "stageb.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "stageb.cu")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for i, (name, p) in enumerate(procs.items()):
        err = p.communicate()[1]
        if p.returncode:
            sys.exit(f"nvcc of {name} failed: {err[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, str(i), "lib.so"))
        for fn, sig in (("xc_stageb_fwd", "ppppiiiip"),
                        ("xc_stageb_inv", "pppppiiiiip")):
            getattr(lib, fn).argtypes = [
                ctypes.c_void_p if k == "p" else ctypes.c_int for k in sig]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    found = variants()
    libs = build(found)
    for B, H, N2 in [(8, 265, 16384), (8, 529, 8192)]:
        lg = N2.bit_length() - 1
        d = cs.kernel_inputs(B, H, N2, 8, 5, cs.SEED)
        ax, ay, T = d["ax"], d["ay"], d["T"]
        tw = ff._k1_twiddles(N2, ax.device)
        f, g = ff.stageb_fwd_plain(ax, T), ff.stageb_fwd_plain(ay, T)
        c = ff.stageb_inv_plain(f, g, T)
        out = torch.empty_like(ax)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {
            "fwd": (lambda lib: lib.xc_stageb_fwd(
                ax.data_ptr(), T.data_ptr(), tw.data_ptr(), out.data_ptr(),
                B, H, N2, lg, stream), f, nbytes_bound(ax, T)),
            "inv": (lambda lib: lib.xc_stageb_inv(
                f.data_ptr(), g.data_ptr(), T.data_ptr(), tw.data_ptr(),
                out.data_ptr(), B, H, N2, lg, 1, stream), c,
                nbytes_bound(f, g, T))}
        for which, (call, want, bound_ms) in calls.items():
            for name, lib in libs.items():
                if call(lib) != 0:
                    sys.exit(f"{name} {which}: launch failed")
                torch.cuda.synchronize()
                if found[name][1]:
                    rel = ((out - want).abs().max()
                           / want.abs().max()).item()
                    if rel > cs.K2_RTOL:
                        sys.exit(f"{name} {which}: rel err {rel}")
            times = {name: [] for name in libs}
            for turn in range(4):
                order = list(libs)[::(-1) ** turn]
                for name in order:
                    times[name].append(cs.median_ms(lambda: call(libs[name])))
            for name, ts in times.items():
                med = float(np.median(ts))
                print(f"({B}, 2, {H}, {N2}) {which} {name}: "
                      + " ".join(f"{t:.4f}" for t in ts)
                      + f" ms, median {med:.4f} ms, "
                        f"{100 * bound_ms / med:.1f}% of the bytes bound "
                        f"{bound_ms:.4f} ms", flush=True)
        del d, ax, ay, T, f, g, c, out
        torch.cuda.empty_cache()


def nbytes_bound(*inputs):
    """Bytes bound (ms) of a K2 launch: the inputs read once, one plane
    written once, at the card's HBM rate."""
    plane = inputs[0].numel() * 4
    return (cs.nbytes(*inputs) + plane) / cs.HBM_BPS * 1e3


if __name__ == "__main__":
    main()
