// Stage B with the pruned inverse DFT folded in (ops/fused_fft.py, K3).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::
// plan_fused_corr_acc (kernel). For every window b:
//
//   out[b, r, :] = sum_{k1 < H} wi[r, k1]   Re C[b,k1,:]
//                             + wi[r, H+k1] Im C[b,k1,:]
//
// with C the K1 correlation rows. Layout: ax, ay are the packed
// (B, 2, H, N2) float32 stage-A planes, T is (2, H, N2), wi the
// (rows_out, 2H) folded inverse matrix, out (B, rows_out, N2).
//
// Bound. At the pair-day's shape (B = 8, H = 265, N2 = 16384, rows_out =
// 99): 591 MB in and 52 MB out, 0.192 ms at 3.35 TB/s; 8.2 GFLOP of
// transforms (0.122 ms at 67 TFLOP/s) and 13.75 GFLOP of product (0.083
// ms as three TF32 passes at 495 TFLOP/s): bound by bytes.
//
// Design. Launches in stream order:
//
// 1. the row chain of corr_rows.cuh (K1's: rows in registers, N2 up to
//    16384) writes C into cscr, a scratch of the planes' shape: the only
//    device scratch, one plane of 2 H N2 floats per window (278 MB per
//    pair-day);
// 2. the split-TF32 product of gemm_tf32.cu, out[b] = wi @ C[b] over the
//    packed axis (wi split into hi and lo first, in `split`, 420 KB):
//    each output is one complete sum in ascending k, of three TF32
//    passes (precision 'high') or one (passes = 1: precision 'default').
//
// The TPU kept the (rows_out, N2) accumulator in VMEM over a sequential
// k1 sweep. A Hopper SM has 227 KB of shared memory, and a window's C
// (34.7 MB) or accumulator (6.5 MB) outgrows even a 16-block cluster's,
// so one of them passes through device memory. C does: its round trip
// (556 MB, 0.166 ms) is what the design adds to the bound, and it keeps
// every sum in one block, in order, with no partial planes and no
// atomics: two launches on the same inputs give the same bits. Not
// carried: ROWS = 8 (the sublane tile) and the VMEM gate.

#include <cuda_runtime.h>

#include "corr_rows.cuh"
#include "gemm_tf32.cuh"

// Launch on `stream`; return the first CUDA error (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 16384, tw from
// _k1_twiddles(n), contiguous float32 buffers of the documented shapes,
// cscr of the planes' shape and split of split_floats(rows_out, 2H)
// floats; passes is the product's TF32 passes, 1 or 3.
extern "C" int xc_fused_corr_acc(const void* ax, const void* ay,
                                 const void* T, const void* tw,
                                 const void* wi, void* cscr, void* split,
                                 void* out, int B, int H, int rows_out,
                                 int n, int log2n, int passes,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(split);
  int err = corr_rows(ax, ay, T, tw, cscr, B, H, n, log2n, st);
  if (err == 0)
    err = xcorr::split_tf32(static_cast<const float*>(wi), rows_out, 2 * H,
                            sp, st);
  if (err != 0) return err;
  return xcorr::gemm_tf32(sp, rows_out, 2 * H,
                          static_cast<const float*>(cscr),
                          2 * static_cast<size_t>(H) * n,
                          static_cast<float*>(out),
                          static_cast<size_t>(rows_out) * n, n, B, passes,
                          st);
}
