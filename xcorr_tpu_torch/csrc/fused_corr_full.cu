// The whole four-step correlation from the windows (ops/fused_fft.py, K4).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::
// plan_fused_corr_full (kernel): stage A, the stage-B correlation and the
// pruned inverse. For every window b:
//
//   Ax[b] = w1 @ vx[b],  Ay[b] = w1 @ vy[b]     (2H, N2), re rows then im
//   out[b] = wi @ K1(Ax[b], Ay[b], T)           (rows_out, N2)
//
// Layout: vx, vy are the zero-padded windows viewed (B, rows_in, N2)
// float32; w1 is the (2H, rows_in) stage-A matrix, T (2, H, N2), wi the
// (rows_out, 2H) folded inverse matrix, out (B, rows_out, N2).
//
// Bound. At the pair-day's shape (B = 8, rows_in = 264, H = 265,
// N2 = 16384, rows_out = 99): 312 MB in and 52 MB out, 0.109 ms at
// 3.35 TB/s; 8.2 GFLOP of transforms (0.122 ms at 67 TFLOP/s); 73.4
// GFLOP of stage A and 13.75 of pruned inverse, 0.528 ms as three TF32
// passes at 495 TFLOP/s: bound by the products.
//
// Design. Launches in stream order:
//
// 1-2. stage A, the split-TF32 product of gemm_tf32.cu, w1 @ v[b] for
//      each signal into sx and sy, (B, 2H, N2) each: the packed
//      (B, 2, H, N2) planes (w1 split into hi and lo first, in `split`);
// 3.   the row chain of corr_rows.cuh (K1's), C written over sx;
// 4.   the pruned inverse, wi @ C[b] into out (wi split into `split`
//      in turn), as K3's second launch.
//
// Both products run three TF32 passes (precision 'high') or one
// (passes = 1: precision 'default').
//
// The device scratch is sx and sy, two planes of 2 H N2 floats per
// window (556 MB per pair-day). What bounds this design: stage A's
// output comes out of the products in MMA fragments, a tile of rows by
// columns, while a transform wants a whole row of N2 in fft_reg.cuh's
// thread map, i.e. the product of its w1 row with every column of the
// window. The product reads the window (17.3 MB per signal) once only
// when the row tiles of one column slab run together (gemm_tf32.cu's
// block order), so a row of Ax is complete only when the sweep over the
// window's columns ends, and one window's stage-A planes for both
// signals (69.5 MB) outgrow the 50 MB L2. They pass through device
// memory: 556 MB written and read back, 0.33 ms at 3.35 TB/s beside the
// products' 0.528. Not carried: ROWS = 8 and the VMEM gate; the TPU's
// bf16 hi/lo split becomes the TF32 one.

#include <cuda_runtime.h>

#include "corr_rows.cuh"
#include "gemm_tf32.cuh"

// Launch on `stream`; return the first CUDA error (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 16384, tw from
// _k1_twiddles(n), contiguous float32 buffers of the documented shapes,
// sx and sy of B * 2H * n floats each and split of the larger of
// split_floats(2H, rows_in) and split_floats(rows_out, 2H) floats;
// passes is the products' TF32 passes, 1 or 3.
extern "C" int xc_fused_corr_full(const void* vx, const void* vy,
                                  const void* w1, const void* T,
                                  const void* tw, const void* wi, void* sx,
                                  void* sy, void* split, void* out, int B,
                                  int H, int rows_in, int rows_out, int n,
                                  int log2n, int passes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (log2n < 1 || log2n > 14 || n != 1 << log2n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t window = static_cast<size_t>(rows_in) * n;
  const size_t plane = 2 * static_cast<size_t>(H) * n;
  float* sp = static_cast<float*>(split);
  int err = xcorr::split_tf32(static_cast<const float*>(w1), 2 * H, rows_in,
                              sp, st);
  for (int sig = 0; sig < 2 && err == 0; ++sig)
    err = xcorr::gemm_tf32(sp, 2 * H, rows_in,
                           static_cast<const float*>(sig ? vy : vx), window,
                           static_cast<float*>(sig ? sy : sx), plane, n, B,
                           passes, st);
  if (err == 0) err = corr_rows(sx, sy, T, tw, sx, B, H, n, log2n, st);
  if (err == 0)
    err = xcorr::split_tf32(static_cast<const float*>(wi), rows_out, 2 * H,
                            sp, st);
  if (err != 0) return err;
  return xcorr::gemm_tf32(sp, rows_out, 2 * H,
                          static_cast<const float*>(sx), plane,
                          static_cast<float*>(out),
                          static_cast<size_t>(rows_out) * n, n, B, passes,
                          st);
}
