// Stage B with the pruned inverse DFT folded in (ops/fused_fft.py, K3).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::
// plan_fused_corr_acc (kernel). For every window b:
//
//   out[b, r, :] = sum_{k1 < H} wi[r, k1]   Re C[b,k1,:]
//                             + wi[r, H+k1] Im C[b,k1,:]
//
// with C the K1 correlation rows (fused_corr.cu). Layout: ax, ay are the
// packed (B, 2, H, N2) float32 stage-A planes, T is (2, H, N2), wi the
// (rows_out, 2H) folded inverse matrix, out (B, rows_out, N2).
//
// Design (corr_acc.cuh). Block (s, b) takes the k1 group s of window b:
// for each of its G rows the K1 chain in shared memory, the C rows into
// a device scratch (B, S, 2G, N2), then the product of its 2G columns of
// wi with them, written once to its partial (B, S, rows_out, N2). A
// second launch sums the S partials in ascending s. Blocks run group-
// fastest, so one window's groups share its T and wi rows in L2. The TPU
// kept the accumulator in VMEM over a sequential k1 sweep and needed no
// partials; here no float atomics are used and the result does not
// depend on block order. Not carried: ROWS = 8 (the sublane tile), the
// VMEM gate and the bf16 hi/lo products; every product is float32.
//
// Bound. Per 24 h window (H = 529, N2 = 8192, rows_out = 198): 69.3 MB
// in and 6.5 MB out, ~1 GFLOP of transforms and 3.43 GFLOP of product:
// compute-bound on paper (~0.066 ms at 67 TFLOP/s). The design adds the
// C scratch (34.7 MB written and read) and S partials (S x 6.5 MB
// written and read) per window.

#include <cuda_runtime.h>

#include "corr_acc.cuh"

namespace {

__global__ void __launch_bounds__(xcorr::kAccThreads)
fused_corr_acc_kernel(const float* __restrict__ ax,
                      const float* __restrict__ ay,
                      const float* __restrict__ T,
                      const float2* __restrict__ tw,
                      const float* __restrict__ wi, float* __restrict__ cscr,
                      float* __restrict__ part, int H, int G, int rows_out,
                      int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* ws = smem;
  float2* work = smem + n / 2;

  const int s = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int k0 = s * G;
  const int g = min(G, H - k0);
  const size_t re = (static_cast<size_t>(2 * b) * H + k0) * n;
  const size_t im = re + static_cast<size_t>(H) * n;
  const size_t blk = static_cast<size_t>(b) * S + s;
  float* cs = cscr + blk * 2 * G * n;

  xcorr::load_twiddles(ws, tw, n);
  __syncthreads();
  xcorr::group_corr_acc(ax + re, ax + im, ay + re, ay + im, T, ws, wi, cs,
                        part + blk * rows_out * n, H, k0, g, rows_out, n,
                        log2n, work);
}

}  // namespace

// Launch on `stream`; return the first CUDA error (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 8192, S = ceil(H / G),
// contiguous float32 buffers of the documented shapes, cscr of
// B*S*2G*n floats and part of B*S*rows_out*n floats.
extern "C" int xc_fused_corr_acc(const void* ax, const void* ay,
                                 const void* T, const void* tw,
                                 const void* wi, void* cscr, void* part,
                                 void* out, int B, int H, int G, int S,
                                 int rows_out, int n, int log2n,
                                 void* stream) {
  const int smem = xcorr::acc_smem_bytes(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_corr_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_corr_acc_kernel<<<dim3(S, B), xcorr::kAccThreads, smem, st>>>(
      static_cast<const float*>(ax), static_cast<const float*>(ay),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<const float*>(wi), static_cast<float*>(cscr),
      static_cast<float*>(part), H, G, rows_out, n, log2n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return xcorr::launch_sum_partials(
      static_cast<const float*>(part), static_cast<float*>(out), B, S,
      static_cast<size_t>(rows_out) * n, st);
}
