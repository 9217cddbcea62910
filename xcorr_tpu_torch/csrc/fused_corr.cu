// Fused stage-B correlation of the four-step CC (ops/fused_fft.py, K1).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::plan_fused_corr
// (corr_kernel). For one (b, k1) row of the packed stage-A planes:
//
//   C[b,k1,:] = IDFT_N2( DFT_N2(Ax[b,k1,:]*T[k1,:])
//                        * conj(DFT_N2(Ay[b,k1,:]*T[k1,:])) ) * conj(T[k1,:])
//
// in natural n2 order. Layout: ax, ay, out are (B, 2, H, N2) float32 with
// re/im on axis 1; T is (2, H, N2) float32; tw holds the N2/2 inner
// twiddles exp(-2 pi i k / N2), computed on the host in float64.
//
// Design. One block per row holds the x and y rows as complex float32 in
// dynamic shared memory (2 x 64 KB at N2 = 8192) plus the twiddle table
// (32 KB) and runs xcorr::corr_row (fft_row.cuh): radix-2 DIF forward
// (bit-reversed out), the cross spectrum in that order, DIT inverse back
// to natural order, so no permutation pass is needed. Plain float32 FMAs
// on the CUDA cores.
//
// Bound. Per 24 h window (H = 529, N2 = 8192) the kernel reads ~69 MB of
// stage-A planes and up to ~35 MB of T (L2 serves the rows shared by the
// batch) and writes ~35 MB, against ~1 GFLOP: it is memory-bound, so one
// read and one write of each plane is the design target; the spectra
// never leave shared memory.

#include <cuda_runtime.h>

#include "fft_row.cuh"

namespace {

__global__ void __launch_bounds__(xcorr::kRowThreads)
fused_corr_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                  const float* __restrict__ T, const float2* __restrict__ tw,
                  float* __restrict__ out, int H, int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* xs = smem;
  float2* ys = smem + n;
  float2* ws = smem + 2 * n;

  const int row = blockIdx.x;  // b * H + k1
  const int b = row / H;
  const int k1 = row - b * H;
  const size_t re = (static_cast<size_t>(2 * b) * H + k1) * n;
  const size_t im = re + static_cast<size_t>(H) * n;
  const float* t_re = T + static_cast<size_t>(k1) * n;
  const float* t_im = t_re + static_cast<size_t>(H) * n;

  xcorr::load_twiddles(ws, tw, n);
  xcorr::corr_row(ax + re, ax + im, ay + re, ay + im, t_re, t_im, out + re,
                  out + im, xs, ys, ws, n, log2n);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 8192 and contiguous
// float32 buffers of the documented shapes.
extern "C" int xc_fused_corr(const void* ax, const void* ay, const void* T,
                             const void* tw, void* out, int B, int H, int n,
                             int log2n, void* stream) {
  const int smem = static_cast<int>((2 * n + n / 2) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      fused_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_corr_kernel<<<B * H, xcorr::row_threads(n), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ax), static_cast<const float*>(ay),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<float*>(out), H, n, log2n);
  return static_cast<int>(cudaGetLastError());
}
