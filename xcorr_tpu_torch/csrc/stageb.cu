// Split stage B of the four-step CC, as two launches (ops/fused_fft.py, K2).
//
// Replaces the Pallas kernels of xcorr_tpu/ops/pallas_fft.py::
// plan_fused_stageb: fwd_kernel (forward chain of one signal) and
// inv_kernel (cross spectrum, inverse chain, conjugate twiddle). For one
// (b, k1) row of the packed (B, 2, H, N2) float32 planes:
//
//   fwd:  F[b,k1,:] = DFT_N2(A[b,k1,:] * T[k1,:])       bit-reversed order
//   inv:  C[b,k1,:] = IDFT_N2(Fx[b,k1,:] * conj(Fy[b,k1,:])) * conj(T[k1,:])
//                                                        natural order
//
// The spectrum stays in the radix-2 DIF output order (bit-reversed n2),
// which the DIT inverse takes as it is; the TPU kernel's spectrum was in
// its own (k_p, k_q) order. fwd twice and inv once is K1 (fused_corr.cu)
// with the two spectra written to and read back from device memory.
//
// Design. One block per row, the row in dynamic shared memory (64 KB at
// N2 = 8192) beside the twiddle table (32 KB). The transforms are
// fft_row.cuh's radix-2 stages.
//
// Bound. Memory: per 24 h window (H = 529, N2 = 8192) fwd reads 34.7 MB
// and writes 34.7 MB per signal, inv reads 69.3 MB and writes 34.7 MB
// (T, 34.7 MB, is read again for each window of a batch unless L2 holds
// it), against ~0.3 GFLOP per transform.

#include <cuda_runtime.h>

#include "fft_row.cuh"

namespace {

__global__ void __launch_bounds__(xcorr::kRowThreads)
stageb_fwd_kernel(const float* __restrict__ a, const float* __restrict__ T,
                  const float2* __restrict__ tw, float* __restrict__ out,
                  int H, int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* xs = smem;
  float2* ws = smem + n;

  const int row = blockIdx.x;  // b * H + k1
  const int b = row / H;
  const int k1 = row - b * H;
  const size_t re = (static_cast<size_t>(2 * b) * H + k1) * n;
  const size_t im = re + static_cast<size_t>(H) * n;
  const float* t_re = T + static_cast<size_t>(k1) * n;
  const float* t_im = t_re + static_cast<size_t>(H) * n;

  xcorr::load_twiddles(ws, tw, n);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = xcorr::cmul(make_float2(a[re + k], a[im + k]),
                        make_float2(t_re[k], t_im[k]));
  __syncthreads();
  xcorr::dif_fft(xs, ws, n, log2n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    out[re + k] = xs[k].x;
    out[im + k] = xs[k].y;
  }
}

__global__ void __launch_bounds__(xcorr::kRowThreads)
stageb_inv_kernel(const float* __restrict__ fx, const float* __restrict__ fy,
                  const float* __restrict__ T, const float2* __restrict__ tw,
                  float* __restrict__ out, int H, int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* xs = smem;
  float2* ws = smem + n;

  const int row = blockIdx.x;
  const int b = row / H;
  const int k1 = row - b * H;
  const size_t re = (static_cast<size_t>(2 * b) * H + k1) * n;
  const size_t im = re + static_cast<size_t>(H) * n;
  const float* t_re = T + static_cast<size_t>(k1) * n;
  const float* t_im = t_re + static_cast<size_t>(H) * n;

  xcorr::load_twiddles(ws, tw, n);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = xcorr::cmul_conj(make_float2(fx[re + k], fx[im + k]),
                             make_float2(fy[re + k], fy[im + k]));
  __syncthreads();
  xcorr::dit_ifft(xs, ws, n, log2n);
  const float scale = 1.0f / static_cast<float>(n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 c =
        xcorr::cmul_conj(xs[k], make_float2(t_re[k], t_im[k]));
    out[re + k] = c.x * scale;
    out[im + k] = c.y * scale;
  }
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 8192 and contiguous
// float32 buffers of the documented shapes.
extern "C" int xc_stageb_fwd(const void* a, const void* T, const void* tw,
                             void* out, int B, int H, int n, int log2n,
                             void* stream) {
  const int smem = static_cast<int>((n + n / 2) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      stageb_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stageb_fwd_kernel<<<B * H, xcorr::row_threads(n), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(T),
      static_cast<const float2*>(tw), static_cast<float*>(out), H, n, log2n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xc_stageb_inv(const void* fx, const void* fy, const void* T,
                             const void* tw, void* out, int B, int H, int n,
                             int log2n, void* stream) {
  const int smem = static_cast<int>((n + n / 2) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      stageb_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stageb_inv_kernel<<<B * H, xcorr::row_threads(n), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<float*>(out), H, n, log2n);
  return static_cast<int>(cudaGetLastError());
}
