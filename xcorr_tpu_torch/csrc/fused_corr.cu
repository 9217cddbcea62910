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
// (32 KB). The forward transforms are in-place radix-2
// decimation-in-frequency, whose output is bit-reversed; the cross
// spectrum is formed in that order, and a decimation-in-time inverse
// takes it back to natural order, so no permutation pass is needed.
// Plain float32 FMAs on the CUDA cores.
//
// Bound. Per 24 h window (H = 529, N2 = 8192) the kernel reads ~69 MB of
// stage-A planes and up to ~35 MB of T (L2 serves the rows shared by the
// batch) and writes ~35 MB, against ~1 GFLOP: it is memory-bound, so one
// read and one write of each plane is the design target; the spectra
// never leave shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// In-place radix-2 decimation-in-frequency FFT of two rows at once
// (natural order in, bit-reversed order out). Stage s pairs i and i + h,
// h = n >> (s + 1), with twiddle W_{2h}^j = tw[j << s].
__device__ void dif_fft2(float2* x, float2* y, const float2* tw, int n,
                         int log2n) {
  for (int s = 0; s < log2n; ++s) {
    const int lh = log2n - 1 - s;  // log2(h)
    const int h = 1 << lh;
    for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
      const int j = t & (h - 1);
      const int i = ((t >> lh) << (lh + 1)) + j;
      const float2 w = tw[j << s];
      float2 u = x[i], v = x[i + h];
      x[i] = make_float2(u.x + v.x, u.y + v.y);
      x[i + h] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
      u = y[i];
      v = y[i + h];
      y[i] = make_float2(u.x + v.x, u.y + v.y);
      y[i + h] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
    }
    __syncthreads();
  }
}

// In-place radix-2 decimation-in-time inverse FFT, unscaled (bit-reversed
// order in, natural order out): the stages of dif_fft2 in reverse order
// with conjugate twiddles.
__device__ void dit_ifft(float2* x, const float2* tw, int n, int log2n) {
  for (int s = log2n - 1; s >= 0; --s) {
    const int lh = log2n - 1 - s;
    const int h = 1 << lh;
    for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
      const int j = t & (h - 1);
      const int i = ((t >> lh) << (lh + 1)) + j;
      const float2 u = x[i];
      const float2 v = cmul_conj(x[i + h], tw[j << s]);
      x[i] = make_float2(u.x + v.x, u.y + v.y);
      x[i + h] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
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

  for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) ws[k] = tw[k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 t = make_float2(t_re[k], t_im[k]);
    xs[k] = cmul(make_float2(ax[re + k], ax[im + k]), t);
    ys[k] = cmul(make_float2(ay[re + k], ay[im + k]), t);
  }
  __syncthreads();

  dif_fft2(xs, ys, ws, n, log2n);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = cmul_conj(xs[k], ys[k]);
  __syncthreads();
  dit_ifft(xs, ws, n, log2n);

  const float scale = 1.0f / static_cast<float>(n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 t = make_float2(t_re[k], t_im[k]);
    const float2 c = cmul_conj(xs[k], t);
    out[re + k] = c.x * scale;
    out[im + k] = c.y * scale;
  }
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
  const int threads = n / 2 < kThreads ? (n / 2 < 32 ? 32 : n / 2) : kThreads;
  fused_corr_kernel<<<B * H, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ax), static_cast<const float*>(ay),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<float*>(out), H, n, log2n);
  return static_cast<int>(cudaGetLastError());
}
