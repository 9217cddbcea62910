// Row transforms shared by the stage-B kernels (K1-K4).
//
// Complex float32 rows of length n = 2^log2n live in shared memory as
// float2 (re, im). The forward transform is in-place radix-2
// decimation-in-frequency (natural order in, bit-reversed order out); the
// inverse is the decimation-in-time mirror (bit-reversed in, natural out),
// so a spectrum never needs a permutation pass between the two. `tw`
// holds the n/2 twiddles exp(-2 pi i k / n). Every function is called by
// the whole block and ends on a barrier.

#pragma once

#include <cuda_runtime.h>

namespace xcorr {

constexpr int kRowThreads = 1024;  // most threads of a one-row block

// Threads of a block that transforms one row of n: one per butterfly, a
// whole warp at least.
inline int row_threads(int n) {
  return n / 2 < kRowThreads ? (n / 2 < 32 ? 32 : n / 2) : kRowThreads;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// In-place DIF FFT of one row. Stage s pairs i and i + h, h = n >> (s + 1),
// with twiddle W_{2h}^j = tw[j << s].
__device__ inline void dif_fft(float2* x, const float2* tw, int n,
                               int log2n) {
  for (int s = 0; s < log2n; ++s) {
    const int lh = log2n - 1 - s;  // log2(h)
    const int h = 1 << lh;
    for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
      const int j = t & (h - 1);
      const int i = ((t >> lh) << (lh + 1)) + j;
      const float2 u = x[i], v = x[i + h];
      x[i] = make_float2(u.x + v.x, u.y + v.y);
      x[i + h] = cmul(make_float2(u.x - v.x, u.y - v.y), tw[j << s]);
    }
    __syncthreads();
  }
}

// dif_fft of two rows at once (one barrier per stage for both).
__device__ inline void dif_fft2(float2* x, float2* y, const float2* tw,
                                int n, int log2n) {
  for (int s = 0; s < log2n; ++s) {
    const int lh = log2n - 1 - s;
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

// In-place DIT inverse FFT, unscaled: the stages of dif_fft in reverse
// order with conjugate twiddles.
__device__ inline void dit_ifft(float2* x, const float2* tw, int n,
                                int log2n) {
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

// Load the n/2 twiddles into shared memory (the caller syncs).
__device__ __forceinline__ void load_twiddles(float2* ws, const float2* tw,
                                              int n) {
  for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) ws[k] = tw[k];
}

// The whole stage-B correlation of one row:
//
//   c = IDFT( DFT(x*t) * conj(DFT(y*t)) ) * conj(t) / n
//
// x, y, t and c are split re/im rows in device memory; c may alias x or
// y (each element is read before the first barrier and written after the
// last). xs and ys are n-element shared rows, ws the loaded twiddles.
__device__ inline void corr_row(const float* xr, const float* xi,
                                const float* yr, const float* yi,
                                const float* tr, const float* ti, float* cr,
                                float* ci, float2* xs, float2* ys,
                                const float2* ws, int n, int log2n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 t = make_float2(tr[k], ti[k]);
    xs[k] = cmul(make_float2(xr[k], xi[k]), t);
    ys[k] = cmul(make_float2(yr[k], yi[k]), t);
  }
  __syncthreads();

  dif_fft2(xs, ys, ws, n, log2n);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = cmul_conj(xs[k], ys[k]);
  __syncthreads();
  dit_ifft(xs, ws, n, log2n);

  const float scale = 1.0f / static_cast<float>(n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 c = cmul_conj(xs[k], make_float2(tr[k], ti[k]));
    cr[k] = c.x * scale;
    ci[k] = c.y * scale;
  }
  __syncthreads();
}

}  // namespace xcorr
