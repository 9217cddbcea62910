// Row transforms of K2 (stageb.cu), the split stage B.
//
// Complex float32 rows of length n = 2^log2n live in shared memory as
// float2 (re, im). The forward transform is in-place radix-2
// decimation-in-frequency (natural order in, bit-reversed order out); the
// inverse is the decimation-in-time mirror (bit-reversed in, natural out),
// so a spectrum never needs a permutation pass between the two. `tw`
// holds the n/2 twiddles exp(-2 pi i k / n). Every function is called by
// the whole block and ends on a barrier. K2 holds one row and the table
// in shared memory and stays at N2 <= 8192 (ops/fused_fft.py: MAX_N2);
// K1, K3 and K4 hold their rows in registers (fft_reg.cuh,
// corr_rows.cuh), and this header serves K2 alone.

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

}  // namespace xcorr
