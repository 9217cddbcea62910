// Moving rows of the packed (B, 2, H, N2) float32 planes between device
// memory, shared memory and the registers of fft_reg.cuh's thread map,
// shared by the row chain of K1, K3 and K4 (corr_rows.cuh) and by the
// split stage B, K2 (stageb.cu).
//
// Blocks are persistent, one wave of them (one_wave), each looping over
// rows i, i + G, ... of the k1-major order (row k1 * B + b, row_offset):
// the B rows that read one row of T run at the same time and T comes
// from L2. Copies into shared memory are cp.async, 16 bytes a thread
// where the row allows it, neighbouring threads on neighbouring
// addresses; they fall back to plain copies when __CUDA_ARCH__ is not
// defined (a host emulation of the kernels).

#pragma once

#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

namespace R = xcorr::reg;

// Asynchronous copy of BYTES (4 or 16) from device to shared memory.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  for (int i = 0; i < BYTES / 4; ++i) dst[i] = src[i];
#endif
}

// 16-byte copy_async that asks L2 to keep the line (evict_last policy
// `keep`, from l2_keep): for T, which the B rows of one k1 read again
// while streamed planes pass through L2.
__device__ __forceinline__ void copy_async_keep(float* dst, const float* src,
                                                unsigned long long keep) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          d),
      "l"(src), "l"(keep)
      : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ unsigned long long l2_keep() {
  unsigned long long policy = 0;
#ifdef __CUDA_ARCH__
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
#endif
  return policy;
}

// Store that marks the line evict-first in L2 (st.global.cs): output
// planes are not read again by the launch.
__device__ __forceinline__ void store_stream(float* p, float v) {
#ifdef __CUDA_ARCH__
  __stcs(p, v);
#else
  *p = v;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Offset of the real part of row k1 * B + b in a (B, 2, H, n) plane.
__device__ __forceinline__ size_t row_offset(int row, int B, int H, int n) {
  const int k1 = row / B;
  return (static_cast<size_t>(2 * (row - k1 * B)) * H + k1) * n;
}

// Start copying positions [h * n / 2, (h + 1) * n / 2) of T's row (the
// real parts, then the imaginary parts: n floats) into dst; KEEP asks L2
// to keep T's lines (copy_async_keep).
template <int LG, bool KEEP = false>
__device__ __forceinline__ void stage_t(float* dst, const float* t_re,
                                        const float* t_im, int h, int t) {
  constexpr int half = (1 << LG) / 2, P = R::threads(LG);
  constexpr int C = half >= 4 ? 4 : 1;  // floats a copy moves
  if constexpr (KEEP && C == 4) {
    const unsigned long long keep = l2_keep();
    for (int c = t * C; c < half; c += P * C) {
      copy_async_keep(dst + c, t_re + h * half + c, keep);
      copy_async_keep(dst + half + c, t_im + h * half + c, keep);
    }
  } else {
    for (int c = t * C; c < half; c += P * C) {
      copy_async<4 * C>(dst + c, t_re + h * half + c);
      copy_async<4 * C>(dst + half + c, t_im + h * half + c);
    }
  }
  copy_async_commit();
}

// v[j] *= T at the thread's positions of half h, staged at st by stage_t.
template <int LG>
__device__ __forceinline__ void mul_t(float2* v, const float* st, int h,
                                      int t) {
  constexpr int E = R::elems(LG), P = R::threads(LG), half = (1 << LG) / 2;
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {
    const int k = t + j * P;
    float2& x = v[h * (E / 2) + j];
    x = R::cmul(x, make_float2(st[k], st[half + k]));
  }
}

// Start copying one x row (n real parts at ax + re, then n imaginary
// parts at ax + im) into dst.
template <int LG>
__device__ __forceinline__ void prefetch_x(float* dst, const float* ax,
                                           size_t re, size_t im, int t) {
  constexpr int n = 1 << LG, P = R::threads(LG), C = n >= 4 ? 4 : 1;
  for (int c = t * C; c < n; c += P * C) {
    copy_async<4 * C>(dst + c, ax + re + c);
    copy_async<4 * C>(dst + n + c, ax + im + c);
  }
  copy_async_commit();
}

// Grid of one wave of resident blocks of `kernel` (`threads` threads,
// `smem` bytes of dynamic shared memory) over `rows` rows, into *grid;
// returns the first CUDA error.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int threads, int smem, int rows,
                     int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *grid = rows < sms * per_sm ? rows : sms * per_sm;
  return err;
}

}  // namespace
