// The stage-B row chain of the four-step correlation, shared by K1
// (fused_corr.cu), K3 (fused_corr_acc.cu) and K4 (fused_corr_full.cu).
// For one (b, k1) row of the packed stage-A planes:
//
//   C[b,k1,:] = IDFT_N2( DFT_N2(Ax[b,k1,:]*T[k1,:])
//                        * conj(DFT_N2(Ay[b,k1,:]*T[k1,:])) ) * conj(T[k1,:])
//
// in natural n2 order, for every power of two 2 <= N2 <= 16384. Layout:
// ax, ay, out are (B, 2, H, N2) float32 with re/im on axis 1; T is
// (2, H, N2) float32; tw the pass twiddles of fft_reg.cuh, computed on
// the host in float64 (ops/fused_fft.py: _k1_twiddles). out may be ax
// (K4 writes C over its stage-A plane): a block reads each x row before
// it writes that row, and no other block touches it.
//
// Bound. At the pair-day's shape (B = 8, H = 265, N2 = 16384) the chain
// must read 556 MB of planes and 35 MB of T and write 278 MB, 0.259 ms
// at 3.35 TB/s, against 8.2 GFLOP, 0.122 ms at 67 TFLOP/s: it is bound
// by bytes, so each plane is read and written once and nothing else goes
// to device memory.
//
// Design. The transforms are radix passes held in registers
// (fft_reg.cuh): each thread holds 32 elements of the row, 3 passes at
// N2 = 16384 (32 * 32 * 16), 2 exchanges through shared memory between
// them, padded so that no access has a bank conflict. The spectrum of x
// waits in shared memory, in the order of the thread that wrote it,
// while y is transformed; the cross spectrum is formed in registers and
// the inverse runs on it; the last pass stores straight from registers.
// Spectra never reach device memory.
//
// A row of 16384 is 128 KB of complex float32, half of an SM's registers,
// so a block of 512 threads (128 registers each) holds one row, one block
// per SM (210 KB of shared memory: the x spectrum 8 N2 bytes, the
// exchange buffer 4.125 N2 bytes, the pass twiddles); at N2 = 8192 two
// blocks of 256 threads share an SM. Loads that land in registers would
// leave the SM idle, and x, y and T in registers together spill, so
// (the copies and the row order are row_copy.cuh's, which K2 shares):
//
// - blocks are persistent, one wave of them, each looping over rows
//   i, i + G, ... of the k1-major order (row k1 * B + b): the B rows that
//   read one row of T run at the same time and T comes from L2;
// - the next row's x comes into the idle x-spectrum area with cp.async
//   while the current row stores its result;
// - T is staged into shared memory with cp.async (the exchange buffer
//   and the x-spectrum area, half a row each) and multiplied from there:
//   on load it meets x, then y, and conj(T) / N2 meets the result;
// - y is loaded straight into registers (neighbouring threads on
//   neighbouring addresses) while T's first half comes in.
//
// Float32 FMAs on the CUDA cores, no atomics: a rerun gives the same bits.
// The CLOCK instances carry a phase clock (SM cycles per phase of a row),
// which K1's second entry point, xc_fused_corr_phases, runs.
//
// Kernels are per translation unit: each .cu that includes this header
// gets its own copy of the instances it launches.

#pragma once

#include <cuda_runtime.h>

#include "row_copy.cuh"

namespace {

// The phase clock, in the CLOCK instances only: thread 0 of each block
// adds the SM cycles of phase i of its rows to phases[block * 8 + i].
template <bool CLOCK>
__device__ __forceinline__ void tick(long long* phases, long long& clock0,
                                     int i, int t) {
  if constexpr (CLOCK) {
    if (t == 0) {
      const long long now = clock64();
      phases[blockIdx.x * 8 + i] += now - clock0;
      clock0 = now;
    }
  }
}

// ax and out carry no __restrict__: out may be ax.
template <int LG, bool CLOCK>
__global__ void __launch_bounds__(R::threads(LG),
                                  R::threads(LG) >= 512 ? 1 : 2)
fused_corr_kernel(const float* ax, const float* __restrict__ ay,
                  const float* __restrict__ T, const float2* __restrict__ tw,
                  float* out, int B, int H, long long* __restrict__ phases) {
  constexpr int n = 1 << LG, E = R::elems(LG), P = R::threads(LG);
  extern __shared__ float4 smem4[];
  // the x spectrum, element k of thread t at k * P + t; around it, the
  // next row's raw x and staged halves of T
  float2* xs = reinterpret_cast<float2*>(smem4);
  float* tstage = reinterpret_cast<float*>(smem4);
  float2* ws = xs + n;
  float* ex = reinterpret_cast<float*>(ws + R::tw_total(LG));
  const int t = threadIdx.x, G = gridDim.x, rows = B * H;
  const size_t plane = static_cast<size_t>(H) * n;
  auto offset = [&](int row) { return row_offset(row, B, H, n); };
  for (int k = t; k < R::tw_total(LG); k += P) ws[k] = tw[k];
  if (static_cast<int>(blockIdx.x) < rows) {
    const size_t re = offset(blockIdx.x);
    prefetch_x<LG>(tstage, ax, re, re + plane, t);
  }
  long long clock0 = CLOCK ? clock64() : 0;
  for (int row = blockIdx.x; row < rows; row += G) {
    const size_t re = offset(row), im = re + plane;
    const float* t_re = T + static_cast<size_t>(row / B) * n;
    const float* t_im = t_re + plane;
    // x, element j of thread t at t + j * P in the first pass
    copy_async_wait();
    __syncthreads();
    float2 v[E];
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = make_float2(tstage[t + j * P], tstage[n + t + j * P]);
    __syncthreads();
    tick<CLOCK>(phases, clock0, 0, t);  // x in
    stage_t<LG>(ex, t_re, t_im, 0, t);
    stage_t<LG>(tstage, t_re, t_im, 1, t);
    copy_async_wait();
    __syncthreads();
    mul_t<LG>(v, ex, 0, t);
    mul_t<LG>(v, tstage, 1, t);
    __syncthreads();
    tick<CLOCK>(phases, clock0, 1, t);  // x * T
    R::forward<LG>(v, ws, ex, t);
#pragma unroll
    for (int k = 0; k < E; ++k) xs[k * P + t] = v[k];
    tick<CLOCK>(phases, clock0, 2, t);  // forward x

    // y, T through the exchange buffer one half at a time
    stage_t<LG>(ex, t_re, t_im, 0, t);
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = make_float2(ay[re + t + j * P], ay[im + t + j * P]);
    copy_async_wait();
    __syncthreads();
    mul_t<LG>(v, ex, 0, t);
    __syncthreads();
    tick<CLOCK>(phases, clock0, 3, t);  // y in, half of y * T
    stage_t<LG>(ex, t_re, t_im, 1, t);
    copy_async_wait();
    __syncthreads();
    mul_t<LG>(v, ex, 1, t);
    __syncthreads();
    tick<CLOCK>(phases, clock0, 4, t);  // the other half of y * T
    R::forward<LG>(v, ws, ex, t);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = R::cmul_conj(xs[k * P + t], v[k]);
    __syncthreads();  // spectrum read: the next row's x may come in
    tick<CLOCK>(phases, clock0, 5, t);  // forward y, cross spectrum
    R::inverse<LG, R::num_passes(LG) - 1>(v, ws, ex, t);
    tick<CLOCK>(phases, clock0, 6, t);  // inverse
    // after the inverse, whose exchanges would share the SM's shared
    // memory bandwidth with the copy
    if (row + G < rows) {
      const size_t next = offset(row + G);
      prefetch_x<LG>(tstage, ax, next, next + plane, t);
    }

    // conj(T) / n, half a row at a time, and out
    const float scale = 1.0f / static_cast<float>(n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      stage_t<LG>(ex, t_re, t_im, h, t);
      copy_async_wait();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < E / 2; ++j) {
        const int kh = t + j * P, k = kh + h * (n / 2);
        const float2 c = R::cmul_conj(v[h * (E / 2) + j],
                                      make_float2(ex[kh], ex[n / 2 + kh]));
        out[re + k] = c.x * scale;
        out[im + k] = c.y * scale;
      }
      __syncthreads();
    }
    tick<CLOCK>(phases, clock0, 7, t);  // conj(T) / n, out
  }
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       void*, int, int, cudaStream_t, void*);

template <int LG, bool CLOCK>
int launch(const void* ax, const void* ay, const void* T, const void* tw,
           void* out, int B, int H, cudaStream_t stream, void* phases) {
  constexpr int smem = R::smem_bytes(LG);
  int grid = 0;
  const cudaError_t err = one_wave(fused_corr_kernel<LG, CLOCK>,
                                   R::threads(LG), smem, B * H, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_corr_kernel<LG, CLOCK><<<grid, R::threads(LG), smem, stream>>>(
      static_cast<const float*>(ax), static_cast<const float*>(ay),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<float*>(out), B, H, static_cast<long long*>(phases));
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per row length 2^1 .. 2^14, without and with the
// phase clock
template <bool CLOCK>
constexpr Launch kLaunch[] = {
    nullptr,           launch<1, CLOCK>,  launch<2, CLOCK>,
    launch<3, CLOCK>,  launch<4, CLOCK>,  launch<5, CLOCK>,
    launch<6, CLOCK>,  launch<7, CLOCK>,  launch<8, CLOCK>,
    launch<9, CLOCK>,  launch<10, CLOCK>, launch<11, CLOCK>,
    launch<12, CLOCK>, launch<13, CLOCK>, launch<14, CLOCK>};

// The chain over every row of the planes on `stream` (no phase clock);
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// unless n = 2^log2n with 2 <= n <= 16384.
int corr_rows(const void* ax, const void* ay, const void* T, const void* tw,
              void* out, int B, int H, int n, int log2n,
              cudaStream_t stream) {
  if (log2n < 1 || log2n > 14 || n != 1 << log2n)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch<false>[log2n](ax, ay, T, tw, out, B, H, stream, nullptr);
}

}  // namespace
