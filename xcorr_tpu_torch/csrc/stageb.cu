// Split stage B of the four-step CC, as two launches (ops/fused_fft.py, K2).
//
// Replaces the Pallas kernels of xcorr_tpu/ops/pallas_fft.py::
// plan_fused_stageb: fwd_kernel (forward chain of one signal) and
// inv_kernel (cross spectrum, inverse chain, conjugate twiddle). For one
// (b, k1) row of the packed (B, 2, H, N2) float32 planes:
//
//   fwd:  F[b,k1,:] = DFT_N2(A[b,k1,:] * T[k1,:])     in the thread order
//   inv:  C[b,k1,:] = IDFT_N2(Fx[b,k1,:] * conj(Fy[b,k1,:])) * conj(T[k1,:])
//                                                      natural order
//
// for every power of two 2 <= N2 <= 16384. This is K1's row chain
// (corr_rows.cuh) split at the cross spectrum, on the same register
// passes (fft_reg.cuh) and the same row copies (row_copy.cuh); tw is the
// host float64 pass-twiddle table of ops/fused_fft.py: _k1_twiddles.
//
// Spectrum order. fwd stores each thread's registers as it holds them
// after the last forward pass: element k of thread t at position
// k * P + t (P threads), so a warp's stores are coalesced. That is the
// passes' digit-reversed order (ops/fused_fft.py: spectrum_order gives
// the frequency at each position); inv loads its two spectra at the same
// positions, which is the order its first inverse pass takes, and the
// TPU kernel's spectrum was in its own (k_p, k_q) order.
//
// Bound. At the pair-day's shape (B = 8, H = 265, N2 = 16384) fwd reads
// 278 MB of planes and 35 MB of T and writes 278 MB, 0.176 ms at
// 3.35 TB/s; inv reads 556 + 35 MB and writes 278 MB, 0.259 ms; each
// does one transform, 2.4 GFLOP, 0.04 ms at 67 TFLOP/s: both are bound
// by bytes. So each plane is read and written once and T comes from L2.
//
// Design (K1's, for one transform). A row of 16384 lives in the
// registers of a block of 512 threads, one block per SM; blocks are
// persistent and take rows in k1-major order. fwd: the next row's input
// comes into shared memory with cp.async while the current row is
// transformed and stored; T is staged through shared memory. inv: fy is
// loaded straight into registers and meets fx, prefetched into shared
// memory; T is staged while the inverse runs, and the next row's fx is
// prefetched once the output is stored. T's copies ask L2 to keep its
// lines and the outputs are streaming stores (row_copy.cuh), so the B
// reads of a T row hit L2 while the planes stream past: 9% off fwd at
// the pair-day's shape on the H100 (tools/k2_variants.py). Float32 FMAs,
// no atomics: a rerun gives the same bits.

#include <cuda_runtime.h>

#include "row_copy.cuh"

namespace {

// INV false: fwd of x (y unused). INV true: inv of the spectra x, y;
// y holds B windows, or one that every window reads (y_all = 0).
template <int LG, bool INV>
__global__ void __launch_bounds__(R::threads(LG),
                                  R::threads(LG) >= 512 ? 1 : 2)
stageb_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ T, const float2* __restrict__ tw,
              float* __restrict__ out, int B, int H, int y_all) {
  constexpr int n = 1 << LG, E = R::elems(LG), P = R::threads(LG);
  extern __shared__ float4 smem4[];
  // the next row's input (2n floats), then T; the pass twiddles; the
  // exchange buffer
  float* xin = reinterpret_cast<float*>(smem4);
  float2* ws = reinterpret_cast<float2*>(smem4) + n;
  float* ex = reinterpret_cast<float*>(ws + R::tw_total(LG));
  const int t = threadIdx.x, G = gridDim.x, rows = B * H;
  const size_t plane = static_cast<size_t>(H) * n;
  for (int k = t; k < R::tw_total(LG); k += P) ws[k] = tw[k];
  if (static_cast<int>(blockIdx.x) < rows) {
    const size_t re = row_offset(blockIdx.x, B, H, n);
    prefetch_x<LG>(xin, x, re, re + plane, t);
  }
  for (int row = blockIdx.x; row < rows; row += G) {
    const size_t re = row_offset(row, B, H, n), im = re + plane;
    const float* t_re = T + static_cast<size_t>(row / B) * n;
    const float* t_im = t_re + plane;
    const bool more = row + G < rows;
    const size_t next = more ? row_offset(row + G, B, H, n) : 0;
    copy_async_wait();
    __syncthreads();
    float2 v[E];
    if constexpr (!INV) {
      // a, element j of thread t at t + j * P in the first pass, times T
#pragma unroll
      for (int j = 0; j < E; ++j)
        v[j] = make_float2(xin[t + j * P], xin[n + t + j * P]);
      __syncthreads();
      stage_t<LG, true>(ex, t_re, t_im, 0, t);
      stage_t<LG, true>(xin, t_re, t_im, 1, t);
      copy_async_wait();
      __syncthreads();
      mul_t<LG>(v, ex, 0, t);
      mul_t<LG>(v, xin, 1, t);
      __syncthreads();
      if (more) prefetch_x<LG>(xin, x, next, next + plane, t);
      R::forward<LG>(v, ws, ex, t);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        store_stream(out + re + k * P + t, v[k].x);
        store_stream(out + im + k * P + t, v[k].y);
      }
    } else {
      // fy from device memory, fx from shared memory, both at k * P + t
      const size_t yre = y_all ? re : static_cast<size_t>(row / B) * n;
      const size_t yim = yre + plane;
#pragma unroll
      for (int k = 0; k < E; ++k)
        v[k] = make_float2(y[yre + k * P + t], y[yim + k * P + t]);
#pragma unroll
      for (int k = 0; k < E; ++k)
        v[k] = R::cmul_conj(make_float2(xin[k * P + t], xin[n + k * P + t]),
                            v[k]);
      __syncthreads();
      // T's two halves come in while the inverse runs
      stage_t<LG, true>(xin, t_re, t_im, 0, t);
      stage_t<LG, true>(xin + n, t_re, t_im, 1, t);
      R::inverse<LG, R::num_passes(LG) - 1>(v, ws, ex, t);
      copy_async_wait();
      __syncthreads();
      const float scale = 1.0f / static_cast<float>(n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* st = xin + h * n;
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          const int kh = t + j * P, k = kh + h * (n / 2);
          const float2 c = R::cmul_conj(v[h * (E / 2) + j],
                                        make_float2(st[kh], st[n / 2 + kh]));
          store_stream(out + re + k, c.x * scale);
          store_stream(out + im + k, c.y * scale);
        }
      }
      __syncthreads();  // T read: the next row's fx may come in
      if (more) prefetch_x<LG>(xin, x, next, next + plane, t);
    }
  }
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       void*, int, int, int, cudaStream_t);

template <int LG, bool INV>
int launch(const void* x, const void* y, const void* T, const void* tw,
           void* out, int B, int H, int y_all, cudaStream_t stream) {
  constexpr int smem = R::smem_bytes(LG);
  int grid = 0;
  const cudaError_t err = one_wave(stageb_kernel<LG, INV>, R::threads(LG),
                                   smem, B * H, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  stageb_kernel<LG, INV><<<grid, R::threads(LG), smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(T), static_cast<const float2*>(tw),
      static_cast<float*>(out), B, H, y_all);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per row length 2^1 .. 2^14
template <bool INV>
constexpr Launch kLaunch[] = {
    nullptr,          launch<1, INV>,  launch<2, INV>,  launch<3, INV>,
    launch<4, INV>,   launch<5, INV>,  launch<6, INV>,  launch<7, INV>,
    launch<8, INV>,   launch<9, INV>,  launch<10, INV>, launch<11, INV>,
    launch<12, INV>,  launch<13, INV>, launch<14, INV>};

template <bool INV>
int stageb(const void* x, const void* y, const void* T, const void* tw,
           void* out, int B, int H, int n, int log2n, int y_all,
           void* stream) {
  if (log2n < 1 || log2n > 14 || n != 1 << log2n)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch<INV>[log2n](x, y, T, tw, out, B, H, y_all,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue unless n = 2^log2n with 2 <= n <= 16384. The
// caller guarantees tw from _k1_twiddles(n) and contiguous float32
// buffers of the documented shapes. inv: fy_all = 1 when fy holds B
// windows, 0 when it holds one that every window of fx reads.
extern "C" int xc_stageb_fwd(const void* a, const void* T, const void* tw,
                             void* out, int B, int H, int n, int log2n,
                             void* stream) {
  return stageb<false>(a, nullptr, T, tw, out, B, H, n, log2n, 1, stream);
}

extern "C" int xc_stageb_inv(const void* fx, const void* fy, const void* T,
                             const void* tw, void* out, int B, int H, int n,
                             int log2n, int fy_all, void* stream) {
  return stageb<true>(fx, fy, T, tw, out, B, H, n, log2n, fy_all, stream);
}
