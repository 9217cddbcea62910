// Pieces of the accumulating stage-B kernels K3 (fused_corr_acc.cu) and
// K4 (fused_corr_full.cu): a block-wide float32 matrix product, the
// stage-B chain plus pruned inverse of one k1 group, and the fixed-order
// sum of the groups' partials.
//
// Why partials. The pruned inverse
//
//   out[b, r, :] = sum_{k1 < H} wi[r, k1] Re C[b,k1,:] + wi[r, H+k1] Im C[b,k1,:]
//
// accumulates over every k1 row into a (rows_out, N2) plane: 6.5 MB per
// window at day scale (198 x 8192 float32). The TPU kernels kept it in
// VMEM across a sequential k1 sweep. A Hopper block has 227 KB of shared
// memory, and blocks run in no order, so each window's H rows are split
// into S = ceil(H / G) fixed groups of G rows (the wrapper's choice,
// ops/fused_fft.py: groups). The block of group s writes its partial
// product to device memory, and a second launch (sum_partials) adds the
// S partials in ascending s. No atomics: two launches on the same inputs
// give the same bits.
//
// Why a row scratch. One block's shared memory holds one row's transform
// (x and y rows, 128 KB at N2 = 8192, plus 32 KB of twiddles), so the
// group's correlation rows C pass through a device-memory scratch of
// 2G x N2 floats before the block multiplies them by its columns of wi.

#pragma once

#include <cuda_runtime.h>

#include "fft_row.cuh"

namespace xcorr {

constexpr int kAccThreads = 1024;  // threads of a K3/K4 block
constexpr int kBK = 16;            // depth of one product step
constexpr int kTN = 256;           // columns of a product tile (64 x 4)
constexpr int kMR = 5;             // rows per thread: tiles of 80 rows

// Shared floats one gemm takes.
constexpr int kGemmFloats = kBK * (16 * kMR + kTN);

// out(m, n) = sum_{k < K} a(m, k) * b(k, n) for m < M, n < N, summed in
// ascending k with float32 FMAs. Tiles of 16*kMR rows x 256 columns; each
// of the 1024 threads holds a kMR x 4 accumulator. Ends on a barrier, so
// what `st` wrote to device memory is visible to the whole block.
template <class A, class Bm, class St>
__device__ void gemm(int M, int N, int K, A a, Bm b, St st, float* smem) {
  constexpr int MR = kMR;
  constexpr int TM = 16 * MR;
  float* As = smem;             // [kBK][TM]
  float* Bs = smem + kBK * TM;  // [kBK][kTN]
  const int tid = threadIdx.x;
  const int tx = tid & 63, ty = tid >> 6;
  for (int m0 = 0; m0 < M; m0 += TM) {
    for (int n0 = 0; n0 < N; n0 += kTN) {
      float acc[MR][4];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kBK) {
        for (int e = tid; e < TM * kBK; e += kAccThreads) {
          const int k = e & (kBK - 1), m = e >> 4;
          As[k * TM + m] =
              (m0 + m < M && k0 + k < K) ? a(m0 + m, k0 + k) : 0.0f;
        }
        for (int e = tid; e < kBK * kTN; e += kAccThreads) {
          const int k = e >> 8, c = e & (kTN - 1);
          Bs[k * kTN + c] =
              (n0 + c < N && k0 + k < K) ? b(k0 + k, n0 + c) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + kk * kTN + 4 * tx);
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            const float av = As[kk * TM + ty * MR + i];
            acc[i][0] = fmaf(av, bv.x, acc[i][0]);
            acc[i][1] = fmaf(av, bv.y, acc[i][1]);
            acc[i][2] = fmaf(av, bv.z, acc[i][2]);
            acc[i][3] = fmaf(av, bv.w, acc[i][3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int m = m0 + ty * MR + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 4 * tx + j;
          if (c < N) st(m, c, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// One k1 group of one window: for its g rows k0 .. k0+g-1, the stage-B
// correlation rows (corr_row) into the scratch cs (re rows 0..g-1, im
// rows g..2g-1, each n long), then its partial of the pruned inverse
//
//   part[r, :] = sum_{j < g} wi[r, k0+j] cs[j, :] + wi[r, H+k0+j] cs[g+j, :]
//
// for r < rows_out, with wi the (rows_out, 2H) row-major inverse matrix.
// Row j of the stage-A planes is at xre/xim/yre/yim + j*n; cs may be xre
// with xim = xre + g*n (each C row overwrites the x row it came from).
__device__ inline void group_corr_acc(
    const float* xre, const float* xim, const float* yre, const float* yim,
    const float* T, const float2* ws, const float* __restrict__ wi,
    float* cs, float* __restrict__ part, int H, int k0, int g, int rows_out,
    int n, int log2n, float2* work) {
  for (int j = 0; j < g; ++j) {
    const float* t_re = T + static_cast<size_t>(k0 + j) * n;
    const float* t_im = t_re + static_cast<size_t>(H) * n;
    const size_t o = static_cast<size_t>(j) * n;
    corr_row(xre + o, xim + o, yre + o, yim + o, t_re, t_im, cs + o,
             cs + static_cast<size_t>(g + j) * n, work, work + n, ws, n,
             log2n);
  }
  const size_t ld = 2 * static_cast<size_t>(H);
  gemm(
      rows_out, n, 2 * g,
      [=](int m, int k) {
        return wi[m * ld + (k < g ? k0 + k : H + k0 + k - g)];
      },
      [=](int k, int c) { return cs[static_cast<size_t>(k) * n + c]; },
      [=](int m, int c, float v) {
        part[static_cast<size_t>(m) * n + c] = v;
      },
      reinterpret_cast<float*>(work));
}

// Shared bytes of a K3/K4 block: the twiddles, then the larger of two
// transform rows and the product tiles.
inline int acc_smem_bytes(int n) {
  const int rows = 2 * n * static_cast<int>(sizeof(float2));
  const int tiles = kGemmFloats * static_cast<int>(sizeof(float));
  return (n / 2) * static_cast<int>(sizeof(float2)) +
         (rows > tiles ? rows : tiles);
}

// Kernels are per translation unit: each .cu that includes this header
// gets its own copy.
namespace {

// out[b, e] = sum_{s < S} part[b, s, e] in ascending s, e < plane.
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int B, int S,
                             size_t plane) {
  const size_t total = static_cast<size_t>(B) * plane;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = i / plane, e = i - b * plane;
    const float* p = part + b * S * plane + e;
    float acc = p[0];
    for (int s = 1; s < S; ++s) acc += p[s * plane];
    out[i] = acc;
  }
}

int launch_sum_partials(const float* part, float* out, int B, int S,
                               size_t plane, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * plane;
  size_t blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_partials<<<static_cast<int>(blocks), 256, 0, stream>>>(part, out, B,
                                                              S, plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace xcorr
