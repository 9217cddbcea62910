// The timelapse's 2-D correlation cells (ops/cells.py, TL1 and TL2).
//
// Replaces no pallas_call: the JAX package leaves a batch of cells to
// one XLA executable, _corr_step (xcorr_tpu/scripts/timelapse.py:86-130:
// gather both spectrograms, normalize, two rfft2, product, irfft2, the
// fftshift slices, argmax). The port takes each spectrogram's spectrum
// once per stack (xcorr_tpu_torch/scripts/timelapse.py:
// correlate_spectrograms) and leaves the inverse to cuFFT; these two
// kernels are the passes around it.
//
// TL1, xc_gather_product. For each cell c of a batch of B,
//
//   P[c] = A[ii[c]] * conj(Bs[jj[c]])       complex64, M = nf * (nl/2+1)
//
// straight from the cached spectra by index: no gathered copy of either
// operand and no separate product pass. Bound by bytes: at most
// 3 * M * 8 B a cell (two spectra read, one product written), and at
// least the spectra the batch names read once plus the products written
// once. Design: the grid's x is the cell, its y a chunk of 1024 elements
// of the spectrum, so the blocks of one chunk of every cell of a batch
// run together and a spectrum shared by neighbouring cells (a row of the
// triangle shares ii) is read from HBM once and served from L2 for the
// others. Each thread loads one complex value (8 bytes) of each operand
// a step, neighbouring threads neighbouring addresses; 16-byte loads
// (two values a thread) took the same time on an H100 (0.5582 against
// 0.5594 ms at 64 cells of nf x nl = 162 x 18,225, tools/tl_kernels.py).
//
// TL2, xc_circular_argmax. For each cell's circular correlation map r
// (B, nf, nl) float32, the maximum over the fftshifted window of rows
// i = 0 .. 2*n1-2 and columns j = 0 .. 2*n2-2, read in place at circular
// row (i - (n1-1)) mod nf and column (j - (n2-1)) mod nl, as
// ops.cc.lag_slice_of_circular defines them: no fftshifted copy. It
// returns the peak and its flat index k = i * (2*n2-1) + j, with
// torch.argmax's rule over the fftshifted array: the first maximal
// element in that order, and a NaN counts as larger than any number (the
// first NaN wins). Bound by bytes: (2*n1-1) * (2*n2-1) * 4 B a cell read
// once. Design: one cell's window split into segments of whole rows, so
// that a batch of 64 cells still fills the card (about four blocks per
// SM; at 64 cells of 162 x 18225, 0.38 ms against 2.08 with one block
// per cell on an H100, tools/tl_kernels.py); each thread scans its columns of a row in ascending order with
// four loads in flight, keeping (value, index) pairs; the block reduces
// its pairs in shared memory, breaking ties by the smaller index, and a
// second launch reduces each cell's segments the same way. No atomics:
// the result is exact and a rerun gives the same bits.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TL1_THREADS = 256;
constexpr int TL1_PER_THREAD = 4;
constexpr int TL2_THREADS = 256;

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  // a * conj(b), in the order of c10::complex's product with (b.x, -b.y)
  const float bi = -b.y;
  return make_float2(a.x * b.x - a.y * bi, a.x * bi + a.y * b.x);
}

__global__ void __launch_bounds__(TL1_THREADS)
gather_product(const float2* __restrict__ A, const float2* __restrict__ Bs,
               const int64_t* __restrict__ ii,
               const int64_t* __restrict__ jj, float2* __restrict__ P,
               long long M) {
  const int c = blockIdx.x;
  const float2* a = A + ii[c] * M;
  const float2* b = Bs + jj[c] * M;
  float2* p = P + (long long)c * M;
  const long long base = (long long)blockIdx.y * TL1_THREADS * TL1_PER_THREAD
                         + threadIdx.x;
#pragma unroll
  for (int r = 0; r < TL1_PER_THREAD; ++r) {
    const long long e = base + (long long)r * TL1_THREADS;
    if (e < M) p[e] = cmul_conj(a[e], b[e]);
  }
}

// (v, k) before (bv, bk) in torch.argmax's order: a NaN first (the
// smaller index among NaNs), else the larger value, else the smaller
// index.
__device__ __forceinline__ bool before(float v, long long k, float bv,
                                       long long bk) {
  if (v != v) return bv == bv || k < bk;
  if (bv != bv) return false;
  return v > bv || (v == bv && k < bk);
}

// Reduce the block's TL2_THREADS pairs in shared memory; thread 0 holds
// the winner on return.
__device__ void block_best(float& v, long long& k) {
  __shared__ float sv[TL2_THREADS];
  __shared__ long long sk[TL2_THREADS];
  const int t = threadIdx.x;
  sv[t] = v;
  sk[t] = k;
  __syncthreads();
  for (int s = TL2_THREADS / 2; s > 0; s >>= 1) {
    if (t < s && before(sv[t + s], sk[t + s], sv[t], sk[t])) {
      sv[t] = sv[t + s];
      sk[t] = sk[t + s];
    }
    __syncthreads();
  }
  v = sv[0];
  k = sk[0];
}

// Segment s of cell c: fftshifted rows [s*rows/segs, (s+1)*rows/segs).
__global__ void __launch_bounds__(TL2_THREADS)
circular_argmax_part(const float* __restrict__ r, float* __restrict__ part_v,
                     long long* __restrict__ part_k, int nf, int nl, int n1,
                     int n2, int segs) {
  const int c = blockIdx.x, s = blockIdx.y;
  const int rows = 2 * n1 - 1, W = 2 * n2 - 1;
  const int i0 = (int)((long long)s * rows / segs);
  const int i1 = (int)((long long)(s + 1) * rows / segs);
  const float* map = r + (long long)c * nf * nl;
  float bv = -INFINITY;
  long long bk = LLONG_MAX;
  for (int i = i0; i < i1; ++i) {
    const int ci = i < n1 - 1 ? nf - (n1 - 1) + i : i - (n1 - 1);
    const float* row = map + (long long)ci * nl;
    const long long k0 = (long long)i * W;
    // columns j < n2-1 sit at nl-(n2-1)+j, the others at j-(n2-1)
    for (int j = threadIdx.x; j < W; j += 4 * TL2_THREADS) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u * TL2_THREADS;
        v[u] = jj < W ? row[jj < n2 - 1 ? nl - (n2 - 1) + jj
                                        : jj - (n2 - 1)]
                      : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u * TL2_THREADS;
        if (jj < W && before(v[u], k0 + jj, bv, bk)) {
          bv = v[u];
          bk = k0 + jj;
        }
      }
    }
  }
  block_best(bv, bk);
  if (threadIdx.x == 0) {
    part_v[(long long)c * segs + s] = bv;
    part_k[(long long)c * segs + s] = bk;
  }
}

__global__ void __launch_bounds__(TL2_THREADS)
circular_argmax_join(const float* __restrict__ part_v,
                     const long long* __restrict__ part_k,
                     float* __restrict__ peak, int64_t* __restrict__ index,
                     int segs) {
  const int c = blockIdx.x;
  float bv = -INFINITY;
  long long bk = LLONG_MAX;
  for (int s = threadIdx.x; s < segs; s += TL2_THREADS) {
    const float v = part_v[(long long)c * segs + s];
    const long long k = part_k[(long long)c * segs + s];
    if (before(v, k, bv, bk)) {
      bv = v;
      bk = k;
    }
  }
  block_best(bv, bk);
  if (threadIdx.x == 0) {
    peak[c] = bv;
    index[c] = bk;
  }
}

}  // namespace

// TL1: P (B, M) complex64 = A[ii] * conj(Bs[jj]); A and Bs hold M
// complex values per spectrum.
extern "C" int xc_gather_product(const void* A, const void* Bs,
                                 const void* ii, const void* jj, void* P,
                                 int B, int M, void* stream) {
  if (B < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const long long chunk = (long long)TL1_THREADS * TL1_PER_THREAD;
  const long long chunks = (M + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  gather_product<<<dim3(B, (unsigned)chunks), TL1_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)Bs, (const int64_t*)ii,
      (const int64_t*)jj, (float2*)P, M);
  return (int)cudaGetLastError();
}

// TL2: peak (B,) float32 and index (B,) int64 of each (nf, nl) map of r
// over its fftshifted (2*n1-1, 2*n2-1) window; part_v (B*segs,) float32
// and part_k (B*segs,) int64 are the segments' scratch, 1 <= segs <=
// 2*n1-1.
extern "C" int xc_circular_argmax(const void* r, void* peak, void* index,
                                  void* part_v, void* part_k, int B, int nf,
                                  int nl, int n1, int n2, int segs,
                                  void* stream) {
  if (B < 1 || n1 < 1 || n2 < 1 || nf < 2 * n1 - 1 || nl < 2 * n2 - 1 ||
      segs < 1 || segs > 2 * n1 - 1 || segs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  circular_argmax_part<<<dim3(B, segs), TL2_THREADS, 0, st>>>(
      (const float*)r, (float*)part_v, (long long*)part_k, nf, nl, n1, n2,
      segs);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  circular_argmax_join<<<B, TL2_THREADS, 0, st>>>(
      (const float*)part_v, (const long long*)part_k, (float*)peak,
      (int64_t*)index, segs);
  return (int)cudaGetLastError();
}
