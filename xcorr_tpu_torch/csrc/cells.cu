// The timelapse's 2-D correlation cells (ops/cells.py, TL1 and TL2).
//
// Replaces no pallas_call: the JAX package leaves a batch of cells to
// one XLA executable, _corr_step (xcorr_tpu/scripts/timelapse.py:86-130:
// gather both spectrograms, normalize, two rfft2, product, irfft2, the
// fftshift slices, argmax). The port takes each spectrogram's spectrum
// once per stack (xcorr_tpu_torch/scripts/timelapse.py:
// correlate_spectrograms); these kernels are the passes around cuFFT's.
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
// TL2 is each cell's peak and flat argmax over the fftshifted window of
// rows i = 0 .. 2*n1-2 and columns j = 0 .. 2*n2-2 of its circular
// correlation map irfft2(P, s=(nf, nl)), at circular row
// (i - (n1-1)) mod nf and column (j - (n2-1)) mod nl, as
// ops.cc.lag_slice_of_circular defines them: the peak and its flat index
// k = i * (2*n2-1) + j, with torch.argmax's rule over the fftshifted
// array (the first maximal element in that order; a NaN counts as larger
// than any number, the first NaN wins). Two routes, chosen from nl
// before any launch (ops/cells.py: row_plan):
//
// xc_inverse_argmax, the row route, where a row fits one block's shared
// memory (nl up to 28,672). Its input is Y = ifft(P, dim=-2), cuFFT's
// column inverse, unscaled and with its columns contiguous, as cuFFT
// writes it from products kept in columns; it does the inverse's last
// axis and the peak in one kernel, so no map goes to device memory.
// Bound by bytes: the kept rows' half spectra, (2*n1-1) * (nl/2+1) * 8 B
// a cell, read once. Design: one block per two kept rows of a cell (the
// last block of an odd count has one), of 512 threads; where two
// blocks fit an SM's shared memory (nl up to about 14,000), one block's
// copy overlaps the other's transform. The block
// copies both half spectra into dynamic shared memory (cp.async, 8 bytes
// a thread, term l of both rows on neighbouring threads: side by side in
// Y's column layout), then builds in place the packed row Z = Ya + i*Yb
// of length nl: each half spectrum extended to its Hermitian length, the
// DC term's and, for an even nl, the Nyquist term's imaginary parts
// dropped, as irfft drops them. One complex inverse of Z gives both real
// rows, Re and Im. The packing moves each term n to slots n and nl-n;
// the terms n and c-n (c = h-1 for an odd nl, h-2 for an even one,
// h = nl/2+1) read and write the same four slots, so one thread takes
// both and no barrier separates reads from writes. The inverse is a
// mixed-radix decimation-in-frequency transform over row_plan's passes
// (radices 8, 4, 2, 7, 9, 5, 3, each butterfly in registers), in place:
// a self-sorting Stockham transform needs a second buffer, two rows at
// nl = 18,225, 292 KB, over the 227 KB a block may hold. Its outputs lie
// in digit-reversed order, which the reduction reads through the passes'
// digits. Each twiddle e^{2 pi i e/nl} is lo[e mod 128] * hi[e / 128],
// two tables computed in float64 and stored as float32 (ops/cells.py:
// row_twiddles), one per (device, nl), held in shared memory (2.8 KB at
// most): read from L2 at every butterfly they left the kernel waiting
// (2.88 ms at 64 cells of 162 x 18,225 on an H100, tools/tl_kernels.py).
// A thread steps its butterflies' (span, offset) without a division.
// The result is scaled by 1/(nf*nl) (with ifft unscaled, irfft2's
// values). A row whose terms hold an infinity or a NaN maps to
// NaN at every lag: the block gives NaN at that row's first window
// column without transforming, so the packed partner row never sees it.
// Each block reduces both rows' window columns to one (value, index)
// pair, ties to the smaller index, in shared memory;
// circular_argmax_join reduces each cell's blocks the same way. No
// atomics: a rerun gives the same bits.
//
// xc_circular_argmax, the scan, for longer rows: it reads the window of
// the map that cuFFT's irfft2 wrote, in place: no fftshifted copy. Bound
// by bytes: (2*n1-1) * (2*n2-1) * 4 B a cell read once. Design: one
// cell's window split into segments of whole rows, so that a batch of
// 64 cells still fills the card (about four blocks per SM; at 64 cells
// of 162 x 18225, 0.38 ms against 2.08 with one block per cell on an
// H100, tools/tl_kernels.py); each thread scans its columns of a row in
// ascending order with four loads in flight, keeping (value, index)
// pairs; the block reduces its pairs in shared memory, breaking ties by
// the smaller index, and a second launch reduces each cell's segments
// the same way. No atomics: the result is exact and a rerun gives the
// same bits.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TL1_THREADS = 256;
constexpr int TL1_PER_THREAD = 4;
constexpr int TL2_THREADS = 256;
constexpr int ROW_THREADS = 512;   // ops/cells.py: ROW_THREADS
constexpr int MAX_PASSES = 16;
constexpr int TW_LO_BITS = 7;      // ops/cells.py: TW_LO_BITS
constexpr int TW_LO = 1 << TW_LO_BITS;
// lo's slots in shared memory: entry i at i + i/16, so that the reads of
// a warp at a stride of 2, 4, 8 or 16 entries fall in distinct banks
constexpr int TW_LO_SLOTS = TW_LO + TW_LO / 16;

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

// Reduce the block's N pairs in the shared arrays sv and sk (N each);
// every thread holds the winner on return.
template <int N>
__device__ void block_best_in(float& v, long long& k, float* sv,
                              long long* sk) {
  const int t = threadIdx.x;
  sv[t] = v;
  sk[t] = k;
  __syncthreads();
  for (int s = N / 2; s > 0; s >>= 1) {
    if (t < s && before(sv[t + s], sk[t + s], sv[t], sk[t])) {
      sv[t] = sv[t + s];
      sk[t] = sk[t + s];
    }
    __syncthreads();
  }
  v = sv[0];
  k = sk[0];
}

__device__ void block_best(float& v, long long& k) {
  __shared__ float sv[TL2_THREADS];
  __shared__ long long sk[TL2_THREADS];
  block_best_in<TL2_THREADS>(v, k, sv, sk);
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


// -- TL2's row route: xc_inverse_argmax ------------------------------------

// The radices of a row's passes, in order (ops/cells.py: row_plan).
struct RowPasses {
  int count;
  int radix[MAX_PASSES];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 times_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// e^{+2 pi i e / R} for an odd radix R and 0 < e < R, from float64
// literals.
template <int R>
__device__ __forceinline__ float2 unit(int e) {
  const bool up = 2 * e < R;
  const int a = up ? e : R - e;
  float c = 0.f, s = 0.f;
  if (R == 3) {
    c = -0.5f;
    s = 0.8660254037844387f;
  } else if (R == 5) {
    c = a == 1 ? 0.30901699437494745f : -0.8090169943749473f;
    s = a == 1 ? 0.9510565162951535f : 0.5877852522924732f;
  } else if (R == 7) {
    c = a == 1 ? 0.6234898018587336f
               : a == 2 ? -0.22252093395631434f : -0.900968867902419f;
    s = a == 1 ? 0.7818314824680298f
               : a == 2 ? 0.9749279121818236f : 0.43388373911755823f;
  } else if (R == 9) {
    c = a == 1 ? 0.766044443118978f
               : a == 2 ? 0.17364817766693041f
                        : a == 3 ? -0.5f : -0.9396926207859083f;
    s = a == 1 ? 0.6427876096865393f
               : a == 2 ? 0.984807753012208f
                        : a == 3 ? 0.8660254037844387f : 0.3420201433256688f;
  }
  return make_float2(c, up ? s : -s);
}

// The inverse DFT of R points in registers, in place:
// x[k] <- sum_q x[q] e^{+2 pi i q k / R}.
template <int R>
__device__ __forceinline__ void idft(float2* x) {
  if constexpr (R == 2) {
    const float2 a = cadd(x[0], x[1]), b = csub(x[0], x[1]);
    x[0] = a;
    x[1] = b;
  } else if constexpr (R == 4) {
    const float2 a = cadd(x[0], x[2]), b = csub(x[0], x[2]);
    const float2 c = cadd(x[1], x[3]), d = times_i(csub(x[1], x[3]));
    x[0] = cadd(a, c);
    x[1] = cadd(b, d);
    x[2] = csub(a, c);
    x[3] = csub(b, d);
  } else if constexpr (R == 8) {
    float2 e[4] = {x[0], x[2], x[4], x[6]};
    float2 o[4] = {x[1], x[3], x[5], x[7]};
    idft<4>(e);
    idft<4>(o);
    const float h = 0.7071067811865476f;     // e^{+i pi/4} = (h, h)
    o[1] = make_float2(h * (o[1].x - o[1].y), h * (o[1].x + o[1].y));
    o[2] = times_i(o[2]);
    o[3] = make_float2(-h * (o[3].x + o[3].y), h * (o[3].x - o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = cadd(e[k], o[k]);
      x[k + 4] = csub(e[k], o[k]);
    }
  } else if constexpr (R == 9) {
    // 3 x 3: the radix-3 inverses over q = a + 3 q1 for each a, the
    // twiddles e^{+2 pi i a k1 / 9}, then the radix-3 inverses over a;
    // output k1 + 3 k2
    float2 u[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float2 t[3] = {x[a], x[a + 3], x[a + 6]};
      idft<3>(t);
#pragma unroll
      for (int k1 = 0; k1 < 3; ++k1)
        u[k1][a] = a * k1 == 0 ? t[k1] : cmul(t[k1], unit<9>(a * k1));
    }
#pragma unroll
    for (int k1 = 0; k1 < 3; ++k1) {
      idft<3>(u[k1]);
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) x[k1 + 3 * k2] = u[k1][k2];
    }
  } else {
    // an odd prime radix: the terms q and R-q in pairs, y_k = x0 + sum_q
    // (x_q + x_{R-q}) cos + i (x_q - x_{R-q}) sin, and y_{R-k} its
    // mirror
    constexpr int H = (R - 1) / 2;
    float2 sum[H], dif[H];
    float2 y0 = x[0];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      sum[q - 1] = cadd(x[q], x[R - q]);
      dif[q - 1] = csub(x[q], x[R - q]);
      y0 = cadd(y0, sum[q - 1]);
    }
    float2 y[R];
    y[0] = y0;
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 a = x[0], b = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        const float2 w = unit<R>((q * k) % R);
        a = make_float2(a.x + sum[q - 1].x * w.x, a.y + sum[q - 1].y * w.x);
        b = make_float2(b.x + dif[q - 1].x * w.y, b.y + dif[q - 1].y * w.y);
      }
      y[k] = cadd(a, times_i(b));
      y[R - k] = csub(a, times_i(b));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = y[k];
  }
}

// e^{+2 pi i e / nl} for 0 <= e < nl, from the two float32 tables in
// shared memory (ops/cells.py: row_twiddles): lo[e mod TW_LO] (at its
// skewed slot) times hi[e / TW_LO].
__device__ __forceinline__ float2 twiddle(const float2* lo, const float2* hi,
                                          int e) {
  const int i = e & (TW_LO - 1);
  return cmul(hi[e >> TW_LO_BITS], lo[i + (i >> 4)]);
}

// One decimation-in-frequency pass of radix R over spans of S = R*m
// values in place: for each span b and j < m, the R values j + q*m go
// through the R-point inverse and output k is multiplied by
// e^{+2 pi i j k / S} = e^{+2 pi i j k step / nl} (step = nl / S) and
// stored at j + k*m. Each butterfly's values are its thread's alone in
// the pass. A thread's butterflies u = t, t + T, ... (T threads a
// block) step (b, j) without a division.
template <int R, int T>
__device__ __forceinline__ void dif_pass(float2* z, const float2* lo,
                                         const float2* hi, int m, int step,
                                         int butterflies) {
  const int S = R * m;
  const int db = T / m, dj = T - db * m;
  int b = threadIdx.x / m, j = threadIdx.x - b * m;
  for (int u = threadIdx.x; u < butterflies; u += T) {
    float2* at = z + b * S + j;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = at[q * m];
    idft<R>(x);
    at[0] = x[0];
    const int e1 = j * step;
#pragma unroll
    for (int k = 1; k < R; ++k)
      at[k * m] = cmul(x[k], twiddle(lo, hi, k * e1));
    j += dj;
    b += db;
    if (j >= m) {
      j -= m;
      ++b;
    }
  }
}

// Copy 8 bytes from device to shared memory, asynchronously.
__device__ __forceinline__ void copy8_async(float2* dst, const float2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__device__ __forceinline__ bool finite2(float2 a) {
  return isfinite(a.x) && isfinite(a.y);
}

// Term n of both half spectra (a of row a, b of row b) into the packed
// row z = Ya + i*Yb of length nl: slots n and nl-n, or slot 0 alone for
// the DC term, whose imaginary parts irfft drops. Flags a term that is
// not finite.
__device__ __forceinline__ void pack_term(float2* z, int nl, int n, float2 a,
                                          float2 b, int& bad_a, int& bad_b) {
  if (n == 0) {
    bad_a |= !isfinite(a.x);
    bad_b |= !isfinite(b.x);
    z[0] = make_float2(a.x, b.x);
  } else {
    bad_a |= !finite2(a);
    bad_b |= !finite2(b);
    z[n] = make_float2(a.x - b.y, a.y + b.x);
    z[nl - n] = make_float2(a.x + b.y, b.x - a.y);
  }
}

__device__ __forceinline__ int circular_row(int i, int n1, int nf) {
  return i < n1 - 1 ? nf - (n1 - 1) + i : i - (n1 - 1);
}

// Block (q, c) of T threads: kept rows 2q and 2q+1 of cell c, Y's
// element (c, i, l) at c*sc + i*sr + l*sl. Shared memory holds zs =
// max(2h, 3/2 ROW_THREADS) complex values, h = nl/2 + 1: row a's half
// spectrum, then row b's (zeros where the block has one row); then the
// twiddle tables (tw: TW_LO + ceil(nl / TW_LO) values, lo over
// TW_LO_SLOTS). The map's values are scaled by `scale` (1/(nf*nl)).
__global__ void __launch_bounds__(ROW_THREADS, 2)
inverse_argmax_pair(const float2* __restrict__ Y,
                    const float2* __restrict__ tw, float* __restrict__ part_v,
                    long long* __restrict__ part_k, RowPasses ps, int nf,
                    int nl, int n1, int n2, int sc, int sr, int sl,
                    float scale) {
  constexpr int T = ROW_THREADS;
  extern __shared__ float2 z[];
  const int t = threadIdx.x, q = blockIdx.x, c = blockIdx.y;
  const int h = nl / 2 + 1, rows = 2 * n1 - 1, W = 2 * n2 - 1;
  const int ia = 2 * q, ib = 2 * q + 1;
  const bool has_b = ib < rows;
  const float2* cell = Y + (long long)c * sc;
  const float2* ya = cell + (long long)circular_row(ia, n1, nf) * sr;
  const float2* yb = cell + (long long)circular_row(has_b ? ib : ia, n1,
                                                    nf) * sr;
  const int zs = 2 * h > 3 * ROW_THREADS / 2 ? 2 * h : 3 * ROW_THREADS / 2;
  float2* lo = z + zs;
  float2* hi = lo + TW_LO_SLOTS;
  for (int e = t; e < TW_LO + (nl + TW_LO - 1) / TW_LO; e += T) {
    if (e < TW_LO)
      lo[e + (e >> 4)] = tw[e];
    else
      hi[e - TW_LO] = tw[e];
  }
  // neighbouring threads take term l of both rows, which lie side by
  // side where Y's columns are contiguous
  for (int e = t; e < 2 * h; e += T) {
    const int l = e >> 1;
    if (!(e & 1))
      copy8_async(z + l, ya + (long long)l * sl);
    else if (has_b)
      copy8_async(z + h + l, yb + (long long)l * sl);
    else
      z[h + l] = make_float2(0.f, 0.f);
  }
  copy_async_wait();
  __syncthreads();

  // the Hermitian extension and the packing, in place: terms n and
  // cp - n share their four slots
  const int cp = (nl & 1) ? h - 1 : h - 2;
  int bad_a = 0, bad_b = 0;
  for (int n = t; 2 * n <= cp; n += T) {
    const int m = cp - n;
    const float2 a0 = z[n], b0 = z[h + n], a1 = z[m], b1 = z[h + m];
    pack_term(z, nl, n, a0, b0, bad_a, bad_b);
    if (m != n) pack_term(z, nl, m, a1, b1, bad_a, bad_b);
  }
  if (!(nl & 1) && t == 0) {       // the Nyquist term: slot h-1, real
    const float2 a = z[h - 1], b = z[2 * h - 1];
    bad_a |= !isfinite(a.x);
    bad_b |= !isfinite(b.x);
    z[h - 1] = make_float2(a.x, b.x);
  }
  bad_a = __syncthreads_or(bad_a);
  bad_b = __syncthreads_or(bad_b);
  const long long ka = (long long)ia * W, kb = (long long)ib * W;
  const long long out = (long long)c * n1 + q;
  if (bad_a || bad_b) {
    if (t == 0) {
      part_v[out] = NAN;
      part_k[out] = bad_a ? ka : kb;
    }
    return;
  }

  // the inverse, pass by pass
  int S = nl;
  for (int p = 0; p < ps.count; ++p) {
    const int r = ps.radix[p], m = S / r, step = nl / S, nb = nl / r;
    switch (r) {
      case 2: dif_pass<2, T>(z, lo, hi, m, step, nb); break;
      case 3: dif_pass<3, T>(z, lo, hi, m, step, nb); break;
      case 4: dif_pass<4, T>(z, lo, hi, m, step, nb); break;
      case 5: dif_pass<5, T>(z, lo, hi, m, step, nb); break;
      case 7: dif_pass<7, T>(z, lo, hi, m, step, nb); break;
      case 8: dif_pass<8, T>(z, lo, hi, m, step, nb); break;
      default: dif_pass<9, T>(z, lo, hi, m, step, nb); break;
    }
    S = m;
    __syncthreads();
  }

  // the reduction: position d0*M0 + s holds lag f = d0 + r0*g, g the
  // digit reversal of s over the later passes; its window column is
  // (f + n2-1) mod nl where below W
  const int r0 = ps.count > 0 ? ps.radix[0] : 1;
  const int M0 = nl / r0;
  float bv = -INFINITY;
  long long bk = LLONG_MAX;
  for (int s = t; s < M0; s += T) {
    int g = 0, x = s;
    for (int p = ps.count - 1; p >= 1; --p) {
      const int r = ps.radix[p], d = x % r;
      x /= r;
      g = g * r + d;
    }
    for (int d0 = 0; d0 < r0; ++d0) {
      int j = d0 + r0 * g + n2 - 1;
      if (j >= nl) j -= nl;
      if (j >= W) continue;
      const float2 v = z[d0 * M0 + s];
      const float va = v.x * scale;
      if (before(va, ka + j, bv, bk)) {
        bv = va;
        bk = ka + j;
      }
      const float vb = v.y * scale;
      if (has_b && before(vb, kb + j, bv, bk)) {
        bv = vb;
        bk = kb + j;
      }
    }
  }
  __syncthreads();                 // z is free: the pairs go there
  long long* sk = reinterpret_cast<long long*>(z);
  float* sv = reinterpret_cast<float*>(sk + T);
  block_best_in<T>(bv, bk, sv, sk);
  if (t == 0) {
    part_v[out] = bv;
    part_k[out] = bk;
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

// TL2's row route: peak (B,) float32 and index (B,) int64 of each map
// irfft(Y[c], n=nl) / nf over its fftshifted (2*n1-1, 2*n2-1) window,
// from Y (B, nf, nl/2+1) complex64 with element strides (sc, sr, sl); tw
// the twiddle tables (ops/cells.py: row_twiddles), radices the npass
// radices (a host array of int), part_v (B*n1,) float32 and part_k
// (B*n1,) int64 the blocks' scratch.
extern "C" int xc_inverse_argmax(const void* Y, const void* tw, void* peak,
                                 void* index, void* part_v, void* part_k,
                                 const void* radices, int npass, int B,
                                 int nf, int nl, int n1, int n2, int sc,
                                 int sr, int sl, void* stream) {
  if (B < 1 || B > 65535 || n1 < 1 || n2 < 1 || nf < 2 * n1 - 1 ||
      nl < 2 * n2 - 1 || npass < 0 || npass > MAX_PASSES || sc < 0 ||
      sr < 0 || sl < 0)
    return (int)cudaErrorInvalidValue;
  RowPasses ps{};
  ps.count = npass;
  long long length = 1;
  for (int p = 0; p < npass; ++p) {
    const int r = static_cast<const int*>(radices)[p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 9)
      return (int)cudaErrorInvalidValue;
    ps.radix[p] = r;
    length *= r;
  }
  if (length != nl) return (int)cudaErrorInvalidValue;
  const int h = nl / 2 + 1;
  const int zs = 2 * h > 3 * ROW_THREADS / 2 ? 2 * h : 3 * ROW_THREADS / 2;
  const int smem = 8 * (zs + TW_LO_SLOTS + (nl + TW_LO - 1) / TW_LO);
  cudaError_t rc = cudaFuncSetAttribute(
      inverse_argmax_pair, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(inverse_argmax_pair,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            (int)cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  cudaStream_t st = (cudaStream_t)stream;
  inverse_argmax_pair<<<dim3(n1, B), ROW_THREADS, smem, st>>>(
      (const float2*)Y, (const float2*)tw, (float*)part_v,
      (long long*)part_k, ps, nf, nl, n1, n2, sc, sr, sl,
      (float)(1.0 / ((double)nf * nl)));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  circular_argmax_join<<<B, TL2_THREADS, 0, st>>>(
      (const float*)part_v, (const long long*)part_k, (float*)peak,
      (int64_t*)index, n1);
  return (int)cudaGetLastError();
}
