// Register-resident row transforms of K1 (fused_corr.cu).
//
// One block transforms one complex float32 row of n = 2^LOG2N. Each of its
// P = n / E threads holds E = min(32, n) elements in registers. A
// transform is a short chain of radix passes: every pass but the last has
// radix 32, the last takes the rest (n = 16384 = 32 * 32 * 16), so there
// are ceil(LOG2N / 5) passes and one fewer exchanges through shared
// memory between them.
//
// Pass i works on blocks of L_i = n / (r_0 ... r_{i-1}) elements. Its
// butterflies are (blk, lo), lo < m_i = L_i / r_i, over the elements at
// blk * L_i + lo + m_i * j, j < r_i. Thread t takes butterflies
// b = u * P + t, u < E / r_i, with (blk, lo) = (b / m_i, b % m_i), so in
// the first pass neighbouring threads hold neighbouring elements (the
// loads from and stores to device memory are coalesced).
//
// Forward (decimation in frequency): a radix-r DFT in registers (radix-2
// stages on the r values, output p in slot bitrev_r(p)), then the pass
// twiddle W_{L_i}^{lo p}. Natural order in, digit-reversed order out.
// Inverse (decimation in time, unscaled): the passes in reverse order,
// conjugate twiddle first, then the conjugate DFT (slot bitrev_r(p) in,
// natural out), so the inverse takes the forward's order as it is and the
// last forward pass flows into the first inverse pass in registers.
//
// Exchanges go through a float buffer of n + n / 32 floats, real parts
// then imaginary parts, at padded index q = pos + pos / 32: with that one
// float of padding per 32, every warp access of every pass for every
// n <= 16384 hits 32 distinct banks.
//
// Twiddles. The radix-32 DFT's own twiddles W_32^k are the float32
// roundings of the float64 values, as literals. The pass twiddles come
// from a host table (float64 values stored as float32, built by
// ops/fused_fft.py: _k1_twiddles) laid out for the thread map: for pass i
// with m_i > 1, a = min(32, m_i) and nb = m_i / a,
//
//   A[p][c] = W_{L_i}^{c p}        p < r_i, c < a
//   B[p][h] = W_{L_i}^{a h p}      p < r_i, h < nb   (only when nb > 1)
//
// and W_{L_i}^{lo p} = A[p][lo % a] * B[p][lo / a]. A warp reads A at
// consecutive addresses and B at one address: no bank conflicts.

#pragma once

#include <cuda_runtime.h>

namespace xcorr {
namespace reg {

constexpr int kLogE = 5;  // log2 of the most elements a thread holds

// Compile-time geometry of a row of 2^lg (pass i), also used on the host.
#define XC_HD __host__ __device__ constexpr

XC_HD int elems(int lg) { return lg < kLogE ? 1 << lg : 1 << kLogE; }
XC_HD int threads(int lg) { return (1 << lg) / elems(lg); }
XC_HD int num_passes(int lg) { return (lg + kLogE - 1) / kLogE; }
XC_HD int log_radix(int lg, int i) {
  return i < num_passes(lg) - 1 ? kLogE : lg - kLogE * (num_passes(lg) - 1);
}
XC_HD int log_len(int lg, int i) { return lg - kLogE * i; }  // log2 L_i
XC_HD int log_m(int lg, int i) { return log_len(lg, i) - log_radix(lg, i); }
XC_HD int tw_a(int lg, int i) {
  return log_m(lg, i) < 5 ? 1 << log_m(lg, i) : 32;
}
XC_HD int tw_nb(int lg, int i) { return (1 << log_m(lg, i)) / tw_a(lg, i); }
// float2 entries of pass i's table (0 when m_i = 1: its twiddles are 1)
XC_HD int tw_size(int lg, int i) {
  return log_m(lg, i) == 0
             ? 0
             : (1 << log_radix(lg, i)) *
                   (tw_a(lg, i) + (tw_nb(lg, i) > 1 ? tw_nb(lg, i) : 0));
}
XC_HD int tw_offset(int lg, int i) {
  return i == 0 ? 0 : tw_offset(lg, i - 1) + tw_size(lg, i - 1);
}
XC_HD int tw_total(int lg) { return tw_offset(lg, num_passes(lg)); }
XC_HD int ex_floats(int lg) { return (1 << lg) + ((1 << lg) >> 5); }
// dynamic shared memory of one block: the x spectrum, the pass twiddles
// and the exchange buffer
XC_HD int smem_bytes(int lg) {
  return (1 << lg) * 8 + tw_total(lg) * 8 + ex_floats(lg) * 4;
}
XC_HD int bitrev(int p, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((p >> i) & 1) << (bits - 1 - i);
  return r;
}

#undef XC_HD

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// W_32^k = exp(-2 pi i k / 32), k < 16, as float32 (k = 8, -i, is never
// read: the radix-2 stages take it exactly)
__device__ __forceinline__ float2 w32(int k) {
  switch (k) {
    case 1: return make_float2(0.98078525f, -0.19509032f);
    case 2: return make_float2(0.9238795f, -0.38268343f);
    case 3: return make_float2(0.8314696f, -0.55557024f);
    case 4: return make_float2(0.70710677f, -0.70710677f);
    case 5: return make_float2(0.55557024f, -0.8314696f);
    case 6: return make_float2(0.38268343f, -0.9238795f);
    case 7: return make_float2(0.19509032f, -0.98078525f);
    case 9: return make_float2(-0.19509032f, -0.98078525f);
    case 10: return make_float2(-0.38268343f, -0.9238795f);
    case 11: return make_float2(-0.55557024f, -0.8314696f);
    case 12: return make_float2(-0.70710677f, -0.70710677f);
    case 13: return make_float2(-0.8314696f, -0.55557024f);
    case 14: return make_float2(-0.9238795f, -0.38268343f);
    case 15: return make_float2(-0.98078525f, -0.19509032f);
    default: return make_float2(1.0f, 0.0f);
  }
}

// DFT of R = 2^A registers by radix-2 DIF stages: natural order in,
// output p in v[bitrev_A(p)].
template <int A>
__device__ __forceinline__ void dft_reg(float2* v) {
  constexpr int R = 1 << A;
#pragma unroll
  for (int s = 0; s < A; ++s) {
    const int h = R >> (s + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & h) continue;
      const int j = i & (h - 1);
      const float2 u = v[i], w = v[i + h];
      const float2 d = make_float2(u.x - w.x, u.y - w.y);
      v[i] = make_float2(u.x + w.x, u.y + w.y);
      const int k = j * (32 / (2 * h));  // W_{2h}^j = W_32^k
      if (k == 0)
        v[i + h] = d;
      else if (k == 8)
        v[i + h] = make_float2(d.y, -d.x);  // * -i
      else
        v[i + h] = cmul(d, w32(k));
    }
  }
}

// Unscaled inverse of dft_reg: input p in v[bitrev_A(p)], natural out.
template <int A>
__device__ __forceinline__ void idft_reg(float2* v) {
  constexpr int R = 1 << A;
#pragma unroll
  for (int s = A - 1; s >= 0; --s) {
    const int h = R >> (s + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & h) continue;
      const int j = i & (h - 1);
      const int k = j * (32 / (2 * h));
      const float2 u = v[i];
      float2 w = v[i + h];
      if (k == 8)
        w = make_float2(-w.y, w.x);  // * i
      else if (k != 0)
        w = cmul_conj(w, w32(k));
      v[i] = make_float2(u.x + w.x, u.y + w.y);
      v[i + h] = make_float2(u.x - w.x, u.y - w.y);
    }
  }
}

// Position in the row of element j of butterfly u of thread t in pass I.
template <int LG, int I>
__device__ __forceinline__ int pos(int u, int j, int t) {
  constexpr int lm = log_m(LG, I);
  const int b = u * threads(LG) + t;
  return ((b >> lm) << log_len(LG, I)) + (b & ((1 << lm) - 1)) + (j << lm);
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// W_{L_I}^{lo p} of butterfly u of thread t, from pass I's table in ws.
template <int LG, int I>
__device__ __forceinline__ float2 pass_twiddle(const float2* ws, int u,
                                               int p, int t) {
  constexpr int a = tw_a(LG, I), nb = tw_nb(LG, I);
  constexpr int R = 1 << log_radix(LG, I);
  const float2* A = ws + tw_offset(LG, I);
  const int lo = (u * threads(LG) + t) & ((1 << log_m(LG, I)) - 1);
  const float2 wa = A[p * a + (lo & (a - 1))];
  if (nb == 1) return wa;
  return cmul(wa, A[R * a + p * nb + lo / a]);
}

// Slot of element j of butterfly u: natural (j) or bit-reversed.
template <int LG, int I, bool BREV>
__device__ __forceinline__ int slot(int u, int j) {
  constexpr int A = log_radix(LG, I);
  return (u << A) + (BREV ? bitrev(j, A) : j);
}

// Move the row between thread maps: write it as pass IW lays it out
// (slots bit-reversed when WB), read it as pass IR (slots bit-reversed
// when RB). Real parts first, then imaginary parts, through ex.
template <int LG, int IW, bool WB, int IR, bool RB>
__device__ __forceinline__ void exchange(float2* v, float* ex, int t) {
  constexpr int E = elems(LG);
  constexpr int RW = 1 << log_radix(LG, IW), RR = 1 << log_radix(LG, IR);
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int u = 0; u < E / RW; ++u)
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const float2 x = v[slot<LG, IW, WB>(u, j)];
        ex[pad(pos<LG, IW>(u, j, t))] = part ? x.y : x.x;
      }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < E / RR; ++u)
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        const float x = ex[pad(pos<LG, IR>(u, j, t))];
        float2& d = v[slot<LG, IR, RB>(u, j)];
        if (part)
          d.y = x;
        else
          d.x = x;
      }
    __syncthreads();
  }
}

// Forward passes I.. : v holds pass I's input in natural slots; on return
// it holds the last pass's output in bit-reversed slots.
template <int LG, int I = 0>
__device__ __forceinline__ void forward(float2* v, const float2* ws,
                                        float* ex, int t) {
  constexpr int A = log_radix(LG, I), R = 1 << A, E = elems(LG);
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    dft_reg<A>(v + u * R);
    if constexpr (log_m(LG, I) > 0) {
#pragma unroll
      for (int p = 1; p < R; ++p) {
        float2& x = v[u * R + bitrev(p, A)];
        x = cmul(x, pass_twiddle<LG, I>(ws, u, p, t));
      }
    }
  }
  if constexpr (I + 1 < num_passes(LG)) {
    exchange<LG, I, true, I + 1, false>(v, ex, t);
    forward<LG, I + 1>(v, ws, ex, t);
  }
}

// Inverse passes I down to 0 (unscaled): v holds pass I's input in
// bit-reversed slots; on return it holds the row in natural slots of
// pass 0.
template <int LG, int I>
__device__ __forceinline__ void inverse(float2* v, const float2* ws,
                                        float* ex, int t) {
  constexpr int A = log_radix(LG, I), R = 1 << A, E = elems(LG);
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    if constexpr (log_m(LG, I) > 0) {
#pragma unroll
      for (int p = 1; p < R; ++p) {
        float2& x = v[u * R + bitrev(p, A)];
        x = cmul_conj(x, pass_twiddle<LG, I>(ws, u, p, t));
      }
    }
    idft_reg<A>(v + u * R);
  }
  if constexpr (I > 0) {
    exchange<LG, I, false, I - 1, true>(v, ex, t);
    inverse<LG, I - 1>(v, ws, ex, t);
  }
}

}  // namespace reg
}  // namespace xcorr
