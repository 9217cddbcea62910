// scipy.signal.sosfilt's loop (scipy/signal/_sosfilt.pyx, _sosfilt_float)
// over one float64 vector in place, from zero initial state, for the host
// chain's filter and decimate steps (xcorr_tpu_torch/stream/_sosfilt.py).
// Each section is direct form II transposed, with a0 == 1:
//
//   y  = b0*x + z0
//   z0 = (b1*x - a1*y) + z1
//   z1 = x*b2 - a2*y
//
// scipy runs every section on sample t before sample t + 1, so the
// sections' recurrences run one after another. Where the CPU has AVX2
// they overlap as a wavefront: four sections to a 256-bit register, and at
// step t section s works on sample t - L*s, taking the output section
// s - 1 gave L = 2 steps before, so that the shift of each register's
// outputs to the next sections' lanes is made a step before they are
// read, off the recurrence's path. Each section still takes its samples
// in order, through the same operations on the same operands, so the
// output has the same bits; only the schedule changes. A section does
// nothing before its first sample or after its last, so its state stays
// +0.0 until its first sample, as in scipy's loop. A CPU without AVX2, or
// a cascade of more than MAX_LANES sections, runs scipy's schedule.
//
// Built with -ffp-contract=off and without -ffast-math: every product and
// sum rounds on its own, and subnormal numbers are kept.
#include <cstdint>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

struct Section {
  double b0, b1, b2, a1, a2;
};

// a*b, a+b and a-b, each one instruction whose first source is a. IEEE
// leaves open which NaN an operation on two NaNs returns, and x86 returns
// its first source, so the operands keep the order of scipy's built loop
// (scipy 1.17: b0*x, b1*x, a1*y, x*b2 and a2*y, each sum and difference
// in the order written); a compiler may swap the operands of a * or +.
#if defined(__x86_64__)
inline double mul(double a, double b) {
  asm("mulsd %1, %0" : "+x"(a) : "x"(b));
  return a;
}
inline double add(double a, double b) {
  asm("addsd %1, %0" : "+x"(a) : "x"(b));
  return a;
}
inline double sub(double a, double b) {
  asm("subsd %1, %0" : "+x"(a) : "x"(b));
  return a;
}
#else
inline double mul(double a, double b) { return a * b; }
inline double add(double a, double b) { return a + b; }
inline double sub(double a, double b) { return a - b; }
#endif

inline double step(const Section& c, double x, double& z0, double& z1) {
  const double y = add(mul(c.b0, x), z0);
  z0 = add(sub(mul(c.b1, x), mul(c.a1, y)), z1);
  z1 = sub(mul(x, c.b2), mul(c.a2, y));
  return y;
}

// scipy's schedule: every section on sample t before sample t + 1
void plain(const Section* c, int64_t S, double* x, int64_t n) {
  std::vector<double> z0(S, 0.0), z1(S, 0.0);
  for (int64_t t = 0; t < n; ++t) {
    double v = x[t];
    for (int64_t s = 0; s < S; ++s) v = step(c[s], v, z0[s], z1[s]);
    x[t] = v;
  }
}

// ----------------------------------------------------------------- lanes

#if defined(__x86_64__)
#pragma GCC push_options
#pragma GCC target("avx2")

// the lane products, sums and differences, first source a (see mul)
inline __m256d vmul(__m256d a, __m256d b) {
  __m256d r;
  asm("vmulpd %2, %1, %0" : "=x"(r) : "x"(a), "x"(b));
  return r;
}
inline __m256d vadd(__m256d a, __m256d b) {
  __m256d r;
  asm("vaddpd %2, %1, %0" : "=x"(r) : "x"(a), "x"(b));
  return r;
}
inline __m256d vsub(__m256d a, __m256d b) {
  __m256d r;
  asm("vsubpd %2, %1, %0" : "=x"(r) : "x"(a), "x"(b));
  return r;
}

constexpr int64_t LAG = 2;

// V registers of four sections (lane s of the flat order is section s;
// lanes past the last section have zero coefficients and are never read).
template <int V>
struct Lanes {
  __m256d b0[V], b1[V], b2[V], a1[V], a2[V], z0[V], z1[V];

  // One step: y from the inputs in; where MASKED, only the lanes set in
  // m keep their new states.
  template <bool MASKED>
  inline void step(const __m256d* in, __m256d* y, const __m256d* m) {
#pragma GCC unroll 4
    for (int v = 0; v < V; ++v) {
      const __m256d yv = vadd(vmul(b0[v], in[v]), z0[v]);
      const __m256d n0 =
          vadd(vsub(vmul(b1[v], in[v]), vmul(a1[v], yv)), z1[v]);
      const __m256d n1 = vsub(vmul(in[v], b2[v]), vmul(a2[v], yv));
      z0[v] = MASKED ? _mm256_blendv_pd(z0[v], n0, m[v]) : n0;
      z1[v] = MASKED ? _mm256_blendv_pd(z1[v], n1, m[v]) : n1;
      y[v] = yv;
    }
  }
};

// The inputs of step t + LAG from the outputs y of step t: each lane the
// output of the lane below it, the first lane x.
template <int V>
inline void shift(const __m256d* y, double x, __m256d* in) {
  __m256d up[V];
#pragma GCC unroll 4
  for (int v = 0; v < V; ++v)
    up[v] = _mm256_permute4x64_pd(y[v], 0x93);  // lanes 3, 0, 1, 2
  in[0] = _mm256_blend_pd(up[0], _mm256_set1_pd(x), 1);
#pragma GCC unroll 4
  for (int v = 1; v < V; ++v) in[v] = _mm256_blend_pd(up[v], up[v - 1], 1);
}

template <int V>
inline double lane(const __m256d* y, int64_t s) {
  alignas(32) double out[4];
  _mm256_store_pd(out, y[s / 4]);
  return out[s % 4];
}

template <int V>
void lanes(const Section* c, int64_t S, double* x, int64_t n) {
  alignas(32) double k[5][4 * V] = {};
  for (int64_t s = 0; s < S; ++s) {
    k[0][s] = c[s].b0;
    k[1][s] = c[s].b1;
    k[2][s] = c[s].b2;
    k[3][s] = c[s].a1;
    k[4][s] = c[s].a2;
  }
  Lanes<V> L;
  for (int v = 0; v < V; ++v) {
    L.b0[v] = _mm256_load_pd(k[0] + 4 * v);
    L.b1[v] = _mm256_load_pd(k[1] + 4 * v);
    L.b2[v] = _mm256_load_pd(k[2] + 4 * v);
    L.a1[v] = _mm256_load_pd(k[3] + 4 * v);
    L.a2[v] = _mm256_load_pd(k[4] + 4 * v);
    L.z0[v] = L.z1[v] = _mm256_setzero_pd();
  }
  // the sample section S - 1 finishes at step t is t - last
  const int64_t last = LAG * (S - 1), steps = n + last;
  auto input = [&](int64_t t) { return t < n ? x[t] : 0.0; };
  // two chains of steps, even and odd, each fed by the other's outputs
  // LAG = 2 steps later
  __m256d in_a[V], in_b[V], y_a[V], y_b[V], m[V];
  for (int v = 0; v < V; ++v) y_a[v] = y_b[v] = _mm256_setzero_pd();
  shift<V>(y_a, input(0), in_a);
  shift<V>(y_b, input(1), in_b);
  auto mask = [&](int64_t t) {
    alignas(32) int64_t bits[4 * V];
    for (int64_t s = 0; s < 4 * V; ++s) {
      const int64_t i = t - LAG * s;
      bits[s] = s < S && i >= 0 && i < n ? -1 : 0;
    }
    for (int v = 0; v < V; ++v)
      m[v] = _mm256_castsi256_pd(_mm256_load_si256(
          reinterpret_cast<const __m256i*>(bits + 4 * v)));
  };
  for (int64_t t = 0; t < steps; t += 2) {
    if (t >= last && t + 1 < n) {
      // every section active in both steps
      L.template step<false>(in_a, y_a, m);
      x[t - last] = lane<V>(y_a, S - 1);
      shift<V>(y_a, input(t + 2), in_a);
      L.template step<false>(in_b, y_b, m);
      x[t + 1 - last] = lane<V>(y_b, S - 1);
      shift<V>(y_b, input(t + 3), in_b);
      continue;
    }
    mask(t);
    L.template step<true>(in_a, y_a, m);
    if (t >= last && t - last < n) x[t - last] = lane<V>(y_a, S - 1);
    shift<V>(y_a, input(t + 2), in_a);
    if (t + 1 == steps) break;
    mask(t + 1);
    L.template step<true>(in_b, y_b, m);
    if (t + 1 >= last && t + 1 - last < n)
      x[t + 1 - last] = lane<V>(y_b, S - 1);
    shift<V>(y_b, input(t + 3), in_b);
  }
}

#pragma GCC pop_options

bool has_avx2() { return __builtin_cpu_supports("avx2"); }
#else
bool has_avx2() { return false; }
#endif

// the longest cascade the lanes keep in registers (three of them)
constexpr int64_t MAX_LANES = 12;

void filter(const double* sos, int64_t S, double* x, int64_t n) {
  if (S <= 0 || n <= 0) return;
  std::vector<Section> c(S);
  for (int64_t s = 0; s < S; ++s) {
    const double* r = sos + 6 * s;
    c[s] = {r[0], r[1], r[2], r[4], r[5]};
  }
#if defined(__x86_64__)
  if (S <= MAX_LANES && has_avx2()) {
    if (S <= 4) return lanes<1>(c.data(), S, x, n);
    if (S <= 8) return lanes<2>(c.data(), S, x, n);
    return lanes<3>(c.data(), S, x, n);
  }
#endif
  plain(c.data(), S, x, n);
}

}  // namespace

// Filters x[0..n) in place through the n_sections rows of sos, each
// (b0, b1, b2, a0, a1, a2) with a0 == 1, from zero initial state: on
// lanes where the CPU has AVX2 and n_sections <= MAX_LANES, else on
// scipy's schedule.
extern "C" void xcs_sosfilt(const double* sos, int64_t n_sections, double* x,
                            int64_t n) {
  filter(sos, n_sections, x, n);
}

// Whether xcs_sosfilt runs on lanes on this CPU (up to MAX_LANES
// sections).
extern "C" int xcs_lanes() { return has_avx2() ? 1 : 0; }
