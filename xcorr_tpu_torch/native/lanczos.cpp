// Lanczos interpolation of the host chain (xcorr_tpu_torch/stream/
// _lanczos.py), in the order of operations of the carried numpy loop
// (stream/trace.py _lanczos_interp). The weights come from numpy, one
// row of 2a per phase: this file evaluates no sin. Built with
// -ffp-contract=off, so every product and sum rounds on its own, as
// numpy's do.
#include <cstdint>
#include <cstring>
#include <vector>

// The phase of each sample, pos - i0, keyed by its bits: keys[0..U) the
// distinct phases in order of first appearance and row[i] the row of
// sample i. Samples with -1 < pos < 0, where pos - i0 may round, get
// rows of their own, U + j, and their indices in near[0..nnear). Returns
// U, or -1 when U + nnear would pass max_rows (then nothing is valid).
extern "C" int64_t xcl_phases(const double* pos, const int64_t* i0,
                              int64_t npts, int64_t max_rows, double* keys,
                              int64_t* row, int64_t* near,
                              int64_t* nnear) {
  int64_t slots = 16;
  while (slots < 2 * max_rows) slots *= 2;
  std::vector<uint64_t> bits(slots);
  std::vector<int64_t> at(slots, -1);
  int64_t u = 0, m = 0;
  for (int64_t i = 0; i < npts; ++i) {
    const double p = pos[i];
    if (p > -1 && p < 0) {
      if (u + m + 1 > max_rows) return -1;
      near[m] = i;
      row[i] = -1 - m++;
      continue;
    }
    const double f = p - static_cast<double>(i0[i]);
    uint64_t b;
    std::memcpy(&b, &f, sizeof b);
    uint64_t h = (b * 0x9E3779B97F4A7C15ull) >> 17;
    for (;; ++h) {
      const int64_t s = static_cast<int64_t>(h & (slots - 1));
      if (at[s] < 0) {
        if (u + m + 1 > max_rows) return -1;
        bits[s] = b;
        keys[u] = f;
        at[s] = u++;
        row[i] = at[s];
        break;
      }
      if (bits[s] == b) {
        row[i] = at[s];
        break;
      }
    }
  }
  for (int64_t j = 0; j < m; ++j) row[near[j]] = u + j;
  *nnear = m;
  return u;
}

// For each output sample, taps k = -a+1 .. a in turn, each in-range tap
// adding x[idx] * w to the sum and w to the kernel mass, a zero weight
// included (inf * 0 is NaN, as in numpy); then the sum divided by the
// mass where the mass is > 0.
extern "C" void xcl_lanczos(const double* x, int64_t n, const int64_t* i0,
                            const int64_t* row, const double* w, int32_t a,
                            int64_t npts, double* out) {
  const int64_t taps = 2 * static_cast<int64_t>(a);
  for (int64_t i = 0; i < npts; ++i) {
    const double* wr = w + row[i] * taps;
    double sum = 0.0, mass = 0.0;
    for (int64_t j = 0; j < taps; ++j) {
      // i0 + k in numpy's wrapping int64 arithmetic
      const int64_t idx = static_cast<int64_t>(
          static_cast<uint64_t>(i0[i]) + static_cast<uint64_t>(j - a + 1));
      if (idx >= 0 && idx < n) {
        sum += x[idx] * wr[j];
        mass += wr[j];
      }
    }
    out[i] = mass > 0 ? sum / mass : sum;
  }
}
