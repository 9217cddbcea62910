// The block products of K3 and K4 (gemm_tf32.cu): stage A (K4) and the
// pruned inverse (K3, K4), on the tensor cores in split TF32.
//
//   C[z] = A @ B[z],  z < batch
//
// A is (M, K) row-major and contiguous (shared by every z);
// B[z] = B + z * stride_b is (K, N) row-major; C[z] = C + z * stride_c
// is (M, N) row-major; N is even. Each operand is split once, hi =
// tf32(a), lo = tf32(a - hi) (round to nearest, ties away): A by
// split_tf32 into a scratch of split_floats(M, K) floats, which
// gemm_tf32 reads, B as its fragments are read. Every output is one
// float32 sum, in ascending k, of k8 steps of lo*hi + hi*lo + hi*hi
// products (passes = 3): the dropped lo*lo term and lo's own rounding
// are ~2^-22 of a product, the order of a float32 product's rounding.
// passes = 1 keeps hi*hi alone, one TF32 product (precision 'default':
// ~2^-11 of a product). No atomics: a rerun gives the same bits.

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace xcorr {

// Floats of the scratch that holds A's hi and lo parts: two (M, K4)
// planes, K4 = K rounded up to a multiple of 4 (16-byte rows).
constexpr size_t split_floats(int M, int K) {
  return 2 * static_cast<size_t>(M) * ((K + 3) / 4 * 4);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success). split_tf32: A's hi and lo into split. gemm_tf32: the product
// with the A that split holds, in `passes` (1 or 3; anything else is
// cudaErrorInvalidValue) TF32 passes.
int split_tf32(const float* A, int M, int K, float* split,
               cudaStream_t stream);
int gemm_tf32(const float* split, int M, int K, const float* B,
              size_t stride_b, float* C, size_t stride_c, int N, int batch,
              int passes, cudaStream_t stream);

}  // namespace xcorr
