// Split-TF32 block product of K3 and K4 (gemm_tf32.cuh).
//
// Replaces the products inside the Pallas kernels of
// xcorr_tpu/ops/pallas_fft.py: plan_fused_corr_acc's pruned inverse and
// plan_fused_corr_full's stage A and pruned inverse. The TPU ran them on
// its matrix unit as bf16 hi/lo splits (_dot3; K4's w0/w1_/w2 terms);
// here they run on the tensor cores as mma.sync.m16n8k8 in TF32, three
// passes per product (lo*hi, hi*lo, hi*hi), float32 sums; or, for the
// precision 'default' (the TPU's one bf16 pass), hi*hi alone. The
// one-pass instance still loads and splits the lo parts' tiles: it is
// the three-pass kernel with two of its three products left out.
//
// Bound. At the pair-day's shape (B = 8, n1 = 528) K4's stage A is
// 2 x 8 products of (530 x 264) by (264 x 16384), 73.4 GFLOP, and the
// pruned inverse 8 of (99 x 530) by (530 x 16384), 13.75 GFLOP: 0.44 and
// 0.083 ms as three TF32 passes at 495 TFLOP/s. The inverse reads its
// 278 MB of C once (0.083 ms at 3.35 TB/s); stage A reads its 277 MB of
// windows once and writes 556 MB of planes (0.25 ms): both sit near the
// line between bytes and operations.
//
// Design. split_tf32 splits A, the small constant operand (w1 or wi),
// into hi and lo planes with rows padded to 16 bytes. The product:
// blocks of 256 threads (8 warps, 2 x 4, each 64 rows x 32 columns of a
// 128 x 128 output tile), two blocks per SM. The k axis goes in steps of
// 32 through two shared-memory stages, filled with 16-byte cp.async
// copies while the other is multiplied (B in 4-byte copies when N is not
// a multiple of 4); what lies outside M, K or N is zero-filled by the
// copy itself. A's fragments come in with ldmatrix, hi and lo ready; B's
// are read as scalars and split as they are read. Rows are padded (A by
// 4 floats, B by 8) so that no fragment read of a warp has a bank
// conflict. An m16 fragment wholly below M and a k8 step wholly past K
// are skipped (warp-uniform). blockIdx.x runs over the row tiles,
// fastest, so the row tiles that read one column slab of B run together:
// B is read from device memory once and reread from L2.
//
// Accumulation. The tensor cores round the float32 sum an mma returns
// toward zero. Fed the running sum, that error is biased and grows with
// K: 198 roundings over K = 528 put K4 1.6e-5 (relative to the largest
// output) off its plain version on an H100. So the three passes of each
// k8 step go into a zeroed fragment, and a float32 add, rounding to
// nearest, takes that into the running sum (the scheme of Ootomo and
// Yokota, "Recovering single precision accuracy from Tensor Cores while
// surpassing the FP32 theoretical peak performance", 2022).

#include <cstdint>

#include <cuda_runtime.h>

#include "gemm_tf32.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kAPitch = kBK + 4;  // floats a row of an A tile takes
constexpr int kBPitch = kBN + 8;  // floats a row of the B tile takes
constexpr int kATile = kBM * kAPitch;  // floats of one A tile (hi or lo)
constexpr int kStage = 2 * kATile + kBK * kBPitch;  // floats a stage
constexpr int kSmemBytes = 2 * kStage * static_cast<int>(sizeof(float));

// Asynchronous copy of BYTES (4 or 16) to shared memory; the src_bytes
// that are read (BYTES or 0) are followed by zeros.
template <int BYTES>
__device__ __forceinline__ void copy_zfill(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of copies is in flight.
__device__ __forceinline__ void wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The four 8 x 4 TF32 quarters of an m16k8 A fragment, rows from the
// lanes' addresses.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// d += a * b on one m16n8k8 tile, TF32 in, float32 accumulation.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi and lo of the (M, K) matrix A into two (M, K4) planes at out, zero
// in the padding columns K <= c < K4.
__global__ void split_kernel(const float* __restrict__ A, int M, int K,
                             int K4, float* __restrict__ out) {
  const size_t total = static_cast<size_t>(M) * K4;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = e / K4;
    const int c = static_cast<int>(e - r * K4);
    uint32_t hi, lo;
    split(c < K ? A[r * K + c] : 0.0f, hi, lo);
    out[e] = __uint_as_float(hi);
    out[total + e] = __uint_as_float(lo);
  }
}

// Start the copies of the k0 step's tiles: A's hi and lo rows m0..
// (kBM x kBK each, at as; lo at as + kATile) and B's rows k0.. (kBK x
// kBN, at bs). VB: 16-byte copies of B (N a multiple of 4).
template <bool VB>
__device__ __forceinline__ void load_stage(float* as, float* bs,
                                           const float* ah, size_t plane,
                                           int K4, const float* Bz, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / (4 * kThreads); ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (kBK / 4), c = e % (kBK / 4) * 4;
    const bool ok = m0 + r < M && k0 + c < K4;
    const float* src =
        ok ? ah + static_cast<size_t>(m0 + r) * K4 + k0 + c : ah;
    copy_zfill<16>(as + r * kAPitch + c, src, ok ? 16 : 0);
    copy_zfill<16>(as + kATile + r * kAPitch + c, ok ? src + plane : ah,
                   ok ? 16 : 0);
  }
  constexpr int CB = VB ? 4 : 1;  // floats a copy of B moves
#pragma unroll
  for (int i = 0; i < kBK * kBN / (CB * kThreads); ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (kBN / CB), c = e % (kBN / CB) * CB;
    const bool ok = k0 + r < K && n0 + c < N;
    const float* src =
        ok ? Bz + static_cast<size_t>(k0 + r) * N + n0 + c : Bz;
    copy_zfill<4 * CB>(bs + r * kBPitch + c, src, ok ? 4 * CB : 0);
  }
}

template <bool VB, int PASSES>
__global__ void __launch_bounds__(kThreads, 2)
gemm_tf32_kernel(const float* __restrict__ ah, int K4,
                 const float* __restrict__ Bm, size_t stride_b,
                 float* __restrict__ C, size_t stride_c, int M, int N,
                 int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // fragment row, column group
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const size_t plane = static_cast<size_t>(M) * K4;  // A's hi, then lo
  const float* Bz = Bm + blockIdx.z * stride_b;
  float* Cz = C + blockIdx.z * stride_c;
  const int steps = (K + kBK - 1) / kBK;
  // the A tile row and column whose address this lane gives ldmatrix:
  // lanes 8-15 and 24-31 the lower 8 rows, lanes 16-31 the right half
  const int a_row = wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load_stage<VB>(smem, smem + 2 * kATile, ah, plane, K4, Bz, M, N, K, m0,
                 n0, 0, tid);
  commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      float* next = smem + ((s + 1) & 1) * kStage;
      load_stage<VB>(next, next + 2 * kATile, ah, plane, K4, Bz, M, N, K,
                     m0, n0, (s + 1) * kBK, tid);
    }
    commit();
    wait_one();
    __syncthreads();
    const float* as = smem + (s & 1) * kStage;
    const float* bs = as + 2 * kATile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      if (s * kBK + kk >= K) break;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        split(bs[(kk + q) * kBPitch + c], bh[j][0], bl[j][0]);
        split(bs[(kk + q + 4) * kBPitch + c], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + wm * 64 + i * 16 >= M) break;
        const float* a = as + (a_row + i * 16) * kAPitch + kk + a_col;
        uint32_t fh[4], fl[4];
        ldmatrix_x4(fh, a);
        if constexpr (PASSES == 3) ldmatrix_x4(fl, a + kATile);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if constexpr (PASSES == 3) {
            mma(t, fl, bh[j]);
            mma(t, fh, bl[j]);
          }
          mma(t, fh, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
    __syncthreads();
  }

  // fragment element e of (i, j) is row g + 8 (e / 2), column 2q + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm * 64 + i * 16 + g;
      const int c = n0 + wn * 32 + j * 8 + 2 * q;
      if (c >= N) continue;
      if (r < M)
        *reinterpret_cast<float2*>(Cz + static_cast<size_t>(r) * N + c) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < M)
        *reinterpret_cast<float2*>(Cz + static_cast<size_t>(r + 8) * N +
                                   c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <bool VB, int PASSES>
int launch(const float* ah, int K4, const float* B, size_t stride_b,
           float* C, size_t stride_c, int M, int N, int K, int batch,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(gemm_tf32_kernel<VB, PASSES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, batch);
  gemm_tf32_kernel<VB, PASSES><<<grid, kThreads, kSmemBytes, stream>>>(
      ah, K4, B, stride_b, C, stride_c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int PASSES>
int dispatch(const float* split, int M, int K, const float* B,
             size_t stride_b, float* C, size_t stride_c, int N, int batch,
             cudaStream_t stream) {
  const int K4 = (K + 3) / 4 * 4;
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0)
    return launch<true, PASSES>(split, K4, B, stride_b, C, stride_c, M, N,
                                K, batch, stream);
  return launch<false, PASSES>(split, K4, B, stride_b, C, stride_c, M, N, K,
                               batch, stream);
}

}  // namespace

int xcorr::split_tf32(const float* A, int M, int K, float* split,
                      cudaStream_t stream) {
  const int K4 = (K + 3) / 4 * 4;
  const size_t blocks = (static_cast<size_t>(M) * K4 + 255) / 256;
  split_kernel<<<blocks < 1024 ? static_cast<int>(blocks) : 1024, 256, 0,
                 stream>>>(A, M, K, K4, split);
  return static_cast<int>(cudaGetLastError());
}

int xcorr::gemm_tf32(const float* split, int M, int K, const float* B,
                     size_t stride_b, float* C, size_t stride_c, int N,
                     int batch, int passes, cudaStream_t stream) {
  if (passes == 3)
    return dispatch<3>(split, M, K, B, stride_b, C, stride_c, N, batch,
                       stream);
  if (passes == 1)
    return dispatch<1>(split, M, K, B, stride_b, C, stride_c, N, batch,
                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
