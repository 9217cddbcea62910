// The whole four-step correlation in one kernel (ops/fused_fft.py, K4).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::
// plan_fused_corr_full (kernel): stage A, the stage-B correlation and the
// pruned inverse. For every window b:
//
//   Ax[b] = w1 @ vx[b],  Ay[b] = w1 @ vy[b]     (2H, N2), re rows then im
//   out[b] = wi @ K1(Ax[b], Ay[b], T)           (rows_out, N2)
//
// Layout: vx, vy are the zero-padded windows viewed (B, rows_in, N2)
// float32; w1 is the (2H, rows_in) stage-A matrix, T (2, H, N2), wi the
// (rows_out, 2H) folded inverse matrix, out (B, rows_out, N2).
//
// Design (corr_acc.cuh). Block (s, b) takes the k1 group s of window b.
// Stage A: two block products, its 2G rows of w1 against the window of
// each signal, into a device scratch (B, S, 2G, N2) per signal. Then
// K3's group step: the K1 chain per row, each C row written over the x
// row it came from, and the product with its columns of wi into its
// partial; a second launch sums the S partials in ascending s. Every
// block of a window reads the whole window (17.3 MB per signal); blocks
// run group-fastest, so a window's 16 blocks run together and sweep its
// columns in step, and L2 serves most of those reads. Stage A runs in
// float32 FMAs on the CUDA cores: the TPU's bf16 hi/lo input split (its
// MXU precision workaround) is not carried, nor ROWS = 8 or the VMEM
// gate. There is no TF32 anywhere.
//
// Bound. Per 24 h window (rows_in = 528, H = 529, N2 = 8192, rows_out =
// 198): 34.6 MB in and 6.5 MB out; 18.3 GFLOP of stage A, ~1 GFLOP of
// transforms and 3.43 GFLOP of product: compute-bound (~0.34 ms at
// 67 TFLOP/s). The design adds the stage-A scratch (69.3 MB written and
// read), the L2 re-reads of the window and the S partials per window.

#include <cuda_runtime.h>

#include "corr_acc.cuh"

namespace {

__global__ void __launch_bounds__(xcorr::kAccThreads)
fused_corr_full_kernel(const float* __restrict__ vx,
                       const float* __restrict__ vy,
                       const float* __restrict__ w1,
                       const float* __restrict__ T,
                       const float2* __restrict__ tw,
                       const float* __restrict__ wi, float* __restrict__ sx,
                       float* __restrict__ sy, float* __restrict__ part,
                       int H, int G, int rows_in, int rows_out, int n,
                       int log2n) {
  extern __shared__ float2 smem[];
  float2* ws = smem;
  float2* work = smem + n / 2;

  const int s = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int k0 = s * G;
  const int g = min(G, H - k0);
  const size_t blk = static_cast<size_t>(b) * S + s;
  float* ax = sx + blk * 2 * G * n;
  float* ay = sy + blk * 2 * G * n;
  const size_t win = static_cast<size_t>(b) * rows_in * n;

  xcorr::load_twiddles(ws, tw, n);
  // stage A of the group: row m < g is Re row k0+m, row g+m its Im row
  const auto w1_row = [=](int m) {
    return static_cast<size_t>(m < g ? k0 + m : H + k0 + m - g) * rows_in;
  };
  for (int sig = 0; sig < 2; ++sig) {
    const float* v = (sig == 0 ? vx : vy) + win;
    float* a = sig == 0 ? ax : ay;
    xcorr::gemm(
        2 * g, n, rows_in,
        [=](int m, int k) { return w1[w1_row(m) + k]; },
        [=](int k, int c) { return v[static_cast<size_t>(k) * n + c]; },
        [=](int m, int c, float val) {
          a[static_cast<size_t>(m) * n + c] = val;
        },
        reinterpret_cast<float*>(work));
  }
  const size_t ig = static_cast<size_t>(g) * n;
  xcorr::group_corr_acc(ax, ax + ig, ay, ay + ig, T, ws, wi, ax,
                        part + blk * rows_out * n, H, k0, g, rows_out, n,
                        log2n, work);
}

}  // namespace

// Launch on `stream`; return the first CUDA error (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 8192, S = ceil(H / G),
// contiguous float32 buffers of the documented shapes, sx and sy of
// B*S*2G*n floats each and part of B*S*rows_out*n floats.
extern "C" int xc_fused_corr_full(const void* vx, const void* vy,
                                  const void* w1, const void* T,
                                  const void* tw, const void* wi, void* sx,
                                  void* sy, void* part, void* out, int B,
                                  int H, int G, int S, int rows_in,
                                  int rows_out, int n, int log2n,
                                  void* stream) {
  const int smem = xcorr::acc_smem_bytes(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_corr_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_corr_full_kernel<<<dim3(S, B), xcorr::kAccThreads, smem, st>>>(
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(w1), static_cast<const float*>(T),
      static_cast<const float2*>(tw), static_cast<const float*>(wi),
      static_cast<float*>(sx), static_cast<float*>(sy),
      static_cast<float*>(part), H, G, rows_in, rows_out, n, log2n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return xcorr::launch_sum_partials(
      static_cast<const float*>(part), static_cast<float*>(out), B, S,
      static_cast<size_t>(rows_out) * n, st);
}
