// Fused stage-B correlation of the four-step CC (ops/fused_fft.py, K1).
//
// Replaces the Pallas kernel xcorr_tpu/ops/pallas_fft.py::plan_fused_corr
// (corr_kernel). For one (b, k1) row of the packed stage-A planes:
//
//   C[b,k1,:] = IDFT_N2( DFT_N2(Ax[b,k1,:]*T[k1,:])
//                        * conj(DFT_N2(Ay[b,k1,:]*T[k1,:])) ) * conj(T[k1,:])
//
// in natural n2 order, for every power of two 2 <= N2 <= 16384. The row
// chain, its layouts, its bound and its design are in corr_rows.cuh,
// which K3 and K4 share; this file holds K1's two entry points.

#include <cuda_runtime.h>

#include "corr_rows.cuh"

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller guarantees n = 2^log2n with 2 <= n <= 16384, tw from
// _k1_twiddles(n) and contiguous float32 buffers of the documented shapes.
extern "C" int xc_fused_corr(const void* ax, const void* ay, const void* T,
                             const void* tw, void* out, int B, int H, int n,
                             int log2n, void* stream) {
  return corr_rows(ax, ay, T, tw, out, B, H, n, log2n,
                   static_cast<cudaStream_t>(stream));
}

// xc_fused_corr with the phase clock: phases holds 8 zeroed int64 per
// resident block (at most B * H blocks).
extern "C" int xc_fused_corr_phases(const void* ax, const void* ay,
                                    const void* T, const void* tw, void* out,
                                    int B, int H, int n, int log2n,
                                    void* stream, void* phases) {
  if (log2n < 1 || log2n > 14 || n != 1 << log2n)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch<true>[log2n](ax, ay, T, tw, out, B, H,
                              static_cast<cudaStream_t>(stream), phases);
}
