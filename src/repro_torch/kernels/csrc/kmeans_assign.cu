// k-means assignment (the Lloyd E-step of the server's clustering step,
// paper Eq. 2), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kmeans_assign.py::_kernel  (via kmeans_assign)
//
// Per point n, over the K centroids c_k:
//   d_k = max(||x_n||^2 + ||c_k||^2 - 2 x_n . c_k, 0)
//   assign[n] = argmin_k d_k (ties go to the lowest k),  dist[n] = d_assign
// the expansion form and the clamp at 0 of the TPU kernel, so the rounding
// matches the plain version (kernels/kmeans_assign.py) term for term.
// x is (N, F) f32, cents (K, F) f32, K <= kMaxK; assign (N,) int32 and
// dist (N,) f32.
//
// What bounds it on the H100: at the clustering step's shape (N = 40
// clients, F = 3 * 784 = 2352 statistics, K = 2..5) one call reads 0.4 MB
// and does 0.5 MFLOP, about 0.1 us of either, so it costs its launch.  At
// large N it is bound by the bytes of x (each row read once) as long as K
// is small: 2K flops per 4 bytes read is far below the card's 20 flop/byte
// float32 balance.
//
// Why the design is simple: the TPU kernel hands a 128-row block of points
// to the MXU as one (BN, F) x (F, K) product.  Here one warp owns one point
// and its lanes stride over F, so each step of the walk is one coalesced
// 128-byte read of the row; each lane keeps its K partial dot products,
// its K partial ||c_k||^2 and its partial ||x||^2 in registers (K is
// bounded by the compile-time kMaxK, so the arrays stay in registers), and
// the lanes merge by warp shuffle before lane 0 takes the argmin.  The
// centroids are staged in shared memory in F-chunks of kChunk columns that
// all the block's warps share.  The block computes its own ragged edge (the
// last warp's rows past N idle through the loads and write nothing), so
// nothing is padded to 128 rows as the Pallas wrapper does.  Each warp
// recomputes ||c_k||^2, which doubles the FMAs but keeps one pass; tensor
// cores, several points per warp and cp.async staging are later work.
#include "common.cuh"

#include <cfloat>

namespace fedsikd {
namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;               // 8 warps = 8 points per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                 // F columns staged per pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ assign, float* __restrict__ dist,
                     long long N, int F, int K) {
  __shared__ float cs[kMaxK * kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const bool live = n < N;                  // uniform across the warp
  const float* xr = x + (live ? n : 0) * static_cast<long long>(F);

  float dot[kMaxK], cc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    dot[k] = 0.f;
    cc[k] = 0.f;
  }
  float xx = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int len = min(kChunk, F - f0);
    __syncthreads();                        // the previous chunk is consumed
    for (int i = threadIdx.x; i < K * kChunk; i += kThreads) {
      const int k = i / kChunk;
      const int j = i - k * kChunk;
      cs[i] = j < len ? c[static_cast<long long>(k) * F + f0 + j] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int j = lane; j < len; j += 32) {
        const float xv = xr[f0 + j];
        xx = fmaf(xv, xv, xx);
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) {
            const float cv = cs[k * kChunk + j];
            dot[k] = fmaf(xv, cv, dot[k]);
            cc[k] = fmaf(cv, cv, cc[k]);
          }
        }
      }
    }
  }
  if (!live) return;                        // no barrier follows

  xx = warp_sum(xx);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      dot[k] = warp_sum(dot[k]);
      cc[k] = warp_sum(cc[k]);
    }
  }
  if (lane != 0) return;
  int best = 0;
  float best_d = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      float d = (xx + cc[k]) - 2.0f * dot[k];
      d = d < 0.f ? 0.f : d;                // clamp at 0, NaN stays NaN
      if (k == 0 || d < best_d) {           // strict: ties keep the lower k
        best = k;
        best_d = d;
      }
    }
  }
  assign[n] = best;
  dist[n] = best_d;
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// x: (N, F) contiguous f32; cents: (K, F) contiguous f32, 1 <= K <= 16.
// Writes assign (N,) int32 and dist (N,) f32.  Returns cudaGetLastError().
extern "C" int fedsikd_kmeans_assign(const void* x, const void* cents,
                                     void* assign, void* dist, long long N,
                                     int F, int K, void* stream) {
  if (K < 1 || K > kMaxK || F < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>((N + kWarps - 1) / kWarps);
  kmeans_assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cents),
      static_cast<int*>(assign), static_cast<float*>(dist), N, F, K);
  return static_cast<int>(cudaGetLastError());
}
