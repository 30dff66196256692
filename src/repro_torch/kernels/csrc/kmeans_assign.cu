// k-means assignment (the Lloyd E-step of the server's clustering step,
// paper Eq. 2), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kmeans_assign.py::_kernel  (via kmeans_assign)
//
// Per point n, over the K centroids c_k:
//   d_k = max((||x_n||^2 + ||c_k||^2) - 2 x_n . c_k, 0)
//   assign[n] = argmin_k d_k (strict <: ties go to the lowest k),
//   dist[n] = d_assign
// the expansion form and the clamp at 0 of the TPU kernel, as the plain
// version (kernels/kmeans_assign.py) computes it.  x is (N, F) f32, cents
// (K, F) f32, 1 <= K <= kMaxK; assign (N,) int32 and dist (N,) f32.
//
// What bounds it on the H100: at the clustering step's shape (N = 40
// clients, F = 3 * 784 = 2352 statistics, K = 2..5) one call reads 0.4 MB,
// about 0.13 us, so latency decides; at large N the bytes of x (each row
// read once: 2K flops per 4 bytes is far below the card's float32 balance).
// The first design (8 points a block, F walked in 10 chunks with two
// barriers and a fresh load of the centroid chunk each, ||c_k||^2
// recomputed by every warp) ran 5 blocks at N = 40 (24.6 us) and 21 % of
// the bytes bound at N = 16384.  Two shapes of work now, chosen by
// kernels/kmeans_assign.py::plan (one launch a call either way):
//
//  - split (small N): F is cut into kCluster slices, one per block of a
//    thread-block cluster; each block takes kPoints points (a warp each)
//    on its slice and computes ||c_k||^2 of its slice once.  The cluster's
//    rank-0 block reads the other blocks' partial sums from their shared
//    memory (distributed shared memory) in rank order, then clamps and
//    takes the argmin.  No atomics, no scratch in device memory; at N = 40
//    the grid is 10 clusters of 8 blocks (80 SMs busy where 5 were).
//  - stream (large N): all K x F centroids go into dynamic shared memory
//    once a block (cp.async) with ||c_k||^2; persistent blocks, a few an
//    SM, walk the points, each warp two points at a time (every centroid
//    read from shared memory serves both) with 16-byte loads of x and no
//    barrier inside the walk.
//
// F not divisible by 4, or rows not 16-byte aligned, take scalar loads.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace fedsikd {
namespace {

constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// split regime: blocks a cluster (the portable size), points a block
constexpr int kCluster = 8;
constexpr int kPoints = 4;
constexpr int kSplitThreads = 32 * kPoints;
constexpr int kPart = kMaxK + 1;            // x.c_0 .. x.c_{K-1}, then ||x||^2
// stream regime: warps a block, points a warp walks together
constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The clamped distances' strict argmin (ties keep the lower k).
template <int KB>
__device__ __forceinline__ void pick(float xx, const float* cc,
                                     const float* dot, int K, int* assign,
                                     float* dist, long long n) {
  int best = 0;
  float best_d = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      float d = (xx + cc[k]) - 2.0f * dot[k];
      d = d < 0.f ? 0.f : d;                // clamp at 0, NaN stays NaN
      if (k == 0 || d < best_d) {
        best = k;
        best_d = d;
      }
    }
  }
  assign[n] = best;
  dist[n] = best_d;
}

// ---------------------------------------------------------------- split
template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSplitThreads)
kmeans_assign_split_kernel(const float* __restrict__ x,
                           const float* __restrict__ c,
                           int* __restrict__ assign, float* __restrict__ dist,
                           long long N, int F, int K, int slice_len) {
  __shared__ float part[kPoints * kPart];   // this block's partial sums
  __shared__ float cc_part[kMaxK];          // ||c_k||^2 over this slice
  __shared__ float total[kPoints * kPart + kMaxK];   // rank 0: the sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long group = blockIdx.x / kCluster;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = rank * slice_len;
  const int len = max(0, min(slice_len, F - f0));

  // 1. ||c_k||^2 over the slice, once for the block (warp q: k = q, q + 4..)
  for (int k = warp; k < K; k += kPoints) {
    const float* cr = c + static_cast<long long>(k) * F + f0;
    float acc = 0.f;
    if (kVec) {
      for (int j = lane; j < len / 4; j += 32) {
        const float4 v = ld4(cr + 4 * j);
        acc = dot4(v, v, acc);
      }
    } else {
      for (int j = lane; j < len; j += 32) acc = fmaf(cr[j], cr[j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) cc_part[k] = acc;
  }

  // 2. this warp's point on the slice: x . c_k and ||x||^2
  const long long n = group * kPoints + warp;
  float dot[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) dot[k] = 0.f;
  float xx = 0.f;
  if (n < N) {                              // uniform across the warp
    const float* xr = x + n * F + f0;
    const float* cb = c + f0;
    if (kVec) {
#pragma unroll 2
      for (int j = lane; j < len / 4; j += 32) {
        const float4 xv = ld4(xr + 4 * j);
        xx = dot4(xv, xv, xx);
#pragma unroll
        for (int k = 0; k < kMaxK; ++k)
          if (k < K)
            dot[k] = dot4(xv, ld4(cb + static_cast<long long>(k) * F + 4 * j),
                          dot[k]);
      }
    } else {
      for (int j = lane; j < len; j += 32) {
        const float xv = xr[j];
        xx = fmaf(xv, xv, xx);
#pragma unroll
        for (int k = 0; k < kMaxK; ++k)
          if (k < K) dot[k] = fmaf(xv, cb[static_cast<long long>(k) * F + j], dot[k]);
      }
    }
  }
  xx = warp_sum(xx);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) dot[k] = warp_sum(dot[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) part[warp * kPart + k] = dot[k];
    part[warp * kPart + kMaxK] = xx;
  }
  cluster.sync();                           // every slice's partials are out

  // 3. rank 0 adds the slices' partials in rank order, then takes the argmin
  if (rank == 0) {
    for (int i = threadIdx.x; i < kPoints * kPart + kMaxK; i += kSplitThreads) {
      const bool is_cc = i >= kPoints * kPart;
      const int j = is_cc ? i - kPoints * kPart : i % kPart;
      if (j < K || (!is_cc && j == kMaxK)) {
        float* src = is_cc ? cc_part + j : part + i;
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) acc += *cluster.map_shared_rank(src, r);
        total[i] = acc;
      }
    }
    __syncthreads();
    const long long p = group * kPoints + threadIdx.x;
    if (threadIdx.x < kPoints && p < N) {
      const float* t = total + threadIdx.x * kPart;
      pick<kMaxK>(t[kMaxK], total + kPoints * kPart, t, K, assign, dist, p);
    }
  }
  cluster.sync();           // keep every block's shared memory until read
}

// --------------------------------------------------------------- stream
template <bool kVec, int KB>
__global__ void __launch_bounds__(kStreamThreads)
kmeans_assign_stream_kernel(const float* __restrict__ x,
                            const float* __restrict__ c,
                            int* __restrict__ assign,
                            float* __restrict__ dist, long long N, int F,
                            int K) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                         // (K, F) centroids
  float* ccs = smem + static_cast<long long>(K) * F;   // (K,) ||c_k||^2
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int KF = K * F;

  // 1. the centroids into shared memory, once a block
  if (kVec) {
    for (int i = threadIdx.x; i < KF / 4; i += kStreamThreads)
      cp_async16(cs + 4 * i, c + 4 * i);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < KF; i += kStreamThreads) cs[i] = c[i];
  }
  __syncthreads();
  // 2. ||c_k||^2, once a block
  for (int k = warp; k < K; k += kStreamWarps) {
    float acc = 0.f;
    for (int j = lane; j < F; j += 32) {
      const float v = cs[k * F + j];
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) ccs[k] = acc;
  }
  __syncthreads();
  float cc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) cc[k] = k < K ? ccs[k] : 0.f;

  // 3. the warps walk point pairs (2q, 2q + 1); no barrier from here on
  const long long pairs = (N + 1) / 2;
  for (long long q = static_cast<long long>(blockIdx.x) * kStreamWarps + warp;
       q < pairs; q += static_cast<long long>(gridDim.x) * kStreamWarps) {
    const long long na = 2 * q;
    const bool has_b = na + 1 < N;
    const float* xa = x + na * F;
    const float* xb = has_b ? xa + F : xa;
    float da[KB], db[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) da[k] = db[k] = 0.f;
    float xxa = 0.f, xxb = 0.f;
    if (kVec) {
#pragma unroll 2
      for (int j = lane; j < F / 4; j += 32) {
        const float4 va = ld4(xa + 4 * j);
        const float4 vb = ld4(xb + 4 * j);
        xxa = dot4(va, va, xxa);
        xxb = dot4(vb, vb, xxb);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k < K) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + k * F + 4 * j);
            da[k] = dot4(va, cv, da[k]);
            db[k] = dot4(vb, cv, db[k]);
          }
        }
      }
    } else {
      for (int j = lane; j < F; j += 32) {
        const float va = xa[j], vb = xb[j];
        xxa = fmaf(va, va, xxa);
        xxb = fmaf(vb, vb, xxb);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k < K) {
            const float cv = cs[k * F + j];
            da[k] = fmaf(va, cv, da[k]);
            db[k] = fmaf(vb, cv, db[k]);
          }
        }
      }
    }
    xxa = warp_sum(xxa);
    xxb = warp_sum(xxb);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        da[k] = warp_sum(da[k]);
        db[k] = warp_sum(db[k]);
      }
    }
    if (lane == 0) pick<KB>(xxa, cc, da, K, assign, dist, na);
    if (lane == 1 && has_b) pick<KB>(xxb, cc, db, K, assign, dist, na + 1);
  }
}

template <bool kVec, int KB>
int launch_stream(const float* x, const float* c, int* a, float* d,
                  long long N, int F, int K, int grid, cudaStream_t st) {
  const int bytes = (K * F + K) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {                  // above the default limit
    const cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_stream_kernel<kVec, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kmeans_assign_stream_kernel<kVec, KB><<<grid, kStreamThreads, bytes, st>>>(
      x, c, a, d, N, F, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_stream_k(const float* x, const float* c, int* a, float* d,
                    long long N, int F, int K, int grid, cudaStream_t st) {
  if (K <= 4) return launch_stream<kVec, 4>(x, c, a, d, N, F, K, grid, st);
  if (K <= 8) return launch_stream<kVec, 8>(x, c, a, d, N, F, K, grid, st);
  return launch_stream<kVec, 16>(x, c, a, d, N, F, K, grid, st);
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// x: (N, F) contiguous f32; cents: (K, F) contiguous f32, 1 <= K <= 16.
// Writes assign (N,) int32 and dist (N,) f32.  regime 0 (split): grid =
// kCluster * ceil(N / kPoints) blocks, slices of slice_len columns (a
// multiple of 4); regime 1 (stream): grid persistent blocks.  vec: 1 if F
// is a multiple of 4 and x, cents are 16-byte aligned.  Returns
// cudaGetLastError() (or the error of a refused attribute).
extern "C" int fedsikd_kmeans_assign(const void* x, const void* cents,
                                     void* assign, void* dist, long long N,
                                     int F, int K, int regime, int grid,
                                     int slice_len, int vec, void* stream) {
  if (K < 1 || K > kMaxK || F < 1 || N < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xx = static_cast<const float*>(x);
  const auto* cc = static_cast<const float*>(cents);
  auto* a = static_cast<int*>(assign);
  auto* d = static_cast<float*>(dist);
  const auto st = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    const long long groups = (N + kPoints - 1) / kPoints;
    if (grid != groups * kCluster || slice_len < 1 || slice_len % 4 ||
        static_cast<long long>(slice_len) * kCluster < F)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec)
      kmeans_assign_split_kernel<true><<<grid, kSplitThreads, 0, st>>>(
          xx, cc, a, d, N, F, K, slice_len);
    else
      kmeans_assign_split_kernel<false><<<grid, kSplitThreads, 0, st>>>(
          xx, cc, a, d, N, F, K, slice_len);
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != 1) return static_cast<int>(cudaErrorInvalidValue);
  return vec ? launch_stream_k<true>(xx, cc, a, d, N, F, K, grid, st)
             : launch_stream_k<false>(xx, cc, a, d, N, F, K, grid, st);
}
