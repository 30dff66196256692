// Fused grouped weighted-mean merge with staleness decay, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_merge.py::_kernel  (via fused_merge)
//
//   out[d] = sum_n w_n (1+s_n)^-decay x[n, d] / sum_m w_m (1+s_m)^-decay
//
// x is (N, D) in f32, bf16 or f16; w and s are (N,) f32; out is (D,) f32.
//
// What bounds it on the H100: bytes.  It reads x once (N*D elements) and
// writes D floats, with one multiply-add per element read.  On the
// federated main path N = 40 clients and D is one leaf of the MNIST student
// (10 to 9216 floats), so a round's ten merges read 3.06 MB, about 0.9 us at
// 3.35 TB/s: each launch costs far more than its bytes.
//
// Why the design is simple: the TPU kernel recomputes the normalised weight
// vector for every D block it visits in its sequential grid.  Here every
// block does the same: it first reduces the decayed weight total, then walks
// N in chunks of blockDim weights staged in shared memory, and each thread
// owns one column d and accumulates sum_n w_n' x[n, d] in a float32
// register.  Neighbouring threads read neighbouring columns, so each row
// chunk is one coalesced read.  No atomics and no second pass: the output
// is deterministic.  One launch for all leaves of a model, and a split of N
// across blocks when D is small, are left to later work.
#include "common.cuh"

namespace fedsikd {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float decayed(const float* w, const float* s, int n,
                                         float decay) {
  return w[n] * powf(1.0f + s[n], -decay);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_merge_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ out, int N,
                   long long D, float decay) {
  __shared__ float wn[kThreads];
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total_s;

  // 1. the decayed weight total (every block computes it; N is small)
  float part = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) part += decayed(w, s, n, decay);
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) tot += warp_sums[i];
    total_s = tot;
  }
  __syncthreads();
  const float total = total_s;

  // 2. one column per thread, N walked in shared-memory chunks of weights
  const long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.f;
  for (int n0 = 0; n0 < N; n0 += kThreads) {
    const int n = n0 + threadIdx.x;
    if (n < N) wn[threadIdx.x] = decayed(w, s, n, decay) / total;
    __syncthreads();
    const int cnt = min(kThreads, N - n0);
    if (d < D) {
      const T* col = x + static_cast<long long>(n0) * D + d;
      for (int k = 0; k < cnt; ++k) acc = fmaf(wn[k], to_f32(col[k * D]), acc);
    }
    __syncthreads();
  }
  if (d < D) out[d] = acc;
}

template <typename T>
void launch(const void* x, const float* w, const float* s, float* out, int N,
            long long D, float decay, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  fused_merge_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, s, out, N, D, decay);
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// x: (N, D) contiguous, dtype code `dtype`; w, s: (N,) f32; out: (D,) f32.
// Returns cudaGetLastError().
extern "C" int fedsikd_fused_merge(const void* x, const void* w, const void* s,
                                   void* out, int N, long long D, int dtype,
                                   float decay, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ww = static_cast<const float*>(w);
  const auto* ss = static_cast<const float*>(s);
  auto* o = static_cast<float*>(out);
  switch (dtype) {
    case kF32: launch<float>(x, ww, ss, o, N, D, decay, st); break;
    case kBF16: launch<__nv_bfloat16>(x, ww, ss, o, N, D, decay, st); break;
    case kF16: launch<__half>(x, ww, ss, o, N, D, decay, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
