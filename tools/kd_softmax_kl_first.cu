// The first design of the KD loss kernels (one warp a row in the forward,
// one thread an element in the backward), kept unchanged below this note so
// that tools/kd_first.py can build it beside the port's kernels and time
// both on the same inputs in one process.  Its C entry points are renamed
// at build time (fedsikd_kd_first_fwd, fedsikd_kd_first_bwd).  The helpers
// it took from the port's csrc/common.cuh are copied in here, so that it
// builds alone whatever becomes of that header.
//
// Fused temperature-softmax KL + CE distillation loss, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/kd_softmax_kl.py::_fwd_kernel  (via kd_loss_fwd)
//   src/repro/kernels/kd_softmax_kl.py::_bwd_kernel  (via kd_loss_bwd)
//
// Per token (row) the loss is
//   ((1-alpha) CE(s, y) + alpha tau^2 KL(softmax(t/tau) || softmax(s/tau))) * [y >= 0]
// with KL = U / l_t + logZ_s - logZ_t, U = sum_j exp(t_j/tau - m_t) (t_j - s_j)/tau,
// the same identity the TPU kernel uses.  The forward also writes
// (logZ_t, logZ_s, logZ_1) per row, from which the backward recomputes the
// three softmaxes:
//   ds = g [(1-alpha)(softmax(s) - onehot(y)) + alpha tau (softmax(s/tau) - softmax(t/tau))] [y >= 0]
//
// What bounds it on the H100: bytes.  The forward reads each logit of s and
// t once and does a few exponentials per element; the backward reads s and t
// and writes ds.  At the shapes of the federated main path (T = 64 rows,
// V = 10 classes) one call moves about 6 KB, which the card streams in
// nanoseconds, so a call costs what its launch costs.
//
// Why the design is simple: the TPU kernel walks vocab blocks in a
// sequential grid and carries the online max/sum in VMEM scratch.  Here one
// warp owns one row and walks V itself with stride 32, so the state lives in
// registers and no block ever waits on another: each lane keeps its own
// online (max, sum) for the three softmaxes plus U and the label logit, and
// the lanes merge by warp shuffle at the end.  The ragged vocab edge is
// masked by the loop bound, so no -1e30 padding is needed.  The backward is
// one thread per (row, column) element over the flattened (T*V) grid, which
// has no idle lanes for small V and no grid-dimension limit for large T.
// Faster forms (vectorised 16-byte loads, several rows per warp for small V,
// one launch for forward and backward) are left to later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace fedsikd {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 256;   // 8 warps = 8 rows per block
constexpr int kBwdThreads = 256;

// One element into a lane's online (max, sum) softmax state.
__device__ __forceinline__ void online(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// The teacher's state also carries U, rescaled with the same factor as l.
__device__ __forceinline__ void online_u(float& m, float& l, float& u, float x,
                                         float d) {
  if (x > m) {
    const float sc = expf(m - x);
    l = l * sc + 1.0f;
    u = u * sc + d;
    m = x;
  } else {
    const float e = expf(x - m);
    l += e;
    u += e * d;
  }
}

// Merge lane states across the warp (butterfly: every lane ends with the
// row's totals).
__device__ __forceinline__ void warp_merge(float& m, float& l) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
  }
}

__device__ __forceinline__ void warp_merge_u(float& m, float& l, float& u) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    const float u2 = __shfl_xor_sync(kFull, u, off);
    const float mn = fmaxf(m, m2);
    const float a = expf(m - mn), b = expf(m2 - mn);
    l = l * a + l2 * b;
    u = u * a + u2 * b;
    m = mn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
kd_fwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
              const int* __restrict__ y, float* __restrict__ loss,
              float* __restrict__ stats, long long rows, int V, float tau,
              float alpha) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kFwdThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp: the shuffles below stay full
  const T* sr = s + row * V;
  const T* tr = t + row * V;
  const int label = y[row];

  float m_t = kNeg, l_t = 0.f, u_t = 0.f;
  float m_s = kNeg, l_s = 0.f;
  float m_1 = kNeg, l_1 = 0.f;
  float picked = 0.f;
  for (int j = lane; j < V; j += 32) {
    const float sv = to_f32(sr[j]);
    const float tv = to_f32(tr[j]);
    online_u(m_t, l_t, u_t, tv / tau, (tv - sv) / tau);
    online(m_s, l_s, sv / tau);
    online(m_1, l_1, sv);
    if (j == label) picked += sv;
  }
  warp_merge_u(m_t, l_t, u_t);
  warp_merge(m_s, l_s);
  warp_merge(m_1, l_1);
  for (int off = 16; off > 0; off >>= 1) picked += __shfl_xor_sync(kFull, picked, off);

  if (lane == 0) {
    const float logz_t = m_t + logf(l_t);
    const float logz_s = m_s + logf(l_s);
    const float logz_1 = m_1 + logf(l_1);
    const float kl = u_t / l_t + logz_s - logz_t;
    const float ce = logz_1 - picked;
    const float valid = label >= 0 ? 1.f : 0.f;
    loss[row] = ((1.f - alpha) * ce + alpha * tau * tau * kl) * valid;
    stats[row * 3 + 0] = logz_t;
    stats[row * 3 + 1] = logz_s;
    stats[row * 3 + 2] = logz_1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
kd_bwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
              const int* __restrict__ y, const float* __restrict__ stats,
              const float* __restrict__ g, T* __restrict__ ds, long long rows,
              int V, float tau, float alpha) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx >= rows * V) return;
  const long long row = idx / V;
  const int col = static_cast<int>(idx - row * V);
  const int label = y[row];
  const float sv = to_f32(s[idx]);
  const float tv = to_f32(t[idx]);
  const float p1 = expf(sv - stats[row * 3 + 2]);
  const float ps = expf(sv / tau - stats[row * 3 + 1]);
  const float pt = expf(tv / tau - stats[row * 3 + 0]);
  const float onehot = col == label ? 1.f : 0.f;
  const float valid = label >= 0 ? 1.f : 0.f;
  const float d = (1.f - alpha) * (p1 - onehot) + (alpha * tau) * (ps - pt);
  ds[idx] = from_f32<T>(g[row] * d * valid);
}

template <typename T>
void launch_fwd(const void* s, const void* t, const int* y, float* loss,
                float* stats, long long rows, int V, float tau, float alpha,
                cudaStream_t stream) {
  const long long per_block = kFwdThreads / 32;
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
  kd_fwd_kernel<T><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(t), y, loss, stats, rows,
      V, tau, alpha);
}

template <typename T>
void launch_bwd(const void* s, const void* t, const int* y, const float* stats,
                const float* g, void* ds, long long rows, int V, float tau,
                float alpha, cudaStream_t stream) {
  const long long n = rows * V;
  const unsigned grid = static_cast<unsigned>((n + kBwdThreads - 1) / kBwdThreads);
  kd_bwd_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(t), y, stats, g,
      static_cast<T*>(ds), rows, V, tau, alpha);
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// s, t: (rows, V) contiguous, dtype code `dtype`; y: (rows,) int32.
// Writes loss (rows,) f32 and stats (rows, 3) f32.  Returns cudaGetLastError().
extern "C" int fedsikd_kd_fwd(const void* s, const void* t, const void* y,
                              void* loss, void* stats, long long rows, int V,
                              int dtype, float tau, float alpha, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const int*>(y);
  auto* lo = static_cast<float*>(loss);
  auto* sta = static_cast<float*>(stats);
  switch (dtype) {
    case kF32: launch_fwd<float>(s, t, yy, lo, sta, rows, V, tau, alpha, st); break;
    case kBF16: launch_fwd<__nv_bfloat16>(s, t, yy, lo, sta, rows, V, tau, alpha, st); break;
    case kF16: launch_fwd<__half>(s, t, yy, lo, sta, rows, V, tau, alpha, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// s, t: (rows, V); y: (rows,) int32; stats: (rows, 3) f32; g: (rows,) f32.
// Writes ds (rows, V) in the dtype of s.  Returns cudaGetLastError().
extern "C" int fedsikd_kd_bwd(const void* s, const void* t, const void* y,
                              const void* stats, const void* g, void* ds,
                              long long rows, int V, int dtype, float tau,
                              float alpha, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const int*>(y);
  const auto* sta = static_cast<const float*>(stats);
  const auto* gg = static_cast<const float*>(g);
  switch (dtype) {
    case kF32: launch_bwd<float>(s, t, yy, sta, gg, ds, rows, V, tau, alpha, st); break;
    case kBF16: launch_bwd<__nv_bfloat16>(s, t, yy, sta, gg, ds, rows, V, tau, alpha, st); break;
    case kF16: launch_bwd<__half>(s, t, yy, sta, gg, ds, rows, V, tau, alpha, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
