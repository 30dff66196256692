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
// What bounds it on the H100: at an LLM vocabulary with many rows, bytes
// (the forward reads each logit of s and t once, the backward reads s and
// t and writes ds); with few rows, the exponentials of the SMs that hold
// one row each; at the packed FedSiKD path's (2560, 10), where a call
// moves 0.2 MB, its latency.
//
// Arithmetic, the same in every shape of work:
//  - base 2: every exponential is ex2 of one fma, on logits prescaled by
//    c = log2(e)/tau (the host computes c and 1/tau in double precision),
//    so no element pays a division;
//  - the online softmax moves per chunk of 16 elements a thread, not per
//    element: the chunk's max, one rescale of (m, l, u), then the sums;
//  - the label logit is read once, as s[row, y];
//  - partial states merge in a fixed order, a butterfly over the lanes of
//    a warp, then over the warps' states (one a lane): deterministic, no
//    atomics.
//
// Shapes of work, chosen by kernels/kd_softmax_kl.py::plan (rows a tile R
// and lanes a row L); the thread counts, shared memory and grids follow
// from them here.  One launch a call in every regime:
//  - rows (V <= 512; the FedSiKD path's V = 10): a block stages a tile of
//    whole rows of s and t, contiguous in memory, into shared memory with
//    16-byte cp.async copies (a scalar head and tail where the tile is not
//    16-byte aligned); then L threads own a row, each at most 4 elements
//    in registers for V <= 4 L (4 lanes at V = 10), at most 16 above.  R L
//    <= 256 and V <= 16 L keep a tile at most 4,096 elements, so the two
//    tiles fit the default 48 KB of shared memory.  The backward reads and
//    writes the same tile as one run of 16-byte vectors, a vector a
//    thread, with the rows' coefficients in shared memory.
//  - stream (V > 512): a block takes a row with 16-byte vector loads, each
//    thread a chunk of 16 elements of s and of t in flight.  The backward
//    is one 2-D grid, row x chunk of the row's vectors, with each row's
//    stats, g and label read once a thread and folded into two
//    coefficients and three exp2 offsets.
//
// A row whose start is not 16-byte aligned (odd V) takes a scalar head up to
// alignment, then vectors, then a scalar tail.  When s, t (and ds) are not
// aligned alike, the wrapper passes vec = 0 and every element is scalar.
#include "common.cuh"

#include <cstdint>

namespace fedsikd {
namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 16;          // elements of s (and of t) a chunk update takes
constexpr int kRowsMaxV = 512;      // rows regime: 32 lanes x kChunk elements
constexpr int kRowsThreads = 256;   // at most R L threads a rows block
constexpr int kStreamThreads = 256;
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 2;       // 16-byte vectors a thread of the backward

enum Regime : int { kRows = 0, kStream = 1 };

template <typename T>
struct Elems {
  static constexpr int vec = 16 / static_cast<int>(sizeof(T));   // a 16-byte vector
  static constexpr int unroll = kChunk / vec;                      // vectors a chunk
};

// The online state of one slice of a row, maxima in base-2 units.
struct State {
  float mt, lt, ut;   // teacher at tau: max t c, sum 2^(t c - mt), sum 2^(t c - mt) (t - s)
  float ms, ls;       // student at tau: max s c, sum 2^(s c - ms)
  float m1, l1;       // student at 1:   max s log2(e), sum 2^(s log2(e) - m1)
};

__device__ __forceinline__ State empty_state() {
  return {kNeg, 0.f, 0.f, kNeg, 0.f, kNeg, 0.f};
}

// N elements into the state: one max, one rescale, then the sums.  Padding
// elements are kNeg in both s and t and add nothing, provided one element of
// the chunk is real (callers never pass a chunk of padding only).
template <int N>
__device__ __forceinline__ void update(State& st, const float* s,
                                       const float* t, float c) {
  float smax = s[0], tmax = t[0];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    smax = fmaxf(smax, s[k]);
    tmax = fmaxf(tmax, t[k]);
  }
  const float mt = fmaxf(st.mt, tmax * c);
  const float ms = fmaxf(st.ms, smax * c);
  const float m1 = fmaxf(st.m1, smax * kLog2e);
  float lt = 0.f, ut = 0.f, ls = 0.f, l1 = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float et = ex2(fmaf(t[k], c, -mt));
    lt += et;
    ut = fmaf(et, t[k] - s[k], ut);
    ls += ex2(fmaf(s[k], c, -ms));
    l1 += ex2(fmaf(s[k], kLog2e, -m1));
  }
  const float at = ex2(st.mt - mt);
  st.lt = fmaf(st.lt, at, lt);
  st.ut = fmaf(st.ut, at, ut);
  st.ls = fmaf(st.ls, ex2(st.ms - ms), ls);
  st.l1 = fmaf(st.l1, ex2(st.m1 - m1), l1);
  st.mt = mt;
  st.ms = ms;
  st.m1 = m1;
}

// a <- a merged with b (commutative: a butterfly leaves every lane equal).
__device__ __forceinline__ void merge(State& a, const State& b) {
  const float mt = fmaxf(a.mt, b.mt);
  const float xa = ex2(a.mt - mt), xb = ex2(b.mt - mt);
  a.lt = a.lt * xa + b.lt * xb;
  a.ut = a.ut * xa + b.ut * xb;
  a.mt = mt;
  const float ms = fmaxf(a.ms, b.ms);
  a.ls = a.ls * ex2(a.ms - ms) + b.ls * ex2(b.ms - ms);
  a.ms = ms;
  const float m1 = fmaxf(a.m1, b.m1);
  a.l1 = a.l1 * ex2(a.m1 - m1) + b.l1 * ex2(b.m1 - m1);
  a.m1 = m1;
}

// Butterfly over lanes xor width/2 .. 1 (every lane of the warp calls it).
__device__ __forceinline__ void merge_lanes(State& st, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    State o;
    o.mt = __shfl_xor_sync(kFull, st.mt, off);
    o.lt = __shfl_xor_sync(kFull, st.lt, off);
    o.ut = __shfl_xor_sync(kFull, st.ut, off);
    o.ms = __shfl_xor_sync(kFull, st.ms, off);
    o.ls = __shfl_xor_sync(kFull, st.ls, off);
    o.m1 = __shfl_xor_sync(kFull, st.m1, off);
    o.l1 = __shfl_xor_sync(kFull, st.l1, off);
    merge(st, o);
  }
}

// The block's state, valid in warp 0: each warp's lanes by butterfly, then
// the warps' states, one a lane of warp 0, by the same butterfly.
__device__ __forceinline__ State merge_block(State st, State* warp_states) {
  merge_lanes(st, 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_states[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < static_cast<int>(blockDim.x >> 5) ? warp_states[lane]
                                                  : empty_state();
    merge_lanes(st, 32);
  }
  return st;
}

// loss and (logZ_t, logZ_s, logZ_1) of one row from its whole state.
__device__ __forceinline__ void finish(const State& st, float picked,
                                       int label, float tau, float alpha,
                                       float inv_tau, float* loss,
                                       float* stats, long long row) {
  const float logz_t = fmaf(st.mt, kLn2, logf(st.lt));
  const float logz_s = fmaf(st.ms, kLn2, logf(st.ls));
  const float logz_1 = fmaf(st.m1, kLn2, logf(st.l1));
  const float kl = st.ut / st.lt * inv_tau + logz_s - logz_t;
  const float ce = logz_1 - picked;
  const float valid = label >= 0 ? 1.f : 0.f;
  loss[row] = ((1.f - alpha) * ce + alpha * tau * tau * kl) * valid;
  stats[row * 3 + 0] = logz_t;
  stats[row * 3 + 1] = logz_s;
  stats[row * 3 + 2] = logz_1;
}

// --------------------------------------------------------- 16-byte access
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f);

template <>
__device__ __forceinline__ void store16<float>(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* p,
                                                       const float* f) {
  uint4 v;
  unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

template <>
__device__ __forceinline__ void store16<__half>(__half* p, const float* f) {
  uint4 v;
  unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// Elements from p up to the next 16-byte boundary, at most n.
template <typename T>
__device__ __forceinline__ int head_len(const T* p, int n) {
  constexpr int E = Elems<T>::vec;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) /
                                   sizeof(T));
  return min(n, (E - mis) % E);
}

// A row of V elements: `head` scalars, `nvec` 16-byte vectors, a tail.
template <typename T>
__device__ __forceinline__ void row_layout(const T* row, int V, int vec,
                                           int& head, int& nvec) {
  constexpr int E = Elems<T>::vec;
  head = vec ? head_len(row, V) : V;
  nvec = (V - head) / E;
}

// n elements from g into shared memory at sm + off, off = g's misalignment
// in elements, so that 16-byte vectors of g land on 16-byte boundaries of
// sm.  Returns off.  The caller commits, waits and syncs.
template <typename T>
__device__ __forceinline__ int stage(T* sm, const T* g, int n) {
  constexpr int E = Elems<T>::vec;
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(g) & 15) /
                                   sizeof(T));
  const int head = head_len(g, n);
  const int nvec = (n - head) / E;
  T* d = sm + off;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(d + head + i * E, g + head + i * E);
  for (int i = threadIdx.x; i < head; i += blockDim.x) d[i] = g[i];
  for (int i = head + nvec * E + threadIdx.x; i < n; i += blockDim.x)
    d[i] = g[i];
  return off;
}

// ------------------------------------------------------------ rows: fwd
// Shared memory: two tiles (s, t) of `cap` elements each, cap = R V + E
// rounded up to a multiple of E (the alignment shift).  A lane holds at
// most MAXE elements of its row (4 where V <= 4 L, else kChunk).
template <typename T, int MAXE>
__global__ void __launch_bounds__(kRowsThreads)
kd_fwd_rows_kernel(const T* __restrict__ s, const T* __restrict__ t,
                   const int* __restrict__ y, float* __restrict__ loss,
                   float* __restrict__ stats, long long rows, int V, int R,
                   int L, float tau, float alpha, float c, float inv_tau) {
  constexpr int E = Elems<T>::vec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = (R * V + 2 * E - 1) / E * E;
  T* ss = reinterpret_cast<T*>(smem_raw);
  T* ts = ss + cap;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nrows = static_cast<int>(min(static_cast<long long>(R), rows - row0));
  const int off_s = stage(ss, s + row0 * V, nrows * V);
  const int off_t = stage(ts, t + row0 * V, nrows * V);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lg = __ffs(L) - 1;
  const int r = threadIdx.x >> lg, q = threadIdx.x & (L - 1);
  State st = empty_state();
  if (r < nrows && q < V) {
    const T* sr = ss + off_s + r * V;
    const T* tr = ts + off_t + r * V;
    float sv[MAXE], tv[MAXE];
#pragma unroll
    for (int k = 0; k < MAXE; ++k) {
      const int j = q + k * L;
      sv[k] = j < V ? to_f32(sr[j]) : kNeg;
      tv[k] = j < V ? to_f32(tr[j]) : kNeg;
    }
    update<MAXE>(st, sv, tv, c);
  }
  merge_lanes(st, L);                       // every thread: full-warp shuffles
  if (r < nrows && q == 0) {
    const long long row = row0 + r;
    const int label = y[row];
    const float picked =
        label >= 0 && label < V ? to_f32(ss[off_s + r * V + label]) : 0.f;
    finish(st, picked, label, tau, alpha, inv_tau, loss, stats, row);
  }
}

// ------------------------------------------------------------ stream: fwd
// This thread's state of a row: the row's aligned middle of nvec vectors
// (which starts `head` elements in), then its head and tail scalars.  Each
// thread takes chunks of U vectors strided by the block (each load of a
// warp coalesced), all U of s and of t in flight before the chunk is
// folded in.
template <typename T>
__device__ __forceinline__ State row_state(const T* sr, const T* tr,
                                           int head, int nvec, int V,
                                           float c) {
  constexpr int E = Elems<T>::vec, U = Elems<T>::unroll;
  const int nthr = blockDim.x;
  State st = empty_state();
  for (int i = threadIdx.x; i < nvec; i += U * nthr) {
    float sv[kChunk], tv[kChunk];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = i + u * nthr;
      if (k < nvec) {
        widen(sr + head + static_cast<long long>(k) * E, sv + u * E);
        widen(tr + head + static_cast<long long>(k) * E, tv + u * E);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) sv[u * E + e] = tv[u * E + e] = kNeg;
      }
    }
    update<kChunk>(st, sv, tv, c);
  }
  const int tail0 = head + nvec * E;
  for (int j = threadIdx.x; j < head; j += nthr) {
    const float a = to_f32(sr[j]), b = to_f32(tr[j]);
    update<1>(st, &a, &b, c);
  }
  for (int j = tail0 + threadIdx.x; j < V; j += nthr) {
    const float a = to_f32(sr[j]), b = to_f32(tr[j]);
    update<1>(st, &a, &b, c);
  }
  return st;
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
kd_fwd_stream_kernel(const T* __restrict__ s, const T* __restrict__ t,
                     const int* __restrict__ y, float* __restrict__ loss,
                     float* __restrict__ stats, int V, int vec, float tau,
                     float alpha, float c, float inv_tau) {
  __shared__ State warp_states[32];
  const long long row = blockIdx.x;
  const T* sr = s + row * V;
  const T* tr = t + row * V;
  int head, nvec;
  row_layout(sr, V, vec, head, nvec);
  State st = row_state(sr, tr, head, nvec, V, c);
  st = merge_block(st, warp_states);
  if (threadIdx.x == 0) {
    const int label = y[row];
    const float picked = label >= 0 && label < V ? to_f32(sr[label]) : 0.f;
    finish(st, picked, label, tau, alpha, inv_tau, loss, stats, row);
  }
}

// ----------------------------------------------------------- backward
// A row's stats, g and label folded: ds = A p1 + B (ps - pt) - A [j == y],
// p1 = 2^(s log2e - L1), ps = 2^(s c - Ls), pt = 2^(t c - Lt).
struct Coef {
  float A, B, Lt, Ls, L1;
  int label;
};

__device__ __forceinline__ Coef row_coef(const int* y, const float* stats,
                                         const float* g, long long row,
                                         float tau, float alpha) {
  Coef k;
  k.label = y[row];
  const float gv = k.label >= 0 ? g[row] : 0.f;
  k.A = gv * (1.f - alpha);
  k.B = gv * (alpha * tau);
  k.Lt = stats[row * 3 + 0] * kLog2e;
  k.Ls = stats[row * 3 + 1] * kLog2e;
  k.L1 = stats[row * 3 + 2] * kLog2e;
  return k;
}

__device__ __forceinline__ float grad(const Coef& k, float sv, float tv,
                                      float c) {
  const float ps = ex2(fmaf(sv, c, -k.Ls));
  const float pt = ex2(fmaf(tv, c, -k.Lt));
  const float p1 = ex2(fmaf(sv, kLog2e, -k.L1));
  return fmaf(k.A, p1, k.B * (ps - pt));
}

// A tile of R rows, contiguous in memory, read and written as one run of
// 16-byte vectors (a scalar head and tail where the tile is not aligned):
// each thread loads its first vector, the rows' coefficients go to shared
// memory, and after one barrier each thread takes whole vectors, finding
// the row of a vector's first element by one 32-bit division and stepping
// (row, column) across the vector.
template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
kd_bwd_rows_kernel(const T* __restrict__ s, const T* __restrict__ t,
                   const int* __restrict__ y, const float* __restrict__ stats,
                   const float* __restrict__ g, T* __restrict__ ds,
                   long long rows, int V, int R, int vec, float tau,
                   float alpha, float c) {
  constexpr int E = Elems<T>::vec;
  __shared__ Coef coef[kRowsThreads];       // R <= kRowsThreads rows a tile
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nrows = static_cast<int>(min(static_cast<long long>(R), rows - row0));
  const int n = nrows * V;
  const T* sg = s + row0 * V;
  const T* tg = t + row0 * V;
  T* dg = ds + row0 * V;
  const int head = vec ? head_len(dg, n) : n;
  const int nvec = (n - head) / E;
  // this thread's first vector is in flight while the coefficients load
  int i = threadIdx.x;
  float sv[E], tv[E];
  if (i < nvec) {
    widen(sg + head + i * E, sv);
    widen(tg + head + i * E, tv);
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    coef[r] = row_coef(y, stats, g, row0 + r, tau, alpha);
  __syncthreads();
  for (; i < nvec; i += blockDim.x) {
    const int j0 = head + i * E;
    float d[E];
    int r = j0 / V, col = j0 - r * V;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const Coef& k = coef[r];
      d[e] = grad(k, sv[e], tv[e], c);
      if (col == k.label) d[e] -= k.A;
      if (++col == V) {
        col = 0;
        ++r;
      }
    }
    store16(dg + j0, d);
    if (i + static_cast<int>(blockDim.x) < nvec) {
      widen(sg + j0 + blockDim.x * E, sv);
      widen(tg + j0 + blockDim.x * E, tv);
    }
  }
  const int tail0 = head + nvec * E;        // the head, then the tail
  const int scalars = head + (n - tail0);
  for (int j = threadIdx.x; j < scalars; j += blockDim.x) {
    const int jj = j < head ? j : tail0 + (j - head);
    const int r = jj / V;
    const Coef& k = coef[r];
    float d = grad(k, to_f32(sg[jj]), to_f32(tg[jj]), c);
    if (jj - r * V == k.label) d -= k.A;
    dg[jj] = from_f32<T>(d);
  }
}

// Grid (rows, chunks): block (row, chunk) takes vectors [chunk P, chunk P +
// P) of its row, P = kBwdThreads x kBwdUnroll; chunk 0 also the scalars.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
kd_bwd_chunk_kernel(const T* __restrict__ s, const T* __restrict__ t,
                    const int* __restrict__ y,
                    const float* __restrict__ stats,
                    const float* __restrict__ g, T* __restrict__ ds, int V,
                    int vec, float tau, float alpha, float c) {
  constexpr int E = Elems<T>::vec;
  constexpr int P = kBwdThreads * kBwdUnroll;
  const long long row = blockIdx.x;
  const T* sr = s + row * V;
  const T* tr = t + row * V;
  T* dr = ds + row * V;
  int head, nvec;
  row_layout(sr, V, vec, head, nvec);
  const Coef k = row_coef(y, stats, g, row, tau, alpha);
  const int v0 = static_cast<int>(blockIdx.y) * P;
  const int v1 = min(nvec, v0 + P);
  float sv[kBwdUnroll][E], tv[kBwdUnroll][E];
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const int i = v0 + threadIdx.x + u * kBwdThreads;
    if (i < v1) {
      widen(sr + head + static_cast<long long>(i) * E, sv[u]);
      widen(tr + head + static_cast<long long>(i) * E, tv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const int i = v0 + threadIdx.x + u * kBwdThreads;
    if (i < v1) {
      const int j0 = head + i * E;
      float d[E];
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = grad(k, sv[u][e], tv[u][e], c);
      if (static_cast<unsigned>(k.label - j0) < static_cast<unsigned>(E)) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (j0 + e == k.label) d[e] -= k.A;
      }
      store16(dr + j0, d);
    }
  }
  if (blockIdx.y == 0) {                    // the head, then the tail
    const int tail0 = head + nvec * E;
    const int scalars = head + (V - tail0);
    for (int j = threadIdx.x; j < scalars; j += kBwdThreads) {
      const int jj = j < head ? j : tail0 + (j - head);
      float d = grad(k, to_f32(sr[jj]), to_f32(tr[jj]), c);
      if (jj == k.label) d -= k.A;
      dr[jj] = from_f32<T>(d);
    }
  }
}

// ------------------------------------------------------------ launches
int round32(long long n) { return static_cast<int>((n + 31) / 32 * 32); }

template <typename T>
int launch_fwd(const void* s, const void* t, const int* y, float* loss,
               float* stats, long long rows, int V, float tau, float alpha,
               float c, float inv_tau, int regime, int R, int L, int vec,
               cudaStream_t st) {
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  if (regime == kRows) {
    constexpr int E = Elems<T>::vec;
    const unsigned grid = static_cast<unsigned>((rows + R - 1) / R);
    const int threads = round32(static_cast<long long>(R) * L);
    const int smem =
        2 * ((R * V + 2 * E - 1) / E * E) * static_cast<int>(sizeof(T));
    if ((V + L - 1) / L <= 4)
      kd_fwd_rows_kernel<T, 4><<<grid, threads, smem, st>>>(
          sp, tp, y, loss, stats, rows, V, R, L, tau, alpha, c, inv_tau);
    else
      kd_fwd_rows_kernel<T, kChunk><<<grid, threads, smem, st>>>(
          sp, tp, y, loss, stats, rows, V, R, L, tau, alpha, c, inv_tau);
    return static_cast<int>(cudaGetLastError());
  }
  // a thread per 4 chunks (64 elements) of the row, a power of two from 32
  // to kStreamThreads
  int threads = 32;
  while (threads < kStreamThreads && threads * 4 * kChunk < V) threads *= 2;
  kd_fwd_stream_kernel<T><<<static_cast<unsigned>(rows), threads, 0, st>>>(
      sp, tp, y, loss, stats, V, vec, tau, alpha, c, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* s, const void* t, const int* y,
               const float* stats, const float* g, void* ds, long long rows,
               int V, float tau, float alpha, float c, int regime, int R,
               int vec, cudaStream_t st) {
  constexpr int E = Elems<T>::vec;
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  T* dp = static_cast<T*>(ds);
  if (regime == kRows) {
    // a thread per 16-byte vector of the tile, at most kRowsThreads
    const long long grid = (rows + R - 1) / R;
    const int threads =
        min(kRowsThreads, round32((static_cast<long long>(R) * V + E - 1) / E));
    kd_bwd_rows_kernel<T><<<static_cast<unsigned>(grid), threads, 0, st>>>(
        sp, tp, y, stats, g, dp, rows, V, R, vec, tau, alpha, c);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int P = kBwdThreads * kBwdUnroll;
  const int vecs = (V + E - 1) / E;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>(max(1, (vecs + P - 1) / P)), 1);
  kd_bwd_chunk_kernel<T><<<grid, kBwdThreads, 0, st>>>(
      sp, tp, y, stats, g, dp, V, vec, tau, alpha, c);
  return static_cast<int>(cudaGetLastError());
}

// What both kernels need of a plan: rows < 2^31 (blocks a grid); rows
// takes V <= kRowsMaxV and 1 <= R <= kRowsThreads (the backward's
// coefficients a tile), stream any V above kRowsMaxV.
bool plan_ok(long long rows, int V, int regime, int R) {
  if (rows < 1 || rows >= (1LL << 31) || V < 1) return false;
  if (regime == kRows) return V <= kRowsMaxV && R >= 1 && R <= kRowsThreads;
  return regime == kStream && V > kRowsMaxV;
}

// The rows forward's lanes: a power of two up to 32 with 16 L >= V and R L
// <= kRowsThreads, so that a tile holds at most 4,096 elements.
bool lanes_ok(int V, int R, int L) {
  return L >= 1 && L <= 32 && (L & (L - 1)) == 0 && L * kChunk >= V &&
         R * L <= kRowsThreads;
}

bool dtype_ok(int dtype) {
  return dtype == kF32 || dtype == kBF16 || dtype == kF16;
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// s, t: (rows, V) contiguous, dtype code `dtype`; y: (rows,) int32.
// Writes loss (rows,) f32 and stats (rows, 3) f32.  c = log2(e)/tau and
// inv_tau = 1/tau (both rounded once from double on the host).  regime 0
// (rows): R rows a block, L lanes a row; 1 (stream): a block a row (R and
// L unused).  vec: 1 if s and t lie alike modulo 16 bytes.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernels
// cannot take.
extern "C" int fedsikd_kd_fwd(const void* s, const void* t, const void* y,
                              void* loss, void* stats, long long rows, int V,
                              int dtype, float tau, float alpha, float c,
                              float inv_tau, int regime, int R, int L,
                              int vec, void* stream) {
  if (!dtype_ok(dtype) || !plan_ok(rows, V, regime, R) ||
      (regime == kRows && !lanes_ok(V, R, L)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const int*>(y);
  auto* lo = static_cast<float*>(loss);
  auto* sta = static_cast<float*>(stats);
  switch (dtype) {
    case kF32:
      return launch_fwd<float>(s, t, yy, lo, sta, rows, V, tau, alpha, c,
                               inv_tau, regime, R, L, vec, st);
    case kBF16:
      return launch_fwd<__nv_bfloat16>(s, t, yy, lo, sta, rows, V, tau, alpha,
                                       c, inv_tau, regime, R, L, vec, st);
    default:
      return launch_fwd<__half>(s, t, yy, lo, sta, rows, V, tau, alpha, c,
                                inv_tau, regime, R, L, vec, st);
  }
}

// s, t: (rows, V); y: (rows,) int32; stats: (rows, 3) f32; g: (rows,) f32.
// Writes ds (rows, V) in the dtype of s.  regime and R as the forward's;
// vec: 1 if s, t and ds lie alike modulo 16 bytes.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernels
// cannot take.
extern "C" int fedsikd_kd_bwd(const void* s, const void* t, const void* y,
                              const void* stats, const void* g, void* ds,
                              long long rows, int V, int dtype, float tau,
                              float alpha, float c, int regime, int R,
                              int vec, void* stream) {
  if (!dtype_ok(dtype) || !plan_ok(rows, V, regime, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const int*>(y);
  const auto* sta = static_cast<const float*>(stats);
  const auto* gg = static_cast<const float*>(g);
  switch (dtype) {
    case kF32:
      return launch_bwd<float>(s, t, yy, sta, gg, ds, rows, V, tau, alpha, c,
                               regime, R, vec, st);
    case kBF16:
      return launch_bwd<__nv_bfloat16>(s, t, yy, sta, gg, ds, rows, V, tau,
                                       alpha, c, regime, R, vec, st);
    default:
      return launch_bwd<__half>(s, t, yy, sta, gg, ds, rows, V, tau, alpha, c,
                                regime, R, vec, st);
  }
}
