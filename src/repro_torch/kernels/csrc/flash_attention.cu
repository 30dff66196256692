// Block flash attention (forward) with grouped-query heads, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_fa_kernel  (via flash_attention)
// for float32 with T > 1 (the wrapper's dispatch: bf16 with T > 1 goes to
// csrc/flash_attention_tc.cu, T = 1 to csrc/flash_attention_decode.cu).
//
// q is (B, T, H, hd), k and v (B, S, KVH, hd), out (B, T, H, hd), each
// addressed through its own batch, sequence and head strides (the last
// axis contiguous), so a decode step passes the visible prefix of its KV
// cache as a strided view and nothing is copied.  Query head h reads kv
// head h / (H / KVH); K and V are never replicated.  With `causal` the mask
// is right-aligned: query t sees key s iff s <= t + S - T, and with
// `window` > 0 also s > t + S - T - window.  Masked scores are the finite
// -1e30 of the TPU kernel, so a query that sees no key at all (T > S)
// averages V over every key, as the reference does; keys past S do not
// exist (nothing is padded).  Softmax statistics and both products are in
// float32, as is the output.
//
// What bounds it on the H100: at the serving path's prefill (B 2, H 16,
// KVH 2, T = S = 4096, hd 128) the causal work is 137 GFLOP, 0.139 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 75.5 MB of bytes (0.023 ms):
// operations.  A decode call (T = 1, S = 4128) reads 8.5 MB of cache for
// 68 MFLOP: bytes, 2.5 us.
//
// The first design is simple and right, not fast.  A block owns 64 rows;
// a row is one (query position, query head) pair, and the heads of one GQA
// group share the block, so the block stages each K/V row once for all of
// them.  Two neighbouring threads own a row (four at hd 192, whose halves
// would hold 96 + 96 floats a thread), each holding its share of the
// pre-scaled query and of the float32 output accumulator in registers.
// K and V are staged in shared memory 64 keys at a time, in their own type,
// by cp.async in two stages (the next block's copy is in flight while the
// current one is used).  Each thread scores 16 keys against its share
// (16-byte reads that the warp shares as broadcasts, widened to float32 in
// registers), the row's threads add their shares by shuffles, the row's
// running max and sum are updated once per 16 keys, and the 16 weights
// multiply V
// the same way; a warp with no live row skips the arithmetic.  The block
// walks only the keys its rows can see (the causal diagonal and the window
// bound the range); the rest of the TPU kernel's grid is skipped, which
// changes no result, since a skipped key's weight would be exp(-1e30 - m)
// = 0.  The products run on the CUDA cores in float32.
//
// The TPU grid walks the key axis in order on one core.  Here, where the
// grid alone has too few blocks to fill 132 SMs (a decode step has
// B * KVH of them), the key axis is also split across blocks
// (`n_split` > 1): each block writes its unnormalised accumulator, max and
// sum, and a second kernel, one block per row and one thread per column,
// merges the splits (flash-decoding).  Tensor
// cores (wgmma), TMA staging and a persistent schedule are later work.
#include "common.cuh"

#include <algorithm>
#include <cmath>

namespace fedsikd {
namespace {

constexpr int kRows = 64;        // (position, head) rows per block
constexpr int kBK = 64;          // keys staged in shared memory per pass
constexpr int kChunk = 16;       // keys per online-softmax update
constexpr int kMaxSplit = 1024;  // key-axis splits the merge takes
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part_acc;               // (blocks, n_split, kRows, hd) when split
  float* part_ml;                // (blocks, n_split, kRows, 2) when split
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int T, S, G, Gb, n_gblk, Tq, grid_x, causal, window, n_split, split_len;
  float scale;
};

// The rows of block column bx: row r is query position bx * Tq + r / Gb of
// head group-member gblk * Gb + r % Gb.
struct Row {
  int t, h;
  bool live;
};

__device__ __forceinline__ Row block_row(const Args& a, int row, int bx) {
  const int kvh = blockIdx.y / a.n_gblk;
  const int g = (blockIdx.y % a.n_gblk) * a.Gb + row % a.Gb;
  const int t = bx * a.Tq + row / a.Gb;
  return {t, kvh * a.G + g, row / a.Gb < a.Tq && g < a.G && t < a.T};
}

// 16 bytes of T in shared memory, widened to float32.
template <typename T>
struct Piece {
  static constexpr int kN = 16 / static_cast<int>(sizeof(T));
};

// Threads a row (each owns hd / kTPR columns) and a block, by head dim.
template <int HD>
struct Split {
  static constexpr int kTPR = HD > 128 ? 4 : 2;
  static constexpr int kThreads = kRows * kTPR;
};

// Start the copy of keys kb .. kb + nk - 1 of K and V into one stage.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* ks, T* vs, const T* kp,
                                      const T* vp, const Args& a, int kb,
                                      int nk) {
  constexpr int kPer = Piece<T>::kN;
  constexpr int kPerRow = HD / kPer;
  for (int e = threadIdx.x; e < nk * kPerRow; e += Split<HD>::kThreads) {
    const int j = e / kPerRow;
    const int c = (e - j * kPerRow) * kPer;
    const long long s = kb + j;
    cp_async16(ks + j * HD + c, kp + s * a.k_ss + c);
    cp_async16(vs + j * HD + c, vp + s * a.v_ss + c);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Split<HD>::kThreads)
fa_fwd_kernel(const Args a) {
  constexpr int kTPR = Split<HD>::kTPR;
  constexpr int kDPT = HD / kTPR;              // dims per thread
  constexpr int kPer = Piece<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stage][kBK][HD] for K, then the same for V
  T* const ks = reinterpret_cast<T*>(smem_raw);
  T* const vs = ks + 2 * kBK * HD;

  const int row = threadIdx.x / kTPR;
  const int d0 = (threadIdx.x % kTPR) * kDPT;
  const int b = blockIdx.z / a.n_split;
  const int split = blockIdx.z % a.n_split;
  const int kvh = blockIdx.y / a.n_gblk;
  const Row r = block_row(a, row, blockIdx.x);
  const bool warp_live = __any_sync(kFull, r.live);
  const int off = a.S - a.T;                   // right alignment

  // The keys any live row of the block can see.  A block holding a row
  // that sees nothing (t + off < 0) walks every key, so that row averages
  // V over all S keys, as the reference does.
  const int t_first = blockIdx.x * a.Tq;
  const int t_last = min(t_first + a.Tq, a.T) - 1;
  int lo = 0, hi = a.S;
  if (a.causal && t_first + off >= 0) {
    hi = min(a.S, t_last + off + 1);
    if (a.window > 0) lo = max(0, t_first + off - a.window + 1);
  }
  const int k_begin = max(lo, split * a.split_len);
  const int k_end = min(hi, (split + 1) * a.split_len);

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  if (k_begin < k_end)
    stage<T, HD>(ks, vs, kp, vp, a, k_begin, min(kBK, k_end - k_begin));
  cp_async_commit();

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb
                + static_cast<long long>(r.live ? r.t : 0) * a.q_st
                + static_cast<long long>(r.live ? r.h : 0) * a.q_sh + d0;
  float q[kDPT], acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    q[i] = r.live ? to_f32(qp[i]) * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;
  const int lim = r.t + off;                   // last key this row sees

  int buf = 0;                                 // the stage in use
  for (int kb = k_begin; kb < k_end; kb += kBK) {
    const int nk = min(kBK, k_end - kb);
    const int next = (buf ^ 1) * kBK * HD;
    if (kb + kBK < k_end)                      // the next block, in flight
      stage<T, HD>(ks + next, vs + next, kp, vp, a, kb + kBK,
                   min(kBK, k_end - kb - kBK));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                           // this block has landed
    // The shuffle needs the whole warp: a warp runs the arithmetic when
    // any of its rows is live, and `nk` is the same for all of it.
    for (int j0 = 0; warp_live && j0 < nk; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float dot = 0.f;
        if (j0 + c < nk) {
          const T* kr = ks + (buf * kBK + j0 + c) * HD + d0;
#pragma unroll
          for (int i = 0; i < kDPT; i += kPer) {
            float f[kPer];
            widen(kr + i, f);
#pragma unroll
            for (int u = 0; u < kPer; ++u) dot = fmaf(q[i + u], f[u], dot);
          }
        }
        s[c] = dot;
      }
      float mx = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float sc = s[c];
#pragma unroll
        for (int o = 1; o < kTPR; o <<= 1)
          sc += __shfl_xor_sync(kFull, sc, o);
        const int key = kb + j0 + c;
        if (j0 + c >= nk) {
          sc = -INFINITY;                      // no such key: weight 0
        } else if (a.causal &&
                   (key > lim || (a.window > 0 && key <= lim - a.window))) {
          sc = kNeg;
        }
        s[c] = sc;
        mx = fmaxf(mx, sc);
      }
      const float rescale = expf(m - mx);
      l *= rescale;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] *= rescale;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - mx);
        l += p;
        if (j0 + c < nk) {
          const T* vr = vs + (buf * kBK + j0 + c) * HD + d0;
#pragma unroll
          for (int i = 0; i < kDPT; i += kPer) {
            float f[kPer];
            widen(vr + i, f);
#pragma unroll
            for (int u = 0; u < kPer; ++u)
              acc[i + u] = fmaf(p, f[u], acc[i + u]);
          }
        }
      }
      m = mx;
    }
    __syncthreads();                           // done reading this stage
    buf ^= 1;
  }
  if (!r.live) return;                         // no barrier follows

  if (a.n_split == 1) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.out) + b * a.o_sb
            + static_cast<long long>(r.t) * a.o_st
            + static_cast<long long>(r.h) * a.o_sh + d0;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) op[i] = from_f32<T>(acc[i] / denom);
    return;
  }
  // One split of the key axis: store the unnormalised state.  A split that
  // saw no key of this row stores l = 0, which the merge skips.
  const long long blk =
      (static_cast<long long>(b) * gridDim.y + blockIdx.y) * gridDim.x
      + blockIdx.x;
  const long long idx = (blk * a.n_split + split) * kRows + row;
  float* pa = a.part_acc + idx * HD + d0;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) pa[i] = acc[i];
  if (d0 == 0) {
    a.part_ml[2 * idx] = m;
    a.part_ml[2 * idx + 1] = l;
  }
}

// Merge the key-axis splits of one row (a block of hd threads, one per
// column):
//   out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)
// with M the largest m_i over the splits that saw a key (l_i > 0); every
// live row has at least one.  Each split's (m, l) is read once into shared
// memory; the accumulator reads of the splits are independent, so they are
// in flight together.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
fa_merge_kernel(const Args a) {
  __shared__ float ms[kMaxSplit], ls[kMaxSplit];
  const int row = blockIdx.x % kRows;
  const int bx = blockIdx.x / kRows;
  const Row r = block_row(a, row, bx);
  if (!r.live) return;                         // the whole block
  const int b = blockIdx.z;
  const long long blk =
      (static_cast<long long>(b) * gridDim.y + blockIdx.y) * a.grid_x + bx;
  const long long base = blk * a.n_split * kRows + row;
  for (int i = threadIdx.x; i < a.n_split; i += HD) {
    const long long idx = base + static_cast<long long>(i) * kRows;
    ms[i] = a.part_ml[2 * idx];
    ls[i] = a.part_ml[2 * idx + 1];
  }
  __syncthreads();
  float mstar = -INFINITY;
  for (int i = 0; i < a.n_split; ++i)
    if (ls[i] > 0.f) mstar = fmaxf(mstar, ms[i]);
  const int d = threadIdx.x;
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int i = 0; i < a.n_split; ++i) {
    if (ls[i] > 0.f) {
      const float w = expf(ms[i] - mstar);
      den = fmaf(ls[i], w, den);
      num = fmaf(a.part_acc[(base + static_cast<long long>(i) * kRows) * HD
                            + d], w, num);
    }
  }
  T* op = static_cast<T*>(a.out) + b * a.o_sb
          + static_cast<long long>(r.t) * a.o_st
          + static_cast<long long>(r.h) * a.o_sh + d;
  *op = from_f32<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int HD>
int launch(const Args& a, int B, int KVH, cudaStream_t stream) {
  constexpr int kSmem = 4 * kBK * HD * static_cast<int>(sizeof(T));
  // above 48 KB (hd 96 and up) only after this opt-in; 192 KB at hd 192
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.grid_x, KVH * a.n_gblk, B * a.n_split);
  fa_fwd_kernel<T, HD><<<grid, Split<HD>::kThreads, kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const dim3 mgrid(a.grid_x * kRows, grid.y, B);
  fa_merge_kernel<T, HD><<<mgrid, HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int B, int KVH, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, KVH, stream);
    case 64: return launch<T, 64>(a, B, KVH, stream);
    case 96: return launch<T, 96>(a, B, KVH, stream);
    case 128: return launch<T, 128>(a, B, KVH, stream);
    case 192: return launch<T, 192>(a, B, KVH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// q (B, T, H, hd), k/v (B, S, KVH, hd), out (B, T, H, hd): strides in
// elements, the hd axis contiguous; k and v 16-byte aligned, with strides
// in whole 16-byte units (the cp.async copies).  hd in {32, 64, 96, 128,
// 192};
// H % KVH == 0; n_split <= 1024.
// With n_split > 1 the key axis is cut into spans of split_len keys (a
// multiple of 64) and part_acc / part_ml hold (blocks * n_split * 64 * hd)
// and (blocks * n_split * 64 * 2) floats, blocks = B * gridDim.y *
// gridDim.x; with n_split == 1 they are unused.  Returns
// cudaGetLastError() after the launches.
extern "C" int fedsikd_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int B, int T, int S, int H, int KVH, int hd, int causal,
    int window, float scale, int n_split, int split_len, int dtype,
    void* stream) {
  if (B < 1 || T < 1 || S < 1 || KVH < 1 || H % KVH != 0 || window < 0 ||
      n_split < 1 || n_split > kMaxSplit || split_len < 1 ||
      split_len % kBK != 0 ||
      static_cast<long long>(n_split) * split_len < S)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_st = o_st; a.o_sh = o_sh;
  a.T = T;
  a.S = S;
  a.G = H / KVH;
  a.Gb = std::min(a.G, kRows);
  a.n_gblk = (a.G + a.Gb - 1) / a.Gb;
  a.Tq = std::max(1, kRows / a.Gb);
  a.grid_x = (T + a.Tq - 1) / a.Tq;
  a.causal = causal;
  a.window = window;
  a.n_split = n_split;
  a.split_len = split_len;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_hd<float>(a, B, KVH, hd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
