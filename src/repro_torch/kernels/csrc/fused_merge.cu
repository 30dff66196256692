// Fused grouped weighted-mean merge with staleness decay over ALL leaves of
// a parameter dict in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_merge.py::_kernel  (via fused_merge)
//
//   out_l[d] = sum_n w_n (1+s_n)^-decay x_{n,l}[d] / sum_m w_m (1+s_m)^-decay
//
// for every leaf l of N clients' parameter dicts.  Each client's leaf is
// read where it lies: a device table holds one row pointer per (leaf,
// client), leaf-major, so nothing is stacked first.  The outputs go to one
// flat float32 buffer at the column offsets the wrapper chose
// (kernels/fused_merge.py::merge_plan).  x is f32, bf16 or f16, one dtype
// per launch; w and s are (N,) f32.  The single-leaf entry launches the same
// kernel with one leaf (its row pointers are the rows of its (N, D) stack).
//
// What bounds it on the H100: bytes.  A FedSiKD round merges the ten leaves
// of the MNIST student over N = 40 clients, 3.06 MB read once, about 0.9 us
// at 3.35 TB/s, so latency and launches decide its time.  The first design
// (one thread a column walking N in one dependent chain, one launch a leaf
// after a torch.stack of the clients' copies) took 10 launches of about 6.6
// us plus 10 stacks a round.
//
// What this design does about it:
//  - one launch a merge: blocks take tiles of 32 x (16 bytes) columns of the
//    concatenated column space; a tile never crosses a leaf boundary, and a
//    small tile table (out offset, column in the leaf, leaf, width, 16-byte
//    flag) tells each block where it is, so the ten leaves give 154 blocks
//    in float32;
//  - the normalised decayed weights are computed once a block into shared
//    memory (in chunks of kChunk clients, so any N works);
//  - the 8 warps split N, and each thread keeps up to kUnroll independent
//    16-byte loads in flight (scalar loads on a ragged edge, or for a leaf
//    whose rows are not all 16-byte aligned);
//  - the warps' partial sums are added through shared memory in warp order:
//    no atomics, the output is deterministic.
#include "common.cuh"

namespace fedsikd {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;       // normalised weights staged a pass
constexpr int kUnroll = 8;        // rows a thread has in flight

// One block's work; written by kernels/fused_merge.py::merge_plan (32 bytes).
struct Tile {
  long long out0;   // first column of the tile in the flat output
  long long c0;     // first column of the tile in its leaf
  int leaf;         // the leaf: row pointers rows[leaf * N + n]
  int cols;         // columns in the tile, at most 32 * (16 / sizeof(T))
  int vec;          // 1 if every client's row of the leaf is 16-byte aligned
  int pad;
};
static_assert(sizeof(Tile) == 32, "Tile must match merge_plan's layout");

// The V columns [c, c + m) of one row (zeros past m), as float32.
template <typename T, int V>
__device__ __forceinline__ void load_cols(const T* row, long long c, int m,
                                          bool vec, float* f) {
  if (vec && m == V) {
    widen(row + c, f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = i < m ? to_f32(row[c + i]) : 0.f;
  }
}

__device__ __forceinline__ float decayed(const float* w, const float* s,
                                         int n, float decay) {
  return w[n] * powf(1.0f + s[n], -decay);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_merge_leaves_kernel(const T* const* __restrict__ rows,
                          const Tile* __restrict__ tiles,
                          const float* __restrict__ w,
                          const float* __restrict__ s,
                          float* __restrict__ out, int N, float decay) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kCols = 32 * V;
  __shared__ float wn[kChunk];
  __shared__ float warp_tot[kWarps];
  __shared__ float red[kWarps][kCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Tile t = tiles[blockIdx.x];
  const T* const* leaf_rows = rows + static_cast<long long>(t.leaf) * N;

  // 1. the decayed weight total, summed in a fixed order by every thread
  float part = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) part += decayed(w, s, n, decay);
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) warp_tot[warp] = part;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += warp_tot[i];

  // 2. this lane's V columns; warp q takes rows q, q + kWarps, ...
  const int m = min(V, t.cols - lane * V);
  const long long c = t.c0 + static_cast<long long>(lane) * V;
  const bool vec = t.vec != 0;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int cnt = min(kChunk, N - n0);
    __syncthreads();                        // the previous chunk is consumed
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      wn[i] = decayed(w, s, n0 + i, decay) / total;
    __syncthreads();
    if (m <= 0) continue;
    for (int r0 = warp; r0 < cnt; r0 += kWarps * kUnroll) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        if (r < cnt) {
          load_cols<T, V>(leaf_rows[n0 + r], c, m, vec, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        if (r < cnt) {
          const float wt = wn[r];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(wt, v[u][i], acc[i]);
        }
      }
    }
  }

  // 3. the warps' partial sums, added in warp order
#pragma unroll
  for (int i = 0; i < V; ++i) red[warp][lane * V + i] = acc[i];
  __syncthreads();
  for (int j = threadIdx.x; j < t.cols; j += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) o += red[q][j];
    out[t.out0 + j] = o;
  }
}

template <typename T>
void launch(const void* rows, const void* tiles, const float* w,
            const float* s, float* out, int N, int n_tiles, float decay,
            cudaStream_t stream) {
  fused_merge_leaves_kernel<T><<<n_tiles, kThreads, 0, stream>>>(
      static_cast<const T* const*>(rows), static_cast<const Tile*>(tiles), w,
      s, out, N, decay);
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// rows: (L * N) device row pointers, leaf-major; tiles: (n_tiles) Tile;
// w, s: (N,) f32; out: the flat f32 output the tiles address; every row of
// dtype code `dtype`.  Returns cudaGetLastError().
extern "C" int fedsikd_fused_merge(const void* rows, const void* tiles,
                                   const void* w, const void* s, void* out,
                                   int N, int n_tiles, int dtype, float decay,
                                   void* stream) {
  if (N < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ww = static_cast<const float*>(w);
  const auto* ss = static_cast<const float*>(s);
  auto* o = static_cast<float*>(out);
  switch (dtype) {
    case kF32: launch<float>(rows, tiles, ww, ss, o, N, n_tiles, decay, st); break;
    case kBF16: launch<__nv_bfloat16>(rows, tiles, ww, ss, o, N, n_tiles, decay, st); break;
    case kF16: launch<__half>(rows, tiles, ww, ss, o, N, n_tiles, decay, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
