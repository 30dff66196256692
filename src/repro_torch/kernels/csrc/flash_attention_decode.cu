// Flash-decoding: attention of one query position (T = 1) over a KV cache
// prefix, grouped-query heads, float32 or bf16, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_fa_kernel  (via flash_attention)
// for T = 1 (the wrapper's dispatch; T > 1 goes to csrc/flash_attention.cu
// in float32 and csrc/flash_attention_tc.cu in bf16).
//
// The function is the first kernel's at T = 1: q (B, 1, H, hd), k and v
// (B, S, KVH, hd) through their own strides (the decode path passes the
// cache's visible prefix as a view), out (B, 1, H, hd).  With T = 1 the
// right-aligned mask shows the one query every key s <= S - 1, and with a
// `window` only s > S - 1 - window: the keys [lo, S), lo = S - min(S,
// window).  Every masked score would weigh exp(-1e30 - m) = 0, so the
// kernel walks [lo, S) alone and masks nothing.  Softmax and both products
// are float32; the output is rounded once to the input type.
//
// What bounds it on the H100: bytes.  A serving step (B 2, KVH 2, S 4128,
// hd 128, bf16) reads 8.5 MB of cache for 68 MFLOP: 2.5 us at 3.35 TB/s.
// So every K/V row is read once, for all the query heads of its group,
// and enough blocks stream at once to keep the memory busy:
// - One block per (b, kv head, group of up to 8 query heads, key span).
//   The wrapper's plan picks spans of about 64 keys, so the grid covers
//   the 132 SMs about twice (B 2, KVH 2, S 4128: 65 spans, 260 blocks).
// - The block stages its span's K and V rows in shared memory by cp.async,
//   64 keys at a time, K in one copy group and V in the next, all in
//   flight at once: the scores start when K has landed, while V streams.
// - Scores: a key row is hd / 8 (bf16) or hd / 4 (f32) 16-byte pieces,
//   covered by a power of two of lanes (`Layout::kLPK`, at most 32; at hd
//   96 and 192, 12, 24 or 48 pieces, the lanes past the last piece hold
//   zeros, and at f32 hd 192 a lane takes two pieces); each lane holds its
//   slice of the group's 8 query heads in registers and forms 8 partial
//   dots, and the lanes of a key reduce them by halving exchanges
//   (reduce-scatter: 8 shuffles for 8 heads over 16 lanes, in place of
//   32), ending with each head's score in one lane.  All 8 warps are busy:
//   a warp takes 2 keys a pass in bf16 at hd 128.
// - Softmax per head over the chunk by warp shuffles.  P . V: a thread
//   owns one 16-byte column of V for 4 heads and a subset of the keys, so
//   each read and widening of V serves 4 heads (inside a block the CUDA
//   cores' instruction rate, not the bytes, is the limit); the key subsets
//   are added in shared memory in a fixed order (when the (column, head
//   set) pairs do not divide the 256 threads, the threads left over sit
//   out), and a thread writes one float4 of the block's GB x hd output, or
//   two at GB 8 and hd 192.
// - The spans merge in the same launch, in two levels of atomic tickets:
//   each block writes its unnormalised (acc, m, l); the last of a set of 8
//   spans to arrive merges the set, the last set the group.  A merge is an
//   online softmax merge in each thread's registers with every read of the
//   level in flight at once (one memory round trip for 8 states, where one
//   block merging 65 spans took 8).  The last blocks leave the tickets zero
//   for the next launch.  No second kernel.
#include "common.cuh"

namespace fedsikd {
namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;       // keys a step of the online softmax
constexpr int kStages = 2;       // chunks staged in shared memory at once
constexpr int kMaxSpans = 512;   // spans the merge takes
constexpr int kFan = 8;          // spans merged at the first level
constexpr int kPvHeads = 4;      // heads a thread sums in P . V
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The work split of a block for storage type T, head dim HD and GB query
// heads.
template <typename T, int HD, int GB>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a piece
  static constexpr int kPieces = HD / kVec;       // 16-byte pieces a row
  // lanes a key (a power of two, 4 .. 32) and pieces a lane (1 or 2)
  static constexpr int kLPK = pow2_at_least(kPieces < 32 ? kPieces : 32);
  static constexpr int kPPL = (kPieces + kLPK - 1) / kLPK;
  static constexpr int kHPT = GB < kPvHeads ? GB : kPvHeads;  // P . V heads
  static constexpr int kPairs = kPieces * (GB / kHPT);  // (piece, head set)
  static constexpr int kKG = kThreads / kPairs;   // P . V key groups
  static constexpr int kSlots4 = GB * HD / 4;     // float4 output slots
  static constexpr int kSPT = (kSlots4 + kThreads - 1) / kThreads;
  static_assert(HD % kVec == 0 && kKG >= 1, "head dim");
};

// Shared memory of a block: the scores [GB][kChunk + 1] floats, then one
// area that holds the staged chunks' K and V rows and then the P . V key
// groups' sums.
template <int GB>
__host__ __device__ constexpr int score_bytes() {
  return (GB * (kChunk + 1) * 4 + 15) / 16 * 16;
}

template <typename T, int HD, int GB>
constexpr int smem_bytes() {
  constexpr int kKV = 2 * kStages * kChunk * HD * static_cast<int>(sizeof(T));
  // [kKG][GB][HD] floats
  constexpr int kRed = Layout<T, HD, GB>::kKG * GB * HD * 4;
  return score_bytes<GB>() + (kKV > kRed ? kKV : kRed);
}

struct DecArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part_acc;     // (groups * (n_span + n_set), GB, hd), n_span > 1
  float* part_ml;      // (groups * (n_span + n_set), GB, 2)
  int* tickets;        // (groups * (1 + n_set)), zero between launches
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  int S, G, n_gblk, lo, n_span, span_len;
  float scale;
};

// Add one to a ticket with release and acquire semantics at GPU scope:
// after a __syncthreads(), the block's earlier writes are visible to the
// block that draws the last ticket, and that block sees every other's.
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x.x, x.y),
                         __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<uint2*>(v);
}

// Reduce NH per-lane partial sums over the lanes that differ in the bits
// below 2 * OFF, halving the values a lane holds at each exchange: at
// offset OFF a lane keeps one half of its values, sends the other, and
// adds what its partner sends.  Afterwards a lane holds the full sums of
// max(1, NH / lanes) consecutive heads starting at `head`; once one value
// is left, the remaining exchanges add it whole and only the lane with
// those bits clear stays the `writer`.
template <int NH, int OFF>
struct Scatter {
  __device__ __forceinline__ static void run(float* part, int lane,
                                             int& head, bool& writer) {
    if constexpr (OFF > 0) {
      const bool up = (lane & OFF) != 0;
      if constexpr (NH > 1) {
        constexpr int kHalf = NH / 2;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const float send = up ? part[i] : part[i + kHalf];
          const float keep = up ? part[i + kHalf] : part[i];
          part[i] = keep + __shfl_xor_sync(kFull, send, OFF);
        }
        if (up) head += kHalf;
        Scatter<kHalf, OFF / 2>::run(part, lane, head, writer);
      } else {
        part[0] += __shfl_xor_sync(kFull, part[0], OFF);
        if (up) writer = false;
        Scatter<1, OFF / 2>::run(part, lane, head, writer);
      }
    }
  }
};

// The online merge of `count` partial states (acc, m, l) of one head,
// stored from index `first` on, for this thread's 4 output columns: every
// read is independent of the running state, so the loads of a round are
// in flight together.
template <int GB, int HD>
__device__ __forceinline__ void merge_states(const float* acc,
                                             const float* ml,
                                             long long first, int count,
                                             int h, int d, float& M, float& L,
                                             float4& o) {
  M = -INFINITY;
  L = 0.f;
  o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < count; ++i) {
    const long long idx = (first + i) * GB + h;
    const float4 x = __ldcg(reinterpret_cast<const float4*>(acc + idx * HD
                                                            + d));
    const float mi = __ldcg(ml + 2 * idx), li = __ldcg(ml + 2 * idx + 1);
    const float mn = fmaxf(M, mi);
    const float al = ex2((M - mn) * kLog2e), be = ex2((mi - mn) * kLog2e);
    L = fmaf(L, al, li * be);
    o.x = fmaf(o.x, al, x.x * be);
    o.y = fmaf(o.y, al, x.y * be);
    o.z = fmaf(o.z, al, x.z * be);
    o.w = fmaf(o.w, al, x.w * be);
    M = mn;
  }
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads, 2)
fa_decode_kernel(const DecArgs a) {
  using Lay = Layout<T, HD, GB>;
  constexpr int kVec = Lay::kVec;
  constexpr int kPieces = Lay::kPieces;
  constexpr int kLPK = Lay::kLPK;
  constexpr int kPPL = Lay::kPPL;
  constexpr int kKPW = 32 / kLPK;          // keys a warp pass
  constexpr int kKPP = kWarps * kKPW;      // keys a block pass
  constexpr int kNHA = GB > kLPK ? GB / kLPK : 1;   // heads a lane ends with
  constexpr int kHPT = Lay::kHPT;
  constexpr int kPairs = Lay::kPairs;
  constexpr int kKG = Lay::kKG;
  constexpr int kSlots4 = Lay::kSlots4;
  constexpr int kSPT = Lay::kSPT;
  constexpr int kPS = kChunk + 1;          // padded score row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const ps = reinterpret_cast<float*>(smem_raw);        // [GB][kPS]
  unsigned char* const work = smem_raw + score_bytes<GB>();
  T* const ks = reinterpret_cast<T*>(work);   // [kStages][kChunk][HD]
  T* const vs = ks + kStages * kChunk * HD;    // [kStages][kChunk][HD]
  __shared__ float m_s[GB], l_s[GB], al_s[GB];
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int span = blockIdx.x, gblk = blockIdx.y % a.n_gblk;
  const int kvh = blockIdx.y / a.n_gblk, b = blockIdx.z;
  const int h0 = kvh * a.G + gblk * GB;            // the block's first head
  const int nh = min(GB, a.G - gblk * GB);         // its live heads
  const int k_begin = a.lo + span * a.span_len;
  const int k_end = min(a.S, k_begin + a.span_len);
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // scores: this lane's 16-byte pieces (lk, lk + kLPK) of the query heads,
  // in float32; zeros for pieces past the row
  const int lk = lane % kLPK;
  float qv[GB][kPPL][kVec];
#pragma unroll
  for (int j = 0; j < GB; ++j) {
#pragma unroll
    for (int pp = 0; pp < kPPL; ++pp) {
      const int piece = lk + pp * kLPK;
      if (j < nh && piece < kPieces) {
        widen(static_cast<const T*>(a.q) + b * a.q_sb + (h0 + j) * a.q_sh
                  + piece * kVec,
              qv[j][pp]);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) qv[j][pp][u] = 0.f;
      }
    }
  }
  // P . V: this thread's 16-byte column, its kHPT heads and its key group
  // (threads past kKG groups of kPairs sit out)
  const int pair = tid % kPairs, kg = tid / kPairs;
  const bool pv_live = kg < kKG;
  const int pcol = (pair % kPieces) * kVec, ph0 = (pair / kPieces) * kHPT;
  float acc[kHPT][kVec];
#pragma unroll
  for (int i = 0; i < kHPT; ++i)
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[i][u] = 0.f;

  // Chunk c goes to stage c % kStages as two copy groups, K then V (an
  // empty pair past the span, so the count of groups in flight is fixed):
  // the scores of a chunk start when its K has landed, while its V and the
  // next chunks stream in.
  const int n_chunks = (k_end - k_begin + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int c) {
    const int c0 = k_begin + c * kChunk;
    const int nk = c < n_chunks ? min(kChunk, k_end - c0) : 0;
    const int st = (c % kStages) * kChunk * HD;
    for (int e = tid; e < nk * kPieces; e += kThreads) {
      const int r = e / kPieces, col16 = (e % kPieces) * kVec;
      cp_async16(ks + st + r * HD + col16, kp + (c0 + r) * a.k_ss + col16);
    }
    cp_async_commit();
    for (int e = tid; e < nk * kPieces; e += kThreads) {
      const int r = e / kPieces, col16 = (e % kPieces) * kVec;
      cp_async16(vs + st + r * HD + col16, vp + (c0 + r) * a.v_ss + col16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages; ++c) stage_chunk(c);

  for (int c = 0; c < n_chunks; ++c) {
    const int nk = min(kChunk, k_end - k_begin - c * kChunk);
    const T* kc = ks + (c % kStages) * kChunk * HD;
    const T* vc = vs + (c % kStages) * kChunk * HD;
    cp_async_wait<2 * kStages - 1>();
    __syncthreads();                         // K of chunk c landed

    // scores of every head of the group against the chunk's keys
    for (int j0 = warp * kKPW; j0 < nk; j0 += kKPP) {   // warp-uniform
      const int j = j0 + lane / kLPK;
      float part[GB];
#pragma unroll
      for (int h = 0; h < GB; ++h) part[h] = 0.f;
#pragma unroll
      for (int pp = 0; pp < kPPL; ++pp) {
        const int piece = lk + pp * kLPK;
        float kf[kVec];
        if (j < nk && piece < kPieces) {
          widen(kc + j * HD + piece * kVec, kf);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) kf[u] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < GB; ++h) {
#pragma unroll
          for (int u = 0; u < kVec; ++u)
            part[h] = fmaf(qv[h][pp][u], kf[u], part[h]);
        }
      }
      int head = 0;
      bool writer = true;
      Scatter<GB, kLPK / 2>::run(part, lane, head, writer);
      if (j < nk && writer) {
#pragma unroll
        for (int i = 0; i < kNHA; ++i)
          ps[(head + i) * kPS + j] = part[i] * a.scale;
      }
    }
    __syncthreads();

    // per head: the chunk's max, its weights and the running (m, l)
    for (int h = warp; h < GB; h += kWarps) {
      float* row = ps + h * kPS;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_old = c == 0 ? -INFINITY : m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = ex2((row[j] - m_new) * kLog2e);
        row[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      if (lane == 0) {
        const float al = ex2((m_old - m_new) * kLog2e);   // 0 at the first
        al_s[h] = al;
        l_s[h] = (c == 0 ? 0.f : l_s[h]) * al + sum;
        m_s[h] = m_new;
      }
    }
    cp_async_wait<2 * kStages - 2>();
    __syncthreads();                         // V of chunk c landed, weights

    // acc = acc * alpha + P . V over this thread's keys: one read and
    // widening of V serves kHPT heads
    if (pv_live) {
#pragma unroll
      for (int i = 0; i < kHPT; ++i) {
        const float al = al_s[ph0 + i];
#pragma unroll
        for (int u = 0; u < kVec; ++u) acc[i][u] *= al;
      }
      for (int j = kg; j < nk; j += kKG) {
        float vf[kVec];
        widen(vc + j * HD + pcol, vf);
#pragma unroll
        for (int i = 0; i < kHPT; ++i) {
          const float p = ps[(ph0 + i) * kPS + j];
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc[i][u] = fmaf(p, vf[u], acc[i][u]);
        }
      }
    }
    __syncthreads();                         // stage and scores consumed
    stage_chunk(c + kStages);
  }

  // add the key groups' sums in a fixed order (in the K/V area): thread
  // tid ends with the float4 output slots tid + i * kThreads, each one
  // head sh and columns sd .. sd + 3
  float* const red = reinterpret_cast<float*>(work);   // [kKG][GB][HD]
  cp_async_wait<0>();                        // (the empty groups)
  if (pv_live) {
#pragma unroll
    for (int i = 0; i < kHPT; ++i)
#pragma unroll
      for (int u = 0; u < kVec; u += 4)
        *reinterpret_cast<float4*>(red + (kg * GB + ph0 + i) * HD + pcol
                                   + u) =
            make_float4(acc[i][u], acc[i][u + 1], acc[i][u + 2],
                        acc[i][u + 3]);
  }
  __syncthreads();
  bool has[kSPT];
  int sh[kSPT], sd[kSPT];
  float4 o[kSPT];
#pragma unroll
  for (int i = 0; i < kSPT; ++i) {
    const int u = tid + i * kThreads;
    has[i] = u < kSlots4;
    sh[i] = has[i] ? u / (HD / 4) : 0;
    sd[i] = (u % (HD / 4)) * 4;
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (has[i]) {
      for (int g = 0; g < kKG; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            red + (g * GB + sh[i]) * HD + sd[i]);
        o[i].x += x.x;
        o[i].y += x.y;
        o[i].z += x.z;
        o[i].w += x.w;
      }
    }
  }
  auto store_out = [&](int i, float L) {
    if (has[i] && sh[i] < nh) {
      const float d = fmaxf(L, 1e-30f);
      store4(static_cast<T*>(a.out) + b * a.o_sb + (h0 + sh[i]) * a.o_sh
                 + sd[i],
             make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d));
    }
  };

  if (a.n_span == 1) {                       // one span: the output itself
#pragma unroll
    for (int i = 0; i < kSPT; ++i) store_out(i, l_s[sh[i]]);
    return;
  }

  // Merge the spans in two levels, each by the last block to arrive (an
  // atomic ticket): the spans of a set of kFan, then the sets.
  const long long grp = static_cast<long long>(b) * gridDim.y + blockIdx.y;
  const long long groups = static_cast<long long>(gridDim.y) * gridDim.z;
  const int n_set = (a.n_span + kFan - 1) / kFan, set = span / kFan;
  const int set_size = min(kFan, a.n_span - set * kFan);
  int* const set_ticket = a.tickets + groups + grp * n_set + set;
  float M[kSPT], L[kSPT];
#pragma unroll
  for (int i = 0; i < kSPT; ++i) {
    M[i] = m_s[sh[i]];
    L[i] = l_s[sh[i]];
  }
  // store this block's states, then draw a ticket; true for the last block
  auto publish = [&](long long idx, int* ticket, int count) {
#pragma unroll
    for (int i = 0; i < kSPT; ++i) {
      if (has[i]) {
        *reinterpret_cast<float4*>(a.part_acc + (idx * GB + sh[i]) * HD
                                   + sd[i]) = o[i];
        if (sd[i] == 0) {
          a.part_ml[2 * (idx * GB + sh[i])] = M[i];
          a.part_ml[2 * (idx * GB + sh[i]) + 1] = L[i];
        }
      }
    }
    __syncthreads();
    if (tid == 0) last_s = ticket_add(ticket) == count - 1;
    __syncthreads();
    return last_s != 0;
  };
  if (!publish(grp * a.n_span + span, set_ticket, set_size)) return;
#pragma unroll
  for (int i = 0; i < kSPT; ++i)
    if (has[i])
      merge_states<GB, HD>(a.part_acc, a.part_ml, grp * a.n_span + set * kFan,
                           set_size, sh[i], sd[i], M[i], L[i], o[i]);
  if (tid == 0) *set_ticket = 0;             // ready for the next launch
  if (n_set > 1) {
    if (!publish(groups * a.n_span + grp * n_set + set, a.tickets + grp,
                 n_set))
      return;
#pragma unroll
    for (int i = 0; i < kSPT; ++i)
      if (has[i])
        merge_states<GB, HD>(a.part_acc, a.part_ml,
                             groups * a.n_span + grp * n_set, n_set, sh[i],
                             sd[i], M[i], L[i], o[i]);
    if (tid == 0) a.tickets[grp] = 0;
  }
#pragma unroll
  for (int i = 0; i < kSPT; ++i) store_out(i, L[i]);
}

template <typename T, int HD, int GB>
int launch(const DecArgs& a, int B, int KVH, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, HD, GB>();
  // above 48 KB (f32 at hd 128 and up) only after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      fa_decode_kernel<T, HD, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_span, KVH * a.n_gblk, B);
  fa_decode_kernel<T, HD, GB><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_gb(const DecArgs& a, int B, int KVH, int gb, cudaStream_t st) {
  switch (gb) {
    case 1: return launch<T, HD, 1>(a, B, KVH, st);
    case 2: return launch<T, HD, 2>(a, B, KVH, st);
    case 4: return launch<T, HD, 4>(a, B, KVH, st);
    case 8: return launch<T, HD, 8>(a, B, KVH, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_hd(const DecArgs& a, int B, int KVH, int hd, int gb,
              cudaStream_t st) {
  switch (hd) {
    case 32: return launch_gb<T, 32>(a, B, KVH, gb, st);
    case 64: return launch_gb<T, 64>(a, B, KVH, gb, st);
    case 96: return launch_gb<T, 96>(a, B, KVH, gb, st);
    case 128: return launch_gb<T, 128>(a, B, KVH, gb, st);
    case 192: return launch_gb<T, 192>(a, B, KVH, gb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// q (B, 1, H, hd), k/v (B, S, KVH, hd), out (B, 1, H, hd): strides in
// elements (q's and out's batch and head strides), the hd axis contiguous;
// q, k, v and out 16-byte aligned with strides in whole 16-byte units.
// hd in {32, 64, 96, 128, 192}; gb (query heads a block) in {1, 2, 4, 8};
// n_gblk = ceil(G / gb), G = H / KVH.  The keys [lo, S) are cut into n_span spans of
// span_len keys (n_span <= 512, no span empty).  With n_span > 1, with
// groups = B * KVH * n_gblk and n_set = ceil(n_span / 8): part_acc and
// part_ml hold groups * (n_span + n_set) * gb * hd and ... * gb * 2 floats,
// tickets groups * (1 + n_set) ints, zero before the launch and left zero
// by it.  Returns cudaGetLastError() after the launch.
extern "C" int fedsikd_flash_attention_decode(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, void* tickets, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh, int B,
    int S, int H, int KVH, int hd, int gb, int n_gblk, int lo, int n_span,
    int span_len, int dtype, float scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || gb < 1 || n_gblk < 1 ||
      static_cast<long long>(n_gblk) * gb < H / KVH || lo < 0 || lo >= S ||
      n_span < 1 || n_span > kMaxSpans || span_len < 1 ||
      static_cast<long long>(n_span) * span_len < S - lo ||
      static_cast<long long>(n_span - 1) * span_len >= S - lo ||
      (n_span > 1 && (part_acc == nullptr || part_ml == nullptr ||
                      tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.q_sb = q_sb; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_sh = o_sh;
  a.S = S;
  a.G = H / KVH;
  a.n_gblk = n_gblk;
  a.lo = lo;
  a.n_span = n_span;
  a.span_len = span_len;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_hd<float>(a, B, KVH, hd, gb, st);
    case kBF16: return launch_hd<__nv_bfloat16>(a, B, KVH, hd, gb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
