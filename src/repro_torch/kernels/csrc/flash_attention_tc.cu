// Block flash attention (forward, grouped-query heads) for bf16 prefill on
// Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_fa_kernel  (via flash_attention)
// for bfloat16 inputs with T > 1 (the wrapper's dispatch; float32 with
// T > 1 stays on csrc/flash_attention.cu, T = 1 goes to
// csrc/flash_attention_decode.cu).
//
// The function is the first kernel's exactly: q (B, T, H, hd), k and v
// (B, S, KVH, hd), out (B, T, H, hd), each through its own batch, sequence
// and head strides with hd contiguous; query head h reads kv head h / G;
// the right-aligned causal mask (query t sees key s iff s <= t + S - T,
// and with `window` > 0 also s > t + S - T - window); masked scores are
// the finite -1e30 of the TPU kernel, so a query that sees no key (T > S)
// averages V; keys past S do not exist (nothing is padded); softmax and
// both products to float32 accuracy, the output rounded once to bf16.
//
// What bounds it on the H100: operations.  The serving prefill (B 2, H 16,
// T = S = 4096, hd 128) is 137 GFLOP of causal products, 0.139 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 0.023 ms of bytes.
//
// The design:
// - A block of 4 warps owns 64 query positions of one head, 16 a warp,
//   with the Q fragments in registers (loaded once by ldmatrix) up to hd
//   128.  A thread holds 64 f32 of O, 32 of S and 32 registers of Q at hd
//   128 (249 registers in all, by ptxas), so an SM runs 8 warps whether a
//   block has 4 or 8; 4 warps and 64 rows give twice the blocks for the
//   causal tail and half the wasted work on each diagonal tile.  At hd 192
//   O alone is 96 f32 a thread, and Q in registers (48 more) would pass
//   the 255-register limit: there each k-step of Q K^T reads its Q
//   fragment from shared memory (where Q stays for the whole block) by
//   one more ldmatrix, and a 64-key tile is walked in two parts of 32
//   keys, each its own online-softmax step, so S takes 16 registers.
// - K and V tiles of 64 keys go into shared memory by cp.async in two
//   stages (the next tile's copy in flight while the current one is used),
//   16-byte chunks XOR-swizzled so that every ldmatrix is conflict-free
//   (`swz`; hd 96's 12 chunks a row take their own pattern).  At hd 192
//   the tiles and Q take 120 KB of shared memory, one block an SM.
// - S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 sums): each product of
//   two bf16 values is exact in f32.  `scale` multiplies the f32 scores
//   after the product, as the plain version does.
// - The mask is applied on the score fragment, and only on tiles that
//   cross the diagonal, the window edge or S; a block walks only the key
//   tiles its rows can see (all of them when one of its rows sees none).
// - Online softmax on fragment rows, the row max by quad shuffles, and
//   exp2 of (s - m) * log2(e).
// - P has to keep float32 accuracy: P rounded once to bf16 breaks the
//   output's one-rounding tolerance.  So P is split in registers into
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V by
//   two mma.syncs with V read by ldmatrix.trans (the error of the split is
//   about 2^-17 of P).  l is the f32 sum of the unrounded P.
// - Blocks are launched heaviest causal Q tile first (blockIdx.y counts
//   down the tiles, blockIdx.x runs over batch and head), so the light
//   tiles fill the tail.
// wgmma with TMA and a producer warp is the next step.
#include "common.cuh"

namespace fedsikd {
namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBM = 64;         // query positions a block, 16 a warp
constexpr int kBN = 64;         // keys a tile
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int T, S, H, G, causal, window;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// P = hi + lo with hi = bf16(P), lo = bf16(P - hi); returns hi as float.
__device__ __forceinline__ float split_hi(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Element offset of 16-byte chunk `chunk` of row `row` in a (rows, HD)
// bf16 tile: the chunk index is XOR-ed with bits of the row, so the 8
// consecutive rows (from a multiple of 8) that one ldmatrix phase reads at
// one logical chunk land in 8 distinct 16-byte bank groups of the 128-byte
// line, and the chunk never leaves its row:
// - 8, 16 or 24 chunks a row (hd 64, 128, 192): chunk ^ (row & 7), within
//   each aligned group of 8 chunks;
// - 12 chunks (hd 96, rows of 192 bytes, so row r starts at bank group
//   4 (r & 1)): chunks 0-7 as above, chunks 8-11 ^ ((row >> 1) & 3), which
//   stays in 8-11 (row & 7 would send them to 8-15, past the row);
// - 4 chunks (hd 32, two rows a line): chunk ^ ((row >> 1) & 3).
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kCPR = HD / 8;
  static_assert(kCPR % 8 == 0 || kCPR == 12 || kCPR == 4,
                "no swizzle for this head dim");
  int c;
  if constexpr (kCPR % 8 == 0)
    c = chunk ^ (row & 7);
  else if constexpr (kCPR == 12)
    c = chunk < 8 ? chunk ^ (row & 7) : chunk ^ ((row >> 1) & 3);
  else
    c = chunk ^ ((row >> 1) & 3);
  return row * HD + (c << 3);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_tc_kernel(const TcArgs a) {
  constexpr int kKS = HD / 16;   // k-steps of Q K^T
  constexpr int kNT = HD / 8;    // 8-column tiles of O
  constexpr int kCPR = HD / 8;   // 16-byte chunks a row
  constexpr bool kQRegs = HD <= 128;   // Q's fragments held in registers
  // a key tile is walked in kSub parts of kSN keys (two at hd 192, which
  // halves S's registers)
  constexpr int kSub = HD > 128 ? 2 : 1;
  constexpr int kSN = kBN / kSub;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);   // [kBM][HD]
  bf16* const ks = qs + kBM * HD;                       // [2][kBN][HD]
  bf16* const vs = ks + 2 * kBN * HD;                   // [2][kBN][HD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tq = lane & 3;                   // column pair of a fragment
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest first
  const int t1 = min(t0 + kBM, a.T) - 1;
  const int off = a.S - a.T;                 // right alignment

  // The keys any row of the block can see; every key when one of its rows
  // sees none (it averages V over all S keys, as the reference does).
  int lo = 0, hi = a.S;
  if (a.causal && t0 + off >= 0) {
    hi = min(a.S, t1 + off + 1);
    if (a.window > 0) lo = max(0, t0 + off - a.window + 1);
  }
  const int n_tiles = (hi - lo + kBN - 1) / kBN;

  const bf16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kp = a.k + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + kvh * a.v_sh;

  for (int e = tid; e < kBM * kCPR; e += kThreads) {   // Q, rows past T 0
    const int r = e / kCPR, c = e % kCPR;
    const int t = t0 + r;
    cp_async16_zfill(
        smem_addr(qs + swz<HD>(r, c)),
        qp + static_cast<long long>(min(t, a.T - 1)) * a.q_st + c * 8,
        t < a.T);
  }
  // Keys kb .. kb + 63 of K and V into stage `st`; keys at or past `hi`
  // are zero (finite: their weight is 0, and 0 * V must stay 0).
  auto load_tile = [&](int kb, int st) {
    bf16* kd = ks + st * kBN * HD;
    bf16* vd = vs + st * kBN * HD;
    for (int e = tid; e < kBN * kCPR; e += kThreads) {
      const int r = e / kCPR, c = e % kCPR;
      const int key = kb + r;
      const long long s = key < hi ? key : lo;
      cp_async16_zfill(smem_addr(kd + swz<HD>(r, c)),
                       kp + s * a.k_ss + c * 8, key < hi);
      cp_async16_zfill(smem_addr(vd + swz<HD>(r, c)),
                       vp + s * a.v_ss + c * 8, key < hi);
    }
  };
  load_tile(lo, 0);
  cp_async_commit();

  unsigned qf[kQRegs ? kKS : 1][4];
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // this thread's two rows of the warp's 16: g and g + 8
  const int row0 = t0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(lo + (i + 1) * kBN, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                          // tile i (and Q) landed
    // this warp's A fragment of Q for k-step s (16 rows x 16 columns)
    auto load_q = [&](int s, unsigned* r) {
      ldsm_x4(smem_addr(qs + swz<HD>(warp * 16 + (lane & 7)
                                         + ((lane >> 3) & 1) * 8,
                                     2 * s + (lane >> 4))),
              r);
    };
    if constexpr (kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int s = 0; s < kKS; ++s) load_q(s, qf[s]);
      }
    }
    // the tile in kSub parts of kSN keys, each its own online-softmax step
#pragma unroll 1
    for (int sub = 0; sub < kSub; ++sub) {
      const int kb = lo + i * kBN + sub * kSN;
      // (a part starts at a multiple of 8 rows: the swizzle is unchanged)
      const bf16* kt = ks + ((i & 1) * kBN + sub * kSN) * HD;
      const bf16* vt = vs + ((i & 1) * kBN + sub * kSN) * HD;

      // S = Q K^T: 16 rows x kSN keys a warp, tiles of 8 keys
      float sc[kSN / 8][4];
#pragma unroll
      for (int n = 0; n < kSN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        const unsigned* qa = qf[kQRegs ? s : 0];
        if constexpr (!kQRegs) load_q(s, qf[0]);
#pragma unroll
        for (int np = 0; np < kSN / 16; ++np) {
          unsigned r[4];
          ldsm_x4(smem_addr(kt + swz<HD>(np * 16 + (lane & 7)
                                             + (lane >> 4) * 8,
                                         2 * s + ((lane >> 3) & 1))),
                  r);
          mma_bf16(sc[2 * np], qa, r[0], r[1]);
          mma_bf16(sc[2 * np + 1], qa, r[2], r[3]);
        }
      }

      // scale, mask (only on parts that need it), online softmax
      const bool edge =
          kb + kSN > a.S ||
          (a.causal && (kb + kSN - 1 > t0 + off ||
                        (a.window > 0 && kb <= t1 + off - a.window)));
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < kSN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * a.scale;
          if (edge) {
            const int key = kb + n * 8 + 2 * tq + (e & 1);
            const int lim = (e < 2 ? row0 : row1) + off;   // last key seen
            if (key >= a.S)
              x = -INFINITY;                   // no such key: weight 0
            else if (a.causal &&
                     (key > lim || (a.window > 0 && key <= lim - a.window)))
              x = kNeg;
          }
          sc[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float al0 = ex2((m0 - mx0) * kLog2e);
      const float al1 = ex2((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }

      // O += P_hi V + P_lo V, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < kSN / 16; ++kk) {
        unsigned ph[4], pl[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* c = sc[2 * kk + half];
          const float p0 = ex2((c[0] - m0) * kLog2e);
          const float p1 = ex2((c[1] - m0) * kLog2e);
          const float p2 = ex2((c[2] - m1) * kLog2e);
          const float p3 = ex2((c[3] - m1) * kLog2e);
          l0 += p0 + p1;
          l1 += p2 + p3;
          const float h0 = split_hi(p0), h1 = split_hi(p1);
          const float h2 = split_hi(p2), h3 = split_hi(p3);
          ph[2 * half] = pack_bf16(h0, h1);             // row g
          ph[2 * half + 1] = pack_bf16(h2, h3);         // row g + 8
          pl[2 * half] = pack_bf16(p0 - h0, p1 - h1);
          pl[2 * half + 1] = pack_bf16(p2 - h2, p3 - h3);
        }
#pragma unroll
        for (int dp = 0; dp < kNT / 2; ++dp) {
          unsigned r[4];
          ldsm_x4_trans(smem_addr(vt + swz<HD>(kk * 16 + (lane & 7)
                                                   + ((lane >> 3) & 1) * 8,
                                               2 * dp + (lane >> 4))),
                        r);
          mma_bf16(o[2 * dp], ph, r[0], r[1]);
          mma_bf16(o[2 * dp], pl, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], ph, r[2], r[3]);
          mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
        }
      }
    }
    __syncthreads();                          // done reading this stage
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* op = a.out + b * a.o_sb + h * a.o_sh + 2 * tq;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (row0 < a.T)
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * a.o_st + n * 8) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (row1 < a.T)
      *reinterpret_cast<__nv_bfloat162*>(op + row1 * a.o_st + n * 8) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int HD>
int launch(const TcArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = (kBM + 4 * kBN) * HD * static_cast<int>(sizeof(bf16));
  // above 48 KB (hd 96 and up) only after this opt-in; 120 KB at hd 192
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.T + kBM - 1) / kBM);
  fa_tc_kernel<HD><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fedsikd

using namespace fedsikd;

// bf16 q (B, T, H, hd), k/v (B, S, KVH, hd), out (B, T, H, hd): strides in
// elements, the hd axis contiguous; q, k and v 16-byte aligned with
// strides in whole 16-byte units (the cp.async copies), out 4-byte
// aligned.  hd in {32, 64, 96, 128, 192}; H % KVH == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int fedsikd_flash_attention_tc(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int B, int T, int S,
    int H, int KVH, int hd, int causal, int window, float scale,
    void* stream) {
  if (B < 1 || T < 1 || S < 1 || KVH < 1 || H % KVH != 0 || window < 0 ||
      static_cast<long long>(T + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_st = o_st; a.o_sh = o_sh;
  a.T = T;
  a.S = S;
  a.H = H;
  a.G = H / KVH;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 96: return launch<96>(a, B, st);
    case 128: return launch<128>(a, B, st);
    case 192: return launch<192>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
