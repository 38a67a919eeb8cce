// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dQ,
// dK, dV from dO, O and the forward's row logsumexp. bf16 in and out,
// fp32 sums.
//
// Replaces: the backward half of the Pallas TPU flash attention that
// visionllm_tpu/ops/attention.py:multi_head_attention reaches under
// jax.grad, _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// (jax/experimental/pallas/ops/tpu/flash_attention.py).
//
// Semantics are the forward kernel's (flash_attn_fwd.cu): S = Q K^T,
// masked by start-aligned causality (key <= query), segment ids and the
// ragged edges, P = exp(scale S - LSE) with LSE the forward's row
// logsumexp. With Di = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = scale P * (dP - Di),
//   dQ = dS K,  dK = dS^T Q.
// As in the Pallas kernel, P is rounded to bf16 before P^T dO, and dS
// (scale included) to bf16 before dS K and dS^T Q; every sum is fp32.
// GQA is native: kv head hk serves query heads hk*group .. hk*group +
// group - 1 and its dK / dV sum over them, so no K / V repeat is made.
//
// Bound on an H100: at the LLaMA-7B prefill (B 1, L 586, 32 heads x 128,
// causal) a call reads q, k, v, o, dO and writes dq, dk, dv, 8 x 4.8 MB
// (11.5 us at 3.35 TB/s), and needs five [L, L] x D products over the
// causal half, 7 GFLOP (7.1 us on the bf16 tensor cores): bytes bound
// it, the tensor-core rate close behind. Recomputing S and dP in both
// kernels (seven products over whole 64 x 64 tiles) makes the work the
// tensor cores do about 26 GFLOP, so every product runs on them.
//
// Design: two launches, no atomics, so the result is bit-reproducible.
// Kernel 1 writes Di. Kernel 2 is one grid of dQ blocks and dK/dV
// blocks, both the forward's FlashAttention-2 tiling on
// mma.sync.m16n8k16 (bf16 fragments, fp32 accumulators): 4 warps a
// block, 16 rows a warp, 64-row tiles through a 2-stage ring of 16-byte
// cp.async copies into XOR-swizzled shared memory, one barrier per tile,
// operands read by ldmatrix (.trans where the product needs the tile
// transposed). P and dS never leave registers: they are formed in the S
// and dP accumulators and packed to bf16 as the A fragments of the next
// products.
//  - dQ block (head, batch, 64-query tile): the Q and dO tiles stay in
//    shared memory; 64-key K/V tiles and their segment ids come through
//    the ring, tiles above the diagonal are skipped. S = Q K^T and
//    dP = dO V^T (K, V by ldmatrix), P and dS in the accumulators with
//    each thread's two rows' LSE and Di held in registers, then
//    dQ += dS K (K by ldmatrix.trans).
//  - dK/dV block (kv head, batch, 64-key tile): K and V stay in shared
//    memory; the query tiles of every head of the GQA group, in a fixed
//    order (from the key tile's own diagonal under causality), come
//    through the ring with their LSE, Di and segment ids. S^T = K Q^T and
//    dP^T = V dO^T, P^T and dS^T in the accumulators with LSE and Di per
//    column from shared memory, then dV += P^T dO and dK += dS^T Q (dO
//    and Q by ldmatrix.trans). At D 128 a warp's dK and dV accumulators
//    take 128 registers, so each query tile is walked in two halves of 32.
//  - The grid walks rounds r = 0, 1, ...: the dK/dV blocks of key tile
//    r, then the dQ blocks of query tile nq - 1 - r. Under causality that
//    is heaviest first for both kinds, and the short blocks of both fill
//    the last wave, which two separate kernels left half empty.
// Queries past Lq and keys past Lk are zero-filled rows: a zero Q or dO
// row (with zero LSE and Di) adds nothing to dK or dV, and rows of dK
// and dV past Lk are not written; key columns past Lk are masked in dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per tile, 16 per warp in dQ
constexpr int BK = 64;       // keys per tile, 16 per warp in dK/dV
constexpr int STAGES = 2;    // ring depth: tile t+1 loads during t
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

static_assert(THREADS == 2 * BQ, "the LSE / Di staging gives a thread each");

template <int D>
struct Smem {
  static constexpr int TILE = BK * D;   // bf16 elements of one tile
  // dK/dV: K, V, the Q/dO ring and the ring's LSE, Di and segment ids;
  // dQ uses less: Q, dO, the K/V ring and the ring's segment ids
  static constexpr size_t bytes = (2 + 2 * STAGES) * TILE * 2 +
                                  3 * STAGES * BQ * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false nothing is read and the 16 bytes
// of shared memory are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of a 16 x 16 chunk held as two n8 accumulator tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// LSE * log2 e, the subtrahend of P = exp2(S scale log2 e - it); a row
// that attends nothing (LSE -inf) gets +inf, so its P is 0, not NaN
__device__ __forceinline__ float lse2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * LOG2E;
}

// element offset of (row, 16-byte chunk c) in a swizzled [rows, D] tile
template <int D>
__device__ __forceinline__ int swz(int row, int c) {
  return row * D + ((c ^ (row & 7)) << 3);
}

// rows [r0, r0 + 64) of a [L, D] operand with row stride `ld` into a
// swizzled tile; rows at or past L are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int r0, int L,
                                          int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < BK * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < L;
    cp_async16(dst + swz<D>(r, c), ok ? src + (r0 + r) * ld + c * 8 : src,
               ok);
  }
}

// Fragment addresses in a swizzled tile, for this lane of a warp:
// the A operand, rows r0 .. r0+15, k columns 16 ks .. 16 ks + 15
template <int D>
__device__ __forceinline__ int frag_a(int r0, int ks, int lane) {
  return swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * ks + (lane >> 4));
}
// the B operand of two n8 tiles stored [n][k]: n rows n0 .. n0+15
template <int D>
__device__ __forceinline__ int frag_b(int n0, int ks, int lane) {
  return swz<D>(n0 + (lane & 7) + (lane >> 4) * 8, 2 * ks + ((lane >> 3) & 1));
}
// the B operand of two n8 tiles stored [k][n] (ldmatrix.trans): k rows
// k0 .. k0+15, n columns 16 nd .. 16 nd + 15
template <int D>
__device__ __forceinline__ int frag_bt(int k0, int nd, int lane) {
  return swz<D>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * nd + (lane >> 4));
}

// The kernels' arguments. q, o, dout, dq: [B, Lq, H, D]; k, v, dk, dv:
// [B, Lk, H / group, D]; lse, di: [B, H, Lq]; seg: null or [B, Lq].
struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  const int* seg;
  float* di;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Lq, Lk, H, group, causal;
  float scale;
};

// Kernel 1: Di = rowsum(dO * O). Each thread reads one 16-byte chunk of
// O and of dO, and the D / 8 threads of a row sum by shuffles in a fixed
// order.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_di_kernel(Args a) {
  constexpr int CH = D / 8;                        // chunks (lanes) a row
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const long long row = e / CH;        // (b * Lq + query) * H + head
  const bool in = row < static_cast<long long>(a.B) * a.Lq * a.H;
  float acc = 0.f;
  if (in) {
    const uint4 x = reinterpret_cast<const uint4*>(a.o)[e];
    const uint4 y = reinterpret_cast<const uint4*>(a.dout)[e];
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = __bfloat1622float2(x2[j]);
      const float2 w = __bfloat1622float2(y2[j]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off < CH; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && e % CH == 0) {
    const long long h = row % a.H, bq = row / a.H;
    a.di[(bq / a.Lq * a.H + h) * a.Lq + bq % a.Lq] = acc;
  }
}

// dQ of one block: head h, batch b, queries q0 .. q0 + 63.
template <int D>
__device__ __forceinline__ void dq_block(const Args& a, int h, int b, int q0,
                                         unsigned char* smem_raw) {
  constexpr int KS = D / 16;    // k16 steps of Q K^T and dO V^T
  constexpr int ND = D / 8;     // n8 tiles of dQ
  constexpr int TILE = Smem<D>::TILE;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + TILE;
  __nv_bfloat16* ring = sdo + TILE;
  int* sseg = reinterpret_cast<int*>(ring + STAGES * 2 * TILE);

  const int Lq = a.Lq, Lk = a.Lk, H = a.H, causal = a.causal;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = h / a.group;
  const long long qrow = static_cast<long long>(H) * D;
  const long long krow = static_cast<long long>(H / a.group) * D;
  const long long qoff = static_cast<long long>(b) * Lq * qrow + h * D;
  const long long koff = static_cast<long long>(b) * Lk * krow + hk * D;
  const long long bh = static_cast<long long>(b) * H + h;
  const int* sg = a.seg ? a.seg + static_cast<long long>(b) * Lq : nullptr;

  const int k_end = causal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * BK;
    load_tile<D>(ring + 2 * st * TILE, a.k + koff, krow, k0, Lk, tid);
    load_tile<D>(ring + (2 * st + 1) * TILE, a.v + koff, krow, k0, Lk, tid);
    if (sg && tid < BK) {
      const bool ok = k0 + tid < Lk;
      cp_async4(sseg + st * BK + tid, ok ? sg + k0 + tid : sg, ok);
    }
  };

  // prologue: Q, dO and key tile 0 in one commit group
  load_tile<D>(sq, a.q + qoff, qrow, q0, Lq, tid);
  load_tile<D>(sdo, a.dout + qoff, qrow, q0, Lq, tid);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows: warp * 16 + g and + 8
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float l2_0 = row0 < Lq ? lse2(a.lse[bh * Lq + row0]) : INFINITY;
  const float l2_1 = row1 < Lq ? lse2(a.lse[bh * Lq + row1]) : INFINITY;
  const float di0 = row0 < Lq ? a.di[bh * Lq + row0] : 0.f;
  const float di1 = row1 < Lq ? a.di[bh * Lq + row1] : 0.f;
  const int qseg0 = (sg && row0 < Lq) ? sg[row0] : 0;
  const int qseg1 = (sg && row1 < Lq) ? sg[row1] : 0;
  const float sl2 = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int stage = 0, next = STAGES - 1;   // stage of tile t, of tile t+1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // this thread's copies of tile t landed
    // every thread's copies are visible, every warp is done with t-1
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1, next);
    cp_async_commit();

    const __nv_bfloat16* sk = ring + 2 * stage * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    const int k0 = t * BK;

    const bool need_mask = sg != nullptr || k0 + BK > Lk ||
                           (causal && k0 + BK - 1 > q0);
    const int* ts = sseg + stage * BK;

    // S = Q K^T and dP = dO V^T over the tile: 8 n8 tiles each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, sq + frag_a<D>(warp * 16, ks, lane));
      ldsm_x4(da, sdo + frag_a<D>(warp * 16, ks, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, sk + frag_b<D>(np * 16, ks, lane));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        ldsm_x4(vf, sv + frag_b<D>(np * 16, ks, lane));
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // P = exp2(S scale log2 e - LSE log2 e), dS = (dP - Di) P scale,
    // in place of dP
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = fmaf(s[n][e], sl2, -l2_0);
        float x1 = fmaf(s[n][2 + e], sl2, -l2_1);
        if (need_mask) {
          const int jl = n * 8 + 2 * t4 + e;
          const int j = k0 + jl;
          const int kseg = sg ? ts[jl] : 0;
          const bool in = j < Lk;
          if (!(in && (!causal || j <= row0) && (!sg || kseg == qseg0)))
            x0 = -INFINITY;
          if (!(in && (!causal || j <= row1) && (!sg || kseg == qseg1)))
            x1 = -INFINITY;
        }
        dp[n][e] = (dp[n][e] - di0) * ex2(x0) * scale;
        dp[n][2 + e] = (dp[n][2 + e] - di1) * ex2(x1) * scale;
      }
    }

    // dQ += dS K, dS as bf16 A fragments straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, sk + frag_bt<D>(kk * 16, nd, lane));
        mma_bf16(acc[2 * nd], sa, kf[0], kf[1]);
        mma_bf16(acc[2 * nd + 1], sa, kf[2], kf[3]);
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    next = next + 1 == STAGES ? 0 : next + 1;
  }

  if (row0 < Lq) {
    __nv_bfloat16* r = a.dq + qoff + row0 * qrow;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(r + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
  }
  if (row1 < Lq) {
    __nv_bfloat16* r = a.dq + qoff + row1 * qrow;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(r + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// dK and dV of one block: kv head hk, batch b, keys k0 .. k0 + 63. W:
// queries a pass (32 at D 128, where dK and dV take 128 registers).
template <int D, int W>
__device__ __forceinline__ void dkv_block(const Args& a, int hk, int b,
                                          int k0, unsigned char* smem_raw) {
  constexpr int KS = D / 16;    // k16 steps of K Q^T and V dO^T
  constexpr int ND = D / 8;     // n8 tiles of dK and dV
  constexpr int NW = W / 8;     // n8 tiles of S^T in a pass
  constexpr int TILE = Smem<D>::TILE;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + TILE;
  __nv_bfloat16* ring = sv + TILE;    // stage st: Q, then dO
  float* slse = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  float* sdi = slse + STAGES * BQ;
  int* sseg = reinterpret_cast<int*>(sdi + STAGES * BQ);

  const int Lq = a.Lq, Lk = a.Lk, H = a.H, group = a.group;
  const int causal = a.causal;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qrow = static_cast<long long>(H) * D;
  const long long krow = static_cast<long long>(H / group) * D;
  const long long koff = static_cast<long long>(b) * Lk * krow + hk * D;
  const int* sg = a.seg ? a.seg + static_cast<long long>(b) * Lq : nullptr;

  // the query tiles of every head of the group, as one sequence
  const int t_first = causal ? k0 / BQ : 0;
  const int per_head = (Lq + BQ - 1) / BQ - t_first;
  const int n_it = group * per_head;

  auto load_q = [&](int it, int st) {
    const int h = hk * group + it / per_head;
    const int q0 = (t_first + it % per_head) * BQ;
    const long long qoff = static_cast<long long>(b) * Lq * qrow + h * D;
    const long long bh = static_cast<long long>(b) * H + h;
    load_tile<D>(ring + 2 * st * TILE, a.q + qoff, qrow, q0, Lq, tid);
    load_tile<D>(ring + (2 * st + 1) * TILE, a.dout + qoff, qrow, q0, Lq,
                 tid);
    // rows past Lq get LSE 0 and Di 0: with their zero Q and dO rows
    // they add nothing
    const int r = tid % BQ;
    const bool ok = q0 + r < Lq;
    if (tid < BQ) {
      cp_async4(slse + st * BQ + r, ok ? a.lse + bh * Lq + q0 + r : a.lse,
                ok);
      if (sg) cp_async4(sseg + st * BQ + r, ok ? sg + q0 + r : sg, ok);
    } else {
      cp_async4(sdi + st * BQ + r, ok ? a.di + bh * Lq + q0 + r : a.di, ok);
    }
  };

  // prologue: K, V and query tile 0 in one commit group
  load_tile<D>(sk, a.k + koff, krow, k0, Lk, tid);
  load_tile<D>(sv, a.v + koff, krow, k0, Lk, tid);
  load_q(0, 0);
  cp_async_commit();

  // this thread's keys: warp * 16 + g and + 8
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int kseg0 = (sg && key0 < Lk) ? sg[key0] : 0;
  const int kseg1 = (sg && key1 < Lk) ? sg[key1] : 0;
  const float sl2 = scale * LOG2E;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  int stage = 0, next = STAGES - 1;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1, next);
    cp_async_commit();

    const __nv_bfloat16* sq = ring + 2 * stage * TILE;
    const __nv_bfloat16* sdo = sq + TILE;
    const float* ls = slse + stage * BQ;
    const float* ds = sdi + stage * BQ;
    const int* ss = sseg + stage * BQ;
    const int q0 = (t_first + it % per_head) * BQ;
    const bool need_mask = sg != nullptr || (causal && q0 < k0 + BK - 1);

#pragma unroll
    for (int c = 0; c < BQ / W; ++c) {
      // S^T = K Q^T and dP^T = V dO^T over queries c W .. c W + W - 1
      float s[NW][4], dp[NW][4];
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sk + frag_a<D>(warp * 16, ks, lane));
        ldsm_x4(va, sv + frag_a<D>(warp * 16, ks, lane));
#pragma unroll
        for (int np = 0; np < NW / 2; ++np) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, sq + frag_b<D>(c * W + np * 16, ks, lane));
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          ldsm_x4(of, sdo + frag_b<D>(c * W + np * 16, ks, lane));
          mma_bf16(dp[2 * np], va, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
        }
      }

      // P^T into s, dS^T = (dP^T - Di) P^T scale into dp; LSE and Di of
      // the two query columns of each n8 tile this thread holds
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const int il = c * W + n * 8 + 2 * t4;
        const float2 lv = *reinterpret_cast<const float2*>(ls + il);
        const float2 dv2 = *reinterpret_cast<const float2*>(ds + il);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = lse2(e ? lv.y : lv.x);
          const float d_i = e ? dv2.y : dv2.x;
          float x0 = fmaf(s[n][e], sl2, -l2);
          float x1 = fmaf(s[n][2 + e], sl2, -l2);
          if (need_mask) {
            const int i = q0 + il + e;
            const int qs = sg ? ss[il + e] : 0;
            if (!((!causal || key0 <= i) && (!sg || qs == kseg0)))
              x0 = -INFINITY;
            if (!((!causal || key1 <= i) && (!sg || qs == kseg1)))
              x1 = -INFINITY;
          }
          const float p0 = ex2(x0), p1 = ex2(x1);
          s[n][e] = p0;
          s[n][2 + e] = p1;
          dp[n][e] = (dp[n][e] - d_i) * p0 * scale;
          dp[n][2 + e] = (dp[n][2 + e] - d_i) * p1 * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t of[4], qf[4];
          ldsm_x4_trans(of, sdo + frag_bt<D>(c * W + kk * 16, nd, lane));
          mma_bf16(acc_v[2 * nd], pa, of[0], of[1]);
          mma_bf16(acc_v[2 * nd + 1], pa, of[2], of[3]);
          ldsm_x4_trans(qf, sq + frag_bt<D>(c * W + kk * 16, nd, lane));
          mma_bf16(acc_k[2 * nd], sa, qf[0], qf[1]);
          mma_bf16(acc_k[2 * nd + 1], sa, qf[2], qf[3]);
        }
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    next = next + 1 == STAGES ? 0 : next + 1;
  }

  if (key0 < Lk) {
    const long long off = koff + key0 * krow;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc_k[n][0], acc_k[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc_v[n][0], acc_v[n][1]);
    }
  }
  if (key1 < Lk) {
    const long long off = koff + key1 * krow;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc_k[n][2], acc_k[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc_v[n][2], acc_v[n][3]);
    }
  }
}

// Kernel 2: every dK/dV block and every dQ block of the call in one
// grid, in the rounds of the design note above.
template <int D, int W>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nq = (a.Lq + BQ - 1) / BQ, nk = (a.Lk + BK - 1) / BK;
  const int H_kv = a.H / a.group;
  const int n_dkv = a.B * H_kv, n_dq = a.B * a.H;   // blocks a round
  int id = blockIdx.x;
  for (int r = 0;; ++r) {
    if (r < nk) {
      if (id < n_dkv) {
        dkv_block<D, W>(a, id % H_kv, id / H_kv, r * BK, smem_raw);
        return;
      }
      id -= n_dkv;
    }
    if (r < nq) {
      if (id < n_dq) {
        dq_block<D>(a, id % a.H, id / a.H, (nq - 1 - r) * BQ, smem_raw);
        return;
      }
      id -= n_dq;
    }
  }
}

// the dynamic shared memory limit is raised once per device
template <typename Kernel>
cudaError_t set_smem_limit(Kernel* kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int W = D == 128 ? 32 : 64;    // queries a dK/dV pass
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_limit(flash_bwd_kernel<D, W>, Smem<D>::bytes,
                                   done);
  if (err != cudaSuccess) return err;
  const long long chunks = static_cast<long long>(a.B) * a.Lq * a.H * D / 8;
  flash_bwd_di_kernel<D><<<static_cast<unsigned>(
                               (chunks + THREADS - 1) / THREADS),
                           THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nq = (a.Lq + BQ - 1) / BQ, nk = (a.Lk + BK - 1) / BK;
  const unsigned blocks = static_cast<unsigned>(
      nk * a.B * (a.H / a.group) + nq * a.B * a.H);
  flash_bwd_kernel<D, W><<<blocks, THREADS, Smem<D>::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [B, Lq, H, D]; k, v, dk, dv: [B, Lk, H_kv, D], all bf16,
// contiguous and 16-byte aligned; lse (from the forward) and di (scratch):
// fp32 [B, H, Lq]; seg: null or int32 [B, Lq] (Lq == Lk). Launches two
// kernels on `stream`: Di into di, then the dQ and dK/dV blocks.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, const void* seg, void* di,
                                   void* dq, void* dk, void* dv, int B, int Lq,
                                   int Lk, int H, int H_kv, int D, int causal,
                                   float scale, void* stream) {
  if (H_kv <= 0 || H % H_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Lq <= 0 || Lk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(o),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse), static_cast<const int*>(seg),
               static_cast<float*>(di), static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), B, Lq, Lk, H, H / H_kv,
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64>(a, s);
  else if (D == 128)
    err = launch<128>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
