// Flash-attention forward for Hopper (sm_90a) on the tensor cores, bf16
// in/out, fp32 softmax and sums.
//
// Replaces: visionllm_tpu/ops/attention.py:multi_head_attention, flash
// branch, which calls the Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention.
//
// Computes softmax(Q K^T * scale) V exactly by online softmax, never
// writing the [Lq, Lk] scores. Options: causal (start-aligned: query i
// attends keys <= i; the wrapper allows it only for Lq == Lk), int32
// segment ids [B, L] (only equal ids attend), native GQA (KV head =
// h / (H / H_kv), no repeat). The kernel masks the ragged edges itself,
// so no padding to a tile multiple is needed; rows that attend no key
// come out as zeros.
//
// Bound on an H100: at LLaMA-7B prefill (B1 L586 32x128 causal) a call
// moves 19.2 MB (q, k, v read and o written once: 5.7 us at 3.35 TB/s)
// for 2.82 GFLOP over the causal pairs (2.9 us on the bf16 tensor cores
// at 989 TFLOP/s); CLIP-L (L577 16x64) moves 4.7 MB for 1.4 GFLOP. So
// the bytes set the least time, with the tensor-core rate close behind:
// both products have to run on the tensor cores, and every operand has
// to come from device memory once per block and from shared memory
// without bank conflicts.
//
// Design (FlashAttention-2 on mma.sync): a block of 4 warps per (head,
// batch, 64-row query tile); each warp owns 16 whole query rows, so the
// row max and row sum reduce within a quad of lanes by shuffles.
//  - Both products are mma.sync.m16n8k16 bf16 with fp32 accumulation.
//    Q is loaded once into registers as A fragments (ldmatrix), kept in
//    bf16; the scale (times log2 e, for ex2) goes on the fp32 S tile.
//    K is read with ldmatrix, V with ldmatrix.trans.
//  - P stays in registers: each 16x16 pair of S accumulator tiles is
//    exponentiated, packed to bf16 and fed as the A fragment of P V. The
//    unnormalised P is rounded to bf16 before P V, as the Pallas kernel
//    does (`p.astype(v.dtype)`, flash_attention.py:470-471); the row sum
//    l is taken in fp32. O is rescaled by exp(m_old - m_new) per row and
//    divided by l once at the end.
//  - 64-key K/V tiles arrive by 16-byte cp.async into a ring of 2 stages,
//    each with its segment ids, behind one barrier per tile: past it,
//    tile t+1 is issued into the stage tile t-1 used, and tile t is
//    computed while it loads. (A third stage measured no faster: the
//    copies are not what waits.) Rows past Lk are zero-filled (cp.async
//    with src-size 0) and their columns masked to -inf. Shared memory is
//    laid out with the 16-byte chunk index XORed with (row & 7), so
//    ldmatrix reads of 8 rows at one chunk hit 8 different bank groups.
//  - The query tile is staged through the last ring stage before the
//    loop: 32.5 KB of shared memory a block for D 64, 64.5 KB for D 128.
//    ptxas gives D 128 about 250 registers (two blocks an SM) and D 64
//    about 160, with no spills; capping D 128 at 168 to fit three blocks
//    spilled and ran slower.
//  - Causal: key tiles above the diagonal are skipped, and only the
//    diagonal tile, the ragged last tile and segmented inputs are
//    masked. The query tile is the slowest grid dimension, walked from
//    the last (heaviest) tile, so the last wave holds the short tiles.
//
// With a non-null `lse` (fp32 [B, H, Lq]) the kernel also writes each
// row's logsumexp of the scaled scores (-inf for a fully masked row), the
// statistic the backward kernels (flash_attn_bwd.cu) recompute P from.
// Inference passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BK = 64;       // keys per tile
constexpr int STAGES = 2;    // K/V ring depth: tile t+1 loads during t
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int TILE = BK * D;   // bf16 elements of one K or V tile
  // ring: stage s holds K at [2 s TILE, ...) and V right after it, then
  // the segment ids of every stage
  static constexpr size_t bytes = STAGES * 2 * TILE * sizeof(__nv_bfloat16) +
                                  STAGES * BK * sizeof(int);
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// element offset of (row, 16-byte chunk c) in a swizzled [rows, D] tile
template <int D>
__device__ __forceinline__ int swz(int row, int c) {
  return row * D + ((c ^ (row & 7)) << 3);
}

// rows [r0, r0 + BK) of a [L, D] operand with row stride `ld` into a
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 const int* __restrict__ seg,
                 int Lq, int Lk, int H, int group,
                 long long sqb, long long sql, long long sqh,
                 long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh,
                 long long sob, long long sol, long long soh,
                 long long segb, int causal, float scale) {
  constexpr int KS = D / 16;    // k16 steps of Q K^T
  constexpr int ND = D / 8;     // n8 tiles of O
  constexpr int TILE = Smem<D>::TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* sseg = reinterpret_cast<int*>(ring + STAGES * 2 * TILE);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int hk = h / group;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;
  const int* sg = seg ? seg + b * segb : nullptr;

  const int k_end = causal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // rows of this thread: warp * 16 + g and + 8
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int qseg0 = (sg && row0 < Lq) ? sg[row0] : 0;
  const int qseg1 = (sg && row1 < Lq) ? sg[row1] : 0;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * BK;
    load_tile<D>(ring + 2 * st * TILE, kb, skl, k0, Lk, tid);
    load_tile<D>(ring + (2 * st + 1) * TILE, vb, svl, k0, Lk, tid);
    if (sg && tid < BK) {
      const bool ok = k0 + tid < Lk;
      cp_async4(sseg + st * BK + tid, ok ? sg + k0 + tid : sg, ok);
    }
  };

  // prologue: the query tile into the last stage, tiles 0 .. STAGES-2
  // into the others, one commit group each (Q goes with tile 0)
  const __nv_bfloat16* sq = ring + 2 * (STAGES - 1) * TILE;
  load_tile<D>(const_cast<__nv_bfloat16*>(sq), qb, sql, q0, Lq, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t qf[KS][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(qf[ks], sq + swz<D>(r, 2 * ks + (lane >> 4)));
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * LOG2E;

  int stage = 0, next = STAGES - 1;   // stage of tile t, of tile t+STAGES-1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile t landed
    // every thread's copies of tile t are visible, and every warp is done
    // with tile t-1, whose stage (or, at t = 0, the query tile's) is next
    __syncthreads();
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1, next);
    cp_async_commit();

    const __nv_bfloat16* sk = ring + 2 * stage * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    const int k0 = t * BK;

    // S = Q K^T over this tile: 8 n8 tiles of 16 rows
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, sk + swz<D>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                2 * ks + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    const bool need_mask = sg != nullptr || k0 + BK > Lk ||
                           (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
    }
    if (need_mask) {
      const int* ts = sseg + stage * BK;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = n * 8 + 2 * t4 + e;
          const int j = k0 + jl;
          const int kseg = sg ? ts[jl] : 0;
          const bool in = j < Lk;
          if (!(in && (!causal || j <= row0) && (!sg || kseg == qseg0)))
            s[n][e] = -INFINITY;
          if (!(in && (!causal || j <= row1) && (!sg || kseg == qseg1)))
            s[n][2 + e] = -INFINITY;
        }
      }
    }

    // online softmax for rows g (elements 0, 1) and g + 8 (2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with no key yet keeps m = -inf: subtract 0 so exp gives 0
    const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
    const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(s[n][0] - mu0);
      s[n][1] = ex2(s[n][1] - mu0);
      s[n][2] = ex2(s[n][2] - mu1);
      s[n][3] = ex2(s[n][3] - mu1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + rs0;   // quad partial sums, reduced at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, sv + swz<D>(kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      2 * dp + (lane >> 4)));
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    next = next + 1 == STAGES ? 0 : next + 1;
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (row0 < Lq) {
    __nv_bfloat16* orow = o + b * sob + row0 * sol + h * soh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (lse && t4 == 0)
      lse[(static_cast<long long>(b) * H + h) * Lq + row0] =
          l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -INFINITY;
  }
  if (row1 < Lq) {
    __nv_bfloat16* orow = o + b * sob + row1 * sol + h * soh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    if (lse && t4 == 0)
      lse[(static_cast<long long>(b) * H + h) * Lq + row1] =
          l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -INFINITY;
  }
}

// the dynamic shared memory limit is raised once per device
template <int D>
cudaError_t set_smem_limit() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<D>::bytes));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* seg, int B, int Lq, int Lk, int H,
                   int H_kv, const long long* st, long long segb, int causal,
                   float scale, cudaStream_t stream) {
  cudaError_t err = set_smem_limit<D>();
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, Smem<D>::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(seg), Lq, Lk, H,
      H / H_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], segb, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o; those
// of q, k and v multiples of 8 and the pointers 16-byte aligned (the
// wrapper checks both). lse: null, or fp32 [B, H, Lq] contiguous.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* seg, int B,
                                   int Lq, int Lk, int H, int H_kv, int D,
                                   const long long* strides, long long segb,
                                   int causal, float scale, void* stream) {
  if (H_kv <= 0 || H % H_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Lq <= 0 || Lk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64>(q, k, v, o, lse, seg, B, Lq, Lk, H, H_kv, strides, segb,
                     causal, scale, s);
  else if (D == 128)
    err = launch<128>(q, k, v, o, lse, seg, B, Lq, Lk, H, H_kv, strides, segb,
                      causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
