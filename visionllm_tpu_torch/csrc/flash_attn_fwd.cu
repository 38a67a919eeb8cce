// Flash-attention forward for Hopper (sm_90a), bf16 in/out, fp32 softmax.
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
// so no padding to a tile multiple is needed.
//
// Bound on an H100: at the main-path shapes (CLIP-L L=577 16x64; LLaMA-7B
// prefill L=586 32x128 causal) a call moves 4.7-19 MB (q, k, v read and
// o written once: 1.4-5.7 us at 3.35 TB/s) for 1.4-2.8 GFLOP (1.4-2.8 us
// on the bf16 tensor cores), so the bytes set the least time, with the
// tensor-core rate close behind. This first version does its two
// products with scalar fp32 FMAs from shared memory, so it is bound by
// FMA issue and shared-memory reads instead; mma/wgmma tiles are later
// work.
//
// Design: one block of 256 threads per (batch, head, 64-row query tile).
// The query tile is staged once in shared memory (fp32, pre-scaled);
// 64-key K/V tiles are staged as bf16 per step. Thread (ty, tx) of a
// 16x16 grid owns query rows ty + 16 i (i < 4), score columns tx + 16 j
// (j < 4) and output columns tx + 16 c (c < D/16): the interleave keeps
// shared-memory reads free of bank conflicts, and the row max / row sum
// reduce over the 16 lanes that share a row with warp shuffles. The
// probabilities of a tile go through shared memory to the P V product.
// Fully masked rows produce zeros.
//
// With a non-null `lse` (fp32 [B, H, Lq]) the kernel also writes each
// row's logsumexp of the scaled scores (-inf for a fully masked row), the
// statistic the backward kernels (flash_attn_bwd.cu) recompute P from.
// Inference passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

template <int D>
struct Smem {
  static constexpr int QS = D + 2;        // floats per sQ row (even: float2)
  static constexpr int KS2 = D / 2 + 1;   // bf16 pairs per sK row (odd)
  static constexpr int PS = BK + 1;       // floats per sP row
  static constexpr size_t bytes =
      sizeof(float) * BQ * QS + sizeof(__nv_bfloat162) * BK * KS2 +
      sizeof(__nv_bfloat16) * BK * D + sizeof(float) * BQ * PS;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 const int* __restrict__ seg,
                 int Lq, int Lk, int group,
                 long long sqb, long long sql, long long sqh,
                 long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh,
                 long long sob, long long sol, long long soh,
                 long long segb, int causal, float scale) {
  using S = Smem<D>;
  constexpr int CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat162* sK = reinterpret_cast<__nv_bfloat162*>(sQ + BQ * S::QS);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sK + BK * S::KS2);
  float* sP = reinterpret_cast<float*>(sV + BK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;
  const int* sg = seg ? seg + b * segb : nullptr;

  // stage the query tile, pre-scaled, in fp32
  for (int e = tid; e < BQ * D / 2; e += THREADS) {
    const int r = e / (D / 2), d2 = e % (D / 2);
    const int qi = q0 + r;
    float2 val = make_float2(0.f, 0.f);
    if (qi < Lq) {
      val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          qb + qi * sql + 2 * d2));
      val.x *= scale;
      val.y *= scale;
    }
    reinterpret_cast<float2*>(sQ + r * S::QS)[d2] = val;
  }

  float acc[4][CD];
  float m[4], l[4];
  int qidx[4], qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qidx[i] = q0 + ty + 16 * i;
    qseg[i] = (sg && qidx[i] < Lq) ? sg[qidx[i]] : 0;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int e = tid; e < BK * D / 2; e += THREADS) {
      const int r = e / (D / 2), d2 = e % (D / 2);
      const int ki = k0 + r;
      __nv_bfloat162 kv = __floats2bfloat162_rn(0.f, 0.f);
      __nv_bfloat162 vv = kv;
      if (ki < Lk) {
        kv = *reinterpret_cast<const __nv_bfloat162*>(kb + ki * skl + 2 * d2);
        vv = *reinterpret_cast<const __nv_bfloat162*>(vb + ki * svl + 2 * d2);
      }
      sK[r * S::KS2 + d2] = kv;
      reinterpret_cast<__nv_bfloat162*>(sV + r * D)[d2] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d2 = 0; d2 < D / 2; ++d2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = reinterpret_cast<const float2*>(sQ + (ty + 16 * i) * S::QS)[d2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(sK[(tx + 16 * j) * S::KS2 + d2]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kidx = k0 + tx + 16 * j;
      const bool in_range = kidx < Lk;
      const int kseg = (sg && in_range) ? sg[kidx] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = in_range && (!causal || kidx <= qidx[i]) &&
                        (!sg || kseg == qseg[i]);
        if (!ok) s[i][j] = -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : __expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * S::PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * S::PS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = __bfloat162float(sV[kk * D + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qidx[i] >= Lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = o + b * sob + qidx[i] * sol + h * soh;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = __float2bfloat16(acc[i][c] * inv);
    if (lse && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Lq + qidx[i]] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* seg, int B, int Lq, int Lk, int H,
                   int H_kv, const long long* st, long long segb, int causal,
                   float scale, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(seg), Lq, Lk, H / H_kv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], segb, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o.
// lse: null, or fp32 [B, H, Lq] contiguous.
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
