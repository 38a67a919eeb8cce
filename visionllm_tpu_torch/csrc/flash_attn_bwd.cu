// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV from dO, O and
// the forward's row logsumexp. bf16 in and out, fp32 arithmetic.
//
// Replaces: the backward half of the Pallas TPU flash attention that
// visionllm_tpu/ops/attention.py:multi_head_attention reaches under
// jax.grad, _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// (jax/experimental/pallas/ops/tpu/flash_attention.py).
//
// Semantics are the forward kernel's (flash_attn_fwd.cu): S = scale Q K^T
// masked by start-aligned causality (key <= query), segment ids and the
// ragged edges, P = exp(S - LSE) with LSE the forward's row logsumexp.
// With Di = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Di),
//   dQ = scale dS K,  dK = scale dS^T Q.
// GQA is native: kv head hk serves query heads hk*group .. hk*group+group-1
// and its dK / dV sum over them, so no K / V repeat is materialized.
//
// Bound on an H100: at the LLaMA-7B prefill (B 1, L 586, 32 heads x 128,
// causal) a call reads q, k, v, o, dO and writes dq, dk, dv, 8 x 4.8 MB
// (11.5 us at 3.35 TB/s), and needs five [L, L] x D products over the
// causal half, 7 GFLOP (7.1 us on the bf16 tensor cores): bytes bound it,
// the tensor-core rate close behind. This first version runs its products
// as scalar fp32 FMAs from shared memory, so FMA issue bounds it instead;
// mma / wgmma tiles are later work.
//
// Design (three kernels, no atomics, so the result is deterministic):
//  1. preprocess: one warp per (b, query, head) row writes Di.
//  2. dK/dV: one block per (b, kv head, 64-key tile) keeps its dK and dV
//     tiles in registers and loops over the query tiles (from the key
//     tile's own under causality) and the query heads of its GQA group,
//     recomputing P and dS tile by tile.
//  3. dQ: one block per (b, head, 64-query tile) loops over the key tiles
//     (up to the diagonal under causality), recomputing P and dS.
// Thread (ty, tx) of a 16 x 16 grid owns the score entries (ty + 16 i,
// tx + 16 j) and the output entries (ty + 16 i, tx + 16 c), as in the
// forward; tiles sit in shared memory as bf16 pairs with an odd row
// stride, so the row reads of a warp fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 64;         // query and key tile
constexpr int THREADS = 256;

template <int D>
struct Tile {
  static constexpr int S2 = D / 2 + 1;    // bf16 pairs per row (odd)
  static constexpr int PS = BT + 1;       // floats per score row
  static constexpr size_t pairs = BT * S2;
};

// Stage rows [r0, r0 + 64) of one head of a [B, L, H*, D] tensor (rows
// `row_stride` elements apart) as bf16 pairs; rows past n_rows are zero.
template <int D>
__device__ void stage(__nv_bfloat162* dst, const __nv_bfloat16* src,
                      long long row_stride, int r0, int n_rows) {
  for (int e = threadIdx.x; e < BT * D / 2; e += THREADS) {
    const int r = e / (D / 2), d2 = e % (D / 2);
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const __nv_bfloat162*>(
          src + (r0 + r) * row_stride + 2 * d2);
    dst[r * Tile<D>::S2 + d2] = val;
  }
}

__device__ __forceinline__ float pair_elem(const __nv_bfloat162* t, int S2,
                                           int r, int d) {
  return __bfloat162float(
      reinterpret_cast<const __nv_bfloat16*>(t + r * S2)[d]);
}

// P and dS of one 64 x 64 tile: s = q.k and dp = dO.v over the staged
// tiles, then masks, P = exp(scale s - LSE), dS = P (dp - Di), both
// stored [query][key] in shared memory.
template <int D>
__device__ void p_and_ds(const __nv_bfloat162* sQ, const __nv_bfloat162* sdO,
                         const __nv_bfloat162* sK, const __nv_bfloat162* sV,
                         const float* sL, const float* sDi, float* sP,
                         float* sdS, int q0, int k0, int Lq, int Lk,
                         int causal, const int* sg, float scale) {
  constexpr int S2 = Tile<D>::S2;
  constexpr int PS = Tile<D>::PS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d2 = 0; d2 < D / 2; ++d2) {
    float2 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = __bfloat1622float2(sQ[(ty + 16 * i) * S2 + d2]);
      ov[i] = __bfloat1622float2(sdO[(ty + 16 * i) * S2 + d2]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = __bfloat1622float2(sK[(tx + 16 * j) * S2 + d2]);
      vv[j] = __bfloat1622float2(sV[(tx + 16 * j) * S2 + d2]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
        dp[i][j] = fmaf(ov[i].x, vv[j].x, fmaf(ov[i].y, vv[j].y, dp[i][j]));
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    const float lse = sL[r], di = sDi[r];
    const int qseg = (sg && qi < Lq) ? sg[qi] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, ki = k0 + c;
      const bool ok = qi < Lq && ki < Lk && (!causal || ki <= qi) &&
                      (!sg || sg[ki] == qseg) && lse != -INFINITY;
      const float p = ok ? __expf(s[i][j] * scale - lse) : 0.f;
      sP[r * PS + c] = p;
      sdS[r * PS + c] = p * (dp[i][j] - di);
    }
  }
}

// Di = rowsum(dO * O): one warp per (b, query, head); out [B, H, Lq].
__global__ void flash_bwd_pre_kernel(const __nv_bfloat16* __restrict__ o,
                                     const __nv_bfloat16* __restrict__ dout,
                                     float* __restrict__ di, int Lq, int H,
                                     int D, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.y;
  if (row >= rows) return;                 // row = (b * Lq + q) * H + h
  float acc = 0.f;
  for (int d = threadIdx.x; d < D; d += 32)
    acc = fmaf(__bfloat162float(o[row * D + d]),
               __bfloat162float(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x == 0) {
    const long long h = row % H, bq = row / H;
    const long long b = bq / Lq, qi = bq % Lq;
    di[(b * H + h) * Lq + qi] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di,
                     const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H,
                     int H_kv, int causal, float scale) {
  using T = Tile<D>;
  constexpr int CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat162* sK = reinterpret_cast<__nv_bfloat162*>(smem_raw);
  __nv_bfloat162* sV = sK + T::pairs;
  __nv_bfloat162* sQ = sV + T::pairs;
  __nv_bfloat162* sdO = sQ + T::pairs;
  float* sP = reinterpret_cast<float*>(sdO + T::pairs);
  float* sdS = sP + BT * T::PS;
  float* sL = sdS + BT * T::PS;
  float* sDi = sL + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / H_kv;
  const long long qrow = static_cast<long long>(H) * D;
  const long long krow = static_cast<long long>(H_kv) * D;
  const int* sg = seg ? seg + static_cast<long long>(b) * Lq : nullptr;

  stage<D>(sK, k + b * Lk * krow + hk * D, krow, k0, Lk);
  stage<D>(sV, v + b * Lk * krow + hk * D, krow, k0, Lk);

  float acc_k[4][CD], acc_v[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int t_first = causal ? k0 / BT : 0;
  const int n_qt = (Lq + BT - 1) / BT;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Lq;
    const float* di_h = di + (static_cast<long long>(b) * H + h) * Lq;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * BT;
      __syncthreads();              // the previous tile's reads are done
      stage<D>(sQ, q + b * Lq * qrow + h * D, qrow, q0, Lq);
      stage<D>(sdO, dout + b * Lq * qrow + h * D, qrow, q0, Lq);
      for (int r = threadIdx.x; r < BT; r += THREADS) {
        sL[r] = q0 + r < Lq ? lse_h[q0 + r] : -INFINITY;
        sDi[r] = q0 + r < Lq ? di_h[q0 + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<D>(sQ, sdO, sK, sV, sL, sDi, sP, sdS, q0, k0, Lq, Lk, causal,
                  sg, scale);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pk[4], sk[4], ov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = sP[r * T::PS + ty + 16 * i];
          sk[i] = sdS[r * T::PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = pair_elem(sdO, T::S2, r, tx + 16 * c);
          qv[c] = pair_elem(sQ, T::S2, r, tx + 16 * c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            acc_v[i][c] = fmaf(pk[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(sk[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= Lk) continue;
    const long long base = (static_cast<long long>(b) * Lk + ki) * krow + hk * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[base + tx + 16 * c] = __float2bfloat16(acc_k[i][c] * scale);
      dv[base + tx + 16 * c] = __float2bfloat16(acc_v[i][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di,
                    const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int H,
                    int H_kv, int causal, float scale) {
  using T = Tile<D>;
  constexpr int CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat162* sQ = reinterpret_cast<__nv_bfloat162*>(smem_raw);
  __nv_bfloat162* sdO = sQ + T::pairs;
  __nv_bfloat162* sK = sdO + T::pairs;
  __nv_bfloat162* sV = sK + T::pairs;
  float* sdS = reinterpret_cast<float*>(sV + T::pairs);
  float* sP = sdS + BT * T::PS;
  float* sL = sP + BT * T::PS;
  float* sDi = sL + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / H_kv);
  const long long qrow = static_cast<long long>(H) * D;
  const long long krow = static_cast<long long>(H_kv) * D;
  const int* sg = seg ? seg + static_cast<long long>(b) * Lq : nullptr;
  const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Lq;
  const float* di_h = di + (static_cast<long long>(b) * H + h) * Lq;

  stage<D>(sQ, q + b * Lq * qrow + h * D, qrow, q0, Lq);
  stage<D>(sdO, dout + b * Lq * qrow + h * D, qrow, q0, Lq);
  for (int r = threadIdx.x; r < BT; r += THREADS) {
    sL[r] = q0 + r < Lq ? lse_h[q0 + r] : -INFINITY;
    sDi[r] = q0 + r < Lq ? di_h[q0 + r] : 0.f;
  }

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Lk, q0 + BT) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();                // the previous tile's reads are done
    stage<D>(sK, k + b * Lk * krow + hk * D, krow, k0, Lk);
    stage<D>(sV, v + b * Lk * krow + hk * D, krow, k0, Lk);
    __syncthreads();
    p_and_ds<D>(sQ, sdO, sK, sV, sL, sDi, sP, sdS, q0, k0, Lq, Lk, causal,
                sg, scale);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float sq[4], kv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) sq[i] = sdS[(ty + 16 * i) * T::PS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = pair_elem(sK, T::S2, kk, tx + 16 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(sq[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const long long base = (static_cast<long long>(b) * Lq + qi) * qrow + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dq[base + tx + 16 * c] = __float2bfloat16(acc[i][c] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   const void* seg, void* di, void* dq, void* dk, void* dv,
                   int B, int Lq, int Lk, int H, int H_kv, int causal,
                   float scale, cudaStream_t stream) {
  using T = Tile<D>;
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* di_ = static_cast<float*>(di);

  const long long rows = static_cast<long long>(B) * Lq * H;
  flash_bwd_pre_kernel<<<static_cast<unsigned>((rows + 7) / 8), dim3(32, 8),
                         0, stream>>>(static_cast<const __nv_bfloat16*>(o),
                                      do_, di_, Lq, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t bytes = sizeof(__nv_bfloat162) * 4 * T::pairs +
                       sizeof(float) * (2 * BT * T::PS + 2 * BT);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;

  flash_bwd_dkv_kernel<D><<<dim3((Lk + BT - 1) / BT, H_kv, B), THREADS, bytes,
                            stream>>>(
      q_, k_, v_, do_, lse_, di_, seg_, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Lq, Lk, H, H_kv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3((Lq + BT - 1) / BT, H, B), THREADS, bytes,
                           stream>>>(
      q_, k_, v_, do_, lse_, di_, seg_, static_cast<__nv_bfloat16*>(dq), Lq,
      Lk, H, H_kv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [B, Lq, H, D]; k, v, dk, dv: [B, Lk, H_kv, D], all bf16
// and contiguous; lse (from the forward) and di (scratch): fp32
// [B, H, Lq]; seg: null or int32 [B, Lq] (Lq == Lk).
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, const void* seg, void* di,
                                   void* dq, void* dk, void* dv, int B, int Lq,
                                   int Lk, int H, int H_kv, int D, int causal,
                                   float scale, void* stream) {
  if (H_kv <= 0 || H % H_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Lq <= 0 || Lk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64>(q, k, v, o, dout, lse, seg, di, dq, dk, dv, B, Lq, Lk, H,
                     H_kv, causal, scale, s);
  else if (D == 128)
    err = launch<128>(q, k, v, o, dout, lse, seg, di, dq, dk, dv, B, Lq, Lk,
                      H, H_kv, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
