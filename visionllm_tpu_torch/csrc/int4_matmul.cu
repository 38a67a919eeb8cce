// w4a16 group-wise int4 matrix product for Hopper (sm_90a).
//
// Replaces: visionllm_tpu/ops/quant4.py:_int4_kernel (via int4_matmul),
// the Pallas TPU kernel whose spec is int4_matmul_ref:
//   out[M, N] = x[M, K] @ dequant(wp, scale)
// wp int8 [K/2, N] packs two signed nibbles per byte, split-half: the low
// nibble of wp[r, n] is weight row r, the high nibble row r + K/2. scale
// bf16 [K/G, N] holds one scale per (G-row group, column). Per group the
// products are summed in fp32 and the complete group sum is multiplied by
// its scale once (never per weight).
//
// Bound on an H100: at decode (M <= 8) every packed byte is used for at
// most 16 products, so the kernel is bound by the bytes of wp (0.5 byte
// per weight); at prefill (M in the thousands) by operations. This is a
// simple fp32 FMA kernel (no tensor cores), so large M runs far below the
// card's bf16 tensor rate; mma/wgmma is a later redesign.
//
// Design:
// - Each thread owns VEC consecutive columns (VEC = 4: one 32-bit load of
//   4 packed bytes per row, 128 coalesced bytes per warp; VEC = 1 for a
//   width or base not aligned to 4) and TM rows of x.
// - One block covers 128 * VEC columns, TM rows and one slice of the
//   low groups (split-K). Each packed byte is read once: its low nibble
//   multiplies x[:, r] into the partial of group g, its high nibble
//   x[:, r + K/2] into the partial of group g + K/(2G).
// - x for the block's rows and the current group is staged in shared
//   memory as fp32 ([2][G][TM], read as broadcasts).
// - Each slice writes fp32 partial sums [slice, M, N]; a second kernel
//   adds the slices in order and rounds to bf16.
// - Batch invariance: the order of operations for out[m, n] depends on
//   K, N and G only (the slice count is chosen from K and N), never on M
//   or on which row tile holds row m, and every step is an explicit
//   __fmaf_rn / __fadd_rn. Row m of a call is bit-identical to the same
//   row computed alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int GMAX = 128;

template <int VEC>
__device__ __forceinline__ uint32_t load_packed(const int8_t* p) {
  if constexpr (VEC == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return static_cast<uint32_t>(static_cast<uint8_t>(*p));
  }
}

template <int TM, int VEC>
__global__ void __launch_bounds__(THREADS)
int4_partial_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                    const int8_t* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ scale,
                    float* __restrict__ part, int M, int K, int N, int G,
                    int n_slices) {
  __shared__ __align__(16) float xs[2][GMAX][TM];
  const int half = K / 2;
  const int ngh = half / G;  // low groups; group g + ngh is its high twin
  const int s = blockIdx.y;
  const int g_begin = static_cast<int>(static_cast<long long>(s) * ngh / n_slices);
  const int g_end = static_cast<int>(static_cast<long long>(s + 1) * ngh / n_slices);
  const int m0 = blockIdx.z * TM;
  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  const bool col_ok = n0 < N;  // VEC = 4 only when N % 4 == 0

  float acc[TM][VEC];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    const int r0 = g * G;
    __syncthreads();  // the previous group's readers are done with xs
    for (int i = threadIdx.x; i < 2 * G * TM; i += THREADS) {
      const int h = i / (G * TM);
      const int rem = i - h * G * TM;
      const int m = rem / G;
      const int r = rem - m * G;  // neighbouring threads read neighbouring x
      float v = 0.f;
      if (m0 + m < M)
        v = __bfloat162float(x[static_cast<long long>(m0 + m) * ldx +
                               h * half + r0 + r]);
      xs[h][r][m] = v;
    }
    __syncthreads();
    if (!col_ok) continue;

    float plo[TM][VEC], phi[TM][VEC];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) plo[m][c] = phi[m][c] = 0.f;

    const int8_t* wrow = wp + static_cast<long long>(r0) * N + n0;
#pragma unroll 4
    for (int r = 0; r < G; ++r) {
      const uint32_t w = load_packed<VEC>(wrow + static_cast<long long>(r) * N);
      float lo[VEC], hi[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        // signed nibbles by two arithmetic shifts: (int8)(b << 4) >> 4
        // and (int8)b >> 4 for byte c of the word
        lo[c] = static_cast<float>(static_cast<int>(w << (28 - 8 * c)) >> 28);
        hi[c] = static_cast<float>(static_cast<int>(w << (24 - 8 * c)) >> 28);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float xl = xs[0][r][m];
        const float xh = xs[1][r][m];
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          plo[m][c] = __fmaf_rn(lo[c], xl, plo[m][c]);
          phi[m][c] = __fmaf_rn(hi[c], xh, phi[m][c]);
        }
      }
    }
    float slo[VEC], shi[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      slo[c] = __bfloat162float(scale[static_cast<long long>(g) * N + n0 + c]);
      shi[c] = __bfloat162float(scale[static_cast<long long>(g + ngh) * N + n0 + c]);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        acc[m][c] = __fmaf_rn(phi[m][c], shi[c],
                              __fmaf_rn(plo[m][c], slo[c], acc[m][c]));
  }
  if (!col_ok) return;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    if (m0 + m >= M) break;
    float* dst = part + (static_cast<long long>(s) * M + m0 + m) * N + n0;
#pragma unroll
    for (int c = 0; c < VEC; ++c) dst[c] = acc[m][c];
  }
}

__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   __nv_bfloat16* __restrict__ out,
                                   long long MN, int n_slices) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < n_slices; ++s) v = __fadd_rn(v, part[s * MN + i]);
    out[i] = __float2bfloat16_rn(v);
  }
}

template <int TM, int VEC>
void launch_partial(const __nv_bfloat16* x, long long ldx, const int8_t* wp,
                    const __nv_bfloat16* scale, float* part, int M, int K,
                    int N, int G, int n_slices, cudaStream_t stream) {
  dim3 grid((N + THREADS * VEC - 1) / (THREADS * VEC), n_slices,
            (M + TM - 1) / TM);
  int4_partial_kernel<TM, VEC><<<grid, THREADS, 0, stream>>>(
      x, ldx, wp, scale, part, M, K, N, G, n_slices);
}

template <int VEC>
void launch_tm(int tm, const __nv_bfloat16* x, long long ldx, const int8_t* wp,
               const __nv_bfloat16* scale, float* part, int M, int K, int N,
               int G, int n_slices, cudaStream_t stream) {
  switch (tm) {
    case 1: launch_partial<1, VEC>(x, ldx, wp, scale, part, M, K, N, G, n_slices, stream); break;
    case 2: launch_partial<2, VEC>(x, ldx, wp, scale, part, M, K, N, G, n_slices, stream); break;
    case 4: launch_partial<4, VEC>(x, ldx, wp, scale, part, M, K, N, G, n_slices, stream); break;
    default: launch_partial<8, VEC>(x, ldx, wp, scale, part, M, K, N, G, n_slices, stream); break;
  }
}

}  // namespace

// x bf16 [M, K] with row stride ldx (unit column stride); wp int8
// [K/2, N], scale bf16 [K/G, N], out bf16 [M, N], all contiguous; part
// fp32 scratch [n_slices, M, N]. Needs K % (2G) == 0, 1 <= G <= 128 and
// 1 <= n_slices <= K / (2G).
extern "C" int int4_matmul_bf16(const void* x, long long ldx, const void* wp,
                                const void* scale, void* part, void* out,
                                int M, int K, int N, int G, int n_slices,
                                void* stream) {
  if (G < 1 || G > GMAX || K % (2 * G) != 0 || n_slices < 1 ||
      n_slices > K / (2 * G) || M < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tm = M >= 8 ? 8 : (M >= 4 ? 4 : (M >= 2 ? 2 : 1));
  const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 4 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const int8_t*>(wp);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  auto* pb = static_cast<float*>(part);
  if (vec4)
    launch_tm<4>(tm, xb, ldx, wb, sb, pb, M, K, N, G, n_slices, st);
  else
    launch_tm<1>(tm, xb, ldx, wb, sb, pb, M, K, N, G, n_slices, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long blocks = (MN + 255) / 256;
  int4_reduce_kernel<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536),
                       256, 0, st>>>(pb, static_cast<__nv_bfloat16*>(out), MN,
                                     n_slices);
  return static_cast<int>(cudaGetLastError());
}
