// Multi-scale deformable attention backward for Hopper (sm_90a): the
// gradients of value, sampling locations and attention weights.
//
// Replaces: the gradient JAX takes by autodiff through the gathers of
// visionllm_tpu/ops/ms_deform_attn.py (ms_deform_attn_reference, and
// ms_deform_attn_quad on the TPU, whose takes become scatter-adds): the
// forward Pallas kernel _msda_kernel has no backward of its own.
//
// Convention: the gradient of ms_deform_attn_reference. A sample at
// location (lx, ly) of a level of extent (W, H) sits at pixel
// x = lx W - 0.5, y = ly H - 0.5; with x0 = floor(x), fx = x - x0 (and
// the same in y) its four corners carry the bilinear weights
// (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy, and a corner outside the map
// contributes nothing, value or gradient. floor has no gradient, so
//   grad_value[corner]  += attw * w_corner * dOut
//   grad_attw           = sum_d dOut[d] * sample[d]
//   grad_lx = W attw sum_d dOut[d] sum_corner (d w_corner / d fx) v[d]
// and grad_ly likewise with H and fy. Validity is decided exactly as in
// the forward kernel, on the float coordinates, so out-of-range or
// non-finite locations give zero gradients.
//
// Bound on an H100: at the 640 px det shapes (S = 8500, H 8, D 32, L 4,
// P 4; encoder Q = S) a call reads dOut, value, loc, attw and writes
// grad_value, grad_loc, grad_attw once, ~25 MB (7.5 us at 3.35 TB/s).
// The kernel instead issues one fp32 atomicAdd per valid corner and
// channel, up to Q H L P 4 D = 140 M at the encoder, into an fp32
// [B, S, H, D] buffer that the 50 MB L2 holds: atomic throughput bounds
// it. A layout without atomics (sorting samples by source cell) is later
// work.
//
// Design: the forward's layout. One warp per (b, q, h), lane = channel, so
// corner reads and atomic adds are 64..128-byte coalesced rows; the
// per-sample geometry is computed by every lane from warp-broadcast loads;
// the attention-weight and location gradients are warp-shuffle sums over
// the channels. A second kernel casts the fp32 value gradient to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int WARPS = 8;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(32 * WARPS)
msda_bwd_kernel(const __nv_bfloat16* __restrict__ value,
                const float* __restrict__ loc,
                const float* __restrict__ attw,
                const __nv_bfloat16* __restrict__ gout,
                float* __restrict__ gvalue, float* __restrict__ gloc,
                float* __restrict__ gattw, Levels lv, int Q, int S, int H,
                int D, int L, int P, long long n_items) {
  const int lane = threadIdx.x;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.y;
  if (item >= n_items) return;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;  // value row stride
  const long long vbase = b * S * row + h * D;
  const float* lp = loc + item * L * P * 2;
  const float* wp = attw + item * L * P;
  float* glp = gloc + item * L * P * 2;
  float* gwp = gattw + item * L * P;
  const __nv_bfloat16* gp = gout + item * D;

  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const float fH = static_cast<float>(Hl), fW = static_cast<float>(Wl);
    const long long lbase = vbase + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float x = lp[(l * P + p) * 2] * fW - 0.5f;
      const float y = lp[(l * P + p) * 2 + 1] * fH - 0.5f;
      const float a = wp[l * P + p];
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      float g_a = 0.f, g_x = 0.f, g_y = 0.f;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        if (d >= D) break;
        const float g = __bfloat162float(gp[d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dx = c & 1, dy = c >> 1;
          const float xi = x0 + dx, yi = y0 + dy;
          const bool valid = xi >= 0.f && xi <= fW - 1.f && yi >= 0.f &&
                             yi <= fH - 1.f;
          if (!valid) continue;
          const float wx = dx ? fx : 1.f - fx, wy = dy ? fy : 1.f - fy;
          const long long idx = lbase +
              (static_cast<long long>(yi) * Wl + static_cast<long long>(xi)) * row + d;
          const float val = __bfloat162float(value[idx]);
          atomicAdd(gvalue + idx, a * wx * wy * g);
          const float gv = g * val;
          g_a = fmaf(wx * wy, gv, g_a);
          g_x = fmaf(dx ? wy : -wy, gv, g_x);
          g_y = fmaf(dy ? wx : -wx, gv, g_y);
        }
      }
      g_a = warp_sum(g_a);
      g_x = warp_sum(g_x);
      g_y = warp_sum(g_y);
      if (lane == 0) {
        gwp[l * P + p] = g_a;
        glp[(l * P + p) * 2] = a * g_x * fW;
        glp[(l * P + p) * 2 + 1] = a * g_y * fH;
      }
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst,
                                 long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

}  // namespace

// shapes: host array [L][2] of (height, width); value [B, S, H, D] bf16,
// loc [B, Q, H, L, P, 2] f32, attw [B, Q, H, L, P] f32, gout [B, Q, H * D]
// bf16, all contiguous. Writes gvalue_f32 (scratch [B, S, H, D]; zeroed
// here), gvalue [B, S, H, D] bf16, gloc and gattw (f32, shaped as loc and
// attw).
extern "C" int ms_deform_attn_bwd_bf16(const void* value, const void* loc,
                                       const void* attw, const void* gout,
                                       void* gvalue_f32, void* gvalue,
                                       void* gloc, void* gattw,
                                       const int* shapes, int B, int S, int Q,
                                       int H, int D, int L, int P,
                                       void* stream) {
  if (L <= 0 || L > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_value = static_cast<long long>(B) * S * H * D;
  cudaError_t err = cudaMemsetAsync(gvalue_f32, 0, sizeof(float) * n_value, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_items = static_cast<long long>(B) * Q * H;
  if (n_items > 0) {
    dim3 block(32, WARPS);
    dim3 grid(static_cast<unsigned>((n_items + WARPS - 1) / WARPS));
    msda_bwd_kernel<<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attw), static_cast<const __nv_bfloat16*>(gout),
        static_cast<float*>(gvalue_f32), static_cast<float*>(gloc),
        static_cast<float*>(gattw), lv, Q, S, H, D, L, P, n_items);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_value > 0) {
    const long long blocks = (n_value + 255) / 256;
    cast_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                       0, s>>>(static_cast<const float*>(gvalue_f32),
                               static_cast<__nv_bfloat16*>(gvalue), n_value);
  }
  return static_cast<int>(cudaGetLastError());
}
