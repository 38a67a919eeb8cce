// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces: visionllm_tpu/ops/ms_deform_attn.py:_msda_kernel (via
// ms_deform_attn_pallas), the Pallas TPU formulation of the op whose
// semantics are ms_deform_attn_reference: for each (b, query, head), the
// sum over levels x points of attw times a bilinear sample of that
// level's value map at pixel (t * extent - 0.5), with out-of-bounds
// corners contributing zero (grid_sample bilinear, zero padding,
// align_corners=False). Locations and weights are fp32; the sum is fp32.
//
// Bound on an H100: the op is a data-dependent gather. At the 512 px det
// shapes (S = 5440, H = 8, D = 32, L = 4, P = 4) the bf16 value table is
// 2.8 MB per image, far inside the 50 MB L2, so the 4 x L x P gathers of
// 64-byte rows per (b, q, h) hit L2: the kernel is bound by gather and
// instruction issue, not by device-memory bytes (the unique bytes are
// value + loc + attw + out, read or written once).
//
// Design: one warp per (b, q, h), lane = channel of the head dim, so the
// four corner reads of a sample are 64-byte coalesced row reads across
// the warp. Every lane computes the (same) corner geometry from the fp32
// location, so loc / attw reads are warp-wide broadcasts. Validity is
// decided on the float coordinates before any int conversion, so far
// out-of-range or non-finite locations contribute zero. Level shapes and
// start offsets are passed by value as small int arrays.

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

__global__ void __launch_bounds__(32 * WARPS)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,
                const float* __restrict__ loc,
                const float* __restrict__ attw,
                __nv_bfloat16* __restrict__ out, Levels lv, int Q, int S,
                int H, int D, int L, int P, long long n_items) {
  const int lane = threadIdx.x;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.y;
  if (item >= n_items) return;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;  // value row stride
  const __nv_bfloat16* vb = value + b * S * row + h * D;
  const float* lp = loc + item * L * P * 2;
  const float* wp = attw + item * L * P;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l], Wl = lv.w[l];
      const float fH = static_cast<float>(Hl), fW = static_cast<float>(Wl);
      const __nv_bfloat16* vl = vb + lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const float x = lp[(l * P + p) * 2] * fW - 0.5f;
        const float y = lp[(l * P + p) * 2 + 1] * fH - 0.5f;
        const float a = wp[l * P + p];
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = x - x0, fy = y - y0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dx = c & 1, dy = c >> 1;
          const float xi = x0 + dx, yi = y0 + dy;
          const bool valid = xi >= 0.f && xi <= fW - 1.f && yi >= 0.f &&
                             yi <= fH - 1.f;
          if (valid && active) {
            const float wgt = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy);
            const long long idx = static_cast<long long>(yi) * Wl +
                                  static_cast<long long>(xi);
            acc = fmaf(a * wgt, __bfloat162float(vl[idx * row + d]), acc);
          }
        }
      }
    }
    if (active) out[item * D + d] = __float2bfloat16(acc);
  }
}

}  // namespace

// shapes: host array [L][2] of (height, width); value [B, S, H, D] bf16,
// loc [B, Q, H, L, P, 2] f32, attw [B, Q, H, L, P] f32, out [B, Q, H * D]
// bf16, all contiguous.
extern "C" int ms_deform_attn_fwd_bf16(const void* value, const void* loc,
                                       const void* attw, void* out,
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
  const long long n_items = static_cast<long long>(B) * Q * H;
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  dim3 block(32, WARPS);
  dim3 grid(static_cast<unsigned>((n_items + WARPS - 1) / WARPS));
  msda_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<__nv_bfloat16*>(out), lv, Q,
      S, H, D, L, P, n_items);
  return static_cast<int>(cudaGetLastError());
}
