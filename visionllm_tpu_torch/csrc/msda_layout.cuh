// Thread layout and sampling geometry shared by the MSDA forward
// (ms_deform_attn_fwd.cu) and backward (ms_deform_attn_bwd.cu) kernels.
//
// One warp per (b, q, h) item. A thread owns 8 channels of the head row,
// one 16-byte chunk of bf16: the D / 8 threads of a sample group (cg,
// capped at 32) cover the row, and the warp holds `slots` = the largest
// power of two <= 32 / cg sample groups at once (8 at D = 32), lane =
// slot * cg + chunk. Sample s of an item's L x P goes to group s % slots
// in round s / slots. A head row wider than 256 channels is walked in
// passes of 32 chunks.
//
// Geometry follows ms_deform_attn_reference: a location (lx, ly) of a
// level of extent (W, H) sits at pixel (lx W - 0.5, ly H - 0.5); a corner
// counts only if it lies inside the map, decided on the float
// coordinates before any int conversion, so far out-of-range or
// non-finite locations give no corner at all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace msda {

constexpr int MAX_LEVELS = 8;
constexpr int WARPS = 8;       // items (one a warp) per block

// level shapes and start rows, passed by value
struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// the same in shared memory, read per sample
struct LevelGeom {
  float fw, fh;
  int w, start;
};

__host__ __device__ constexpr int floor_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

__host__ __device__ constexpr int ceil_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The compile-time shape of an instance; 0 = given at run time. kRB is
// the rounds whose loads are issued together: all of them when the shape
// is known, else one.
template <int kD, int kL, int kP>
struct Instance {
  static constexpr int kCG = kD ? (kD / 8 < 32 ? kD / 8 : 32) : 0;
  static constexpr int kSlots = kCG ? floor_pow2(32 / kCG) : 0;
  static constexpr int kRB =
      (kD && kL && kP) ? (kL * kP + kSlots - 1) / kSlots : 1;
};

struct Lanes {
  int chunks;   // 16-byte chunks of a head row
  int cg;       // threads of a sample group (chunks of one pass)
  int slots;    // sample groups of a warp
  int slot;     // this lane's group (>= slots: idle lane)
  int c;        // this lane's chunk within the pass
};

__device__ __forceinline__ Lanes lanes(int D) {
  Lanes l;
  l.chunks = D / 8;
  l.cg = l.chunks < 32 ? l.chunks : 32;
  l.slots = floor_pow2(32 / l.cg);
  l.slot = threadIdx.x / l.cg;
  l.c = threadIdx.x % l.cg;
  return l;
}

__device__ __forceinline__ void load_levels(LevelGeom* g, const Levels& lv,
                                            int L) {
  const int t = threadIdx.y * 32 + threadIdx.x;
  if (t < L) {
    g[t].fw = static_cast<float>(lv.w[t]);
    g[t].fh = static_cast<float>(lv.h[t]);
    g[t].w = lv.w[t];
    g[t].start = lv.start[t];
  }
  __syncthreads();
}

// One sample's geometry: its attention weight, fractional position, level
// extent and the value row (cell) of each corner, -1 outside the map.
// Corner q is (dx, dy) = (q & 1, q >> 1).
struct Sample {
  float a, fx, fy, fw, fh;
  int cell[4];
};

__device__ __forceinline__ Sample sample_at(const LevelGeom* geom,
                                            const float2* lp,
                                            const float* wp, int s,
                                            bool live, int P) {
  Sample sm;
  sm.a = sm.fx = sm.fy = sm.fw = sm.fh = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) sm.cell[q] = -1;
  if (!live) return sm;
  const float2 xy = __ldg(lp + s);
  sm.a = __ldg(wp + s);
  const LevelGeom g = geom[s / P];
  // rounded as the plain version rounds it (product, then difference):
  // a contracted fma could move floor() at a cell edge, where grad_loc
  // jumps
  const float x = __fsub_rn(__fmul_rn(xy.x, g.fw), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, g.fh), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  sm.fx = x - x0;
  sm.fy = y - y0;
  sm.fw = g.fw;
  sm.fh = g.fh;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float xi = x0 + (q & 1), yi = y0 + (q >> 1);
    if (xi >= 0.f && xi <= g.fw - 1.f && yi >= 0.f && yi <= g.fh - 1.f)
      sm.cell[q] =
          g.start + static_cast<int>(yi) * g.w + static_cast<int>(xi);
  }
  return sm;
}

// bilinear weight of corner q, zero for a corner outside the map (also
// where the location was not finite)
__device__ __forceinline__ float corner_weight(const Sample& sm, int q) {
  const float wx = (q & 1) ? sm.fx : 1.f - sm.fx;
  const float wy = (q >> 1) ? sm.fy : 1.f - sm.fy;
  return sm.cell[q] >= 0 ? wx * wy : 0.f;
}

// the 8 channels of corner q of this lane's chunk (zero outside the map);
// vb points at (batch, row 0, head, chunk), `row` is the row stride H D
__device__ __forceinline__ uint4 load_corner(const __nv_bfloat16* vb,
                                             long long row, int cell) {
  if (cell < 0) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(vb + cell * row));
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Level table from the host's [L][2] (height, width); false if the shape
// is one the kernels do not take.
inline bool make_levels(Levels& lv, const int* shapes, int S, int D, int L,
                        int P) {
  if (L <= 0 || L > MAX_LEVELS || P <= 0 || D <= 0 || D % 8) return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return start == S;
}

}  // namespace msda
