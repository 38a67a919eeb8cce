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
// shapes (S = 5440, H = 8, D = 32, L = 4, P = 4) the unique bytes (value,
// loc, attw, out, each once) are 14 MB, 4.2 us at 3.35 TB/s; the gathered
// bytes are 4 corners x L x P rows of 64 bytes per (b, q, h), ~178 MB,
// and they come from L1 and L2 (the 2.8 MB value table sits in the 50 MB
// L2). So load latency and instruction issue set the pace, not bytes.
//
// Design (msda_layout.cuh): one warp per (b, q, h) item. A thread owns 8
// channels and reads a corner as one 16-byte load; the D / 8 threads of
// a sample group cover a head row, and the warp holds 32 / (D / 8) sample
// groups (8 at D = 32), so the L x P samples of an item take a few rounds
// (2 at L = P = 4). A thread loads its sample's location and weight
// itself (the group's threads read the same addresses, so a warp's loads
// are one 64-byte and one 32-byte transaction a round), computes that sample's geometry once, and in the specialised instance
// issues every corner load of every round before the first FMA: two
// memory latencies per item. Validity is decided on the float coordinates
// before any int conversion, so far out-of-range or non-finite locations
// contribute zero. The per-group partial sums are added across the groups
// by shuffles in a fixed order (the output is bit-identical from run to
// run), rounded to bf16 once, and each thread of group 0 writes one
// 16-byte chunk.
//
// A block holds 8 items in (b, q, h) order: one query's 8 heads at H 8,
// whose samples fall near one another (blocks of 8 queries of one head
// measured slower on an H100 at the encoders, no faster at the decoders).
//
// Instances: <D 32, L 4, P 4> (Grounding-DINO's encoder and decoder),
// compiled with every loop bound constant; <0, 0, 0> takes any D that is
// a multiple of 8, L <= 8 and any P at run time, one round at a time.

#include "msda_layout.cuh"

namespace {

using namespace msda;

template <int kD, int kL, int kP>
__global__ void __launch_bounds__(32 * WARPS)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,
                const float* __restrict__ loc,
                const float* __restrict__ attw,
                __nv_bfloat16* __restrict__ out, Levels lv, int Q, int S,
                int H, int D_, int L_, int P_, long long n_items) {
  using K = Instance<kD, kL, kP>;
  const int D = kD ? kD : D_, L = kL ? kL : L_, P = kP ? kP : P_;
  __shared__ LevelGeom geom[MAX_LEVELS];
  load_levels(geom, lv, L);
  const long long item =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.y;
  if (item >= n_items) return;
  const Lanes ln = lanes(D);
  const int LP = L * P;
  const int rounds = (LP + ln.slots - 1) / ln.slots;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;   // value row stride
  const float2* lp = reinterpret_cast<const float2*>(loc) + item * LP;
  const float* wp = attw + item * LP;

  for (int c0 = 0; c0 < ln.chunks; c0 += 32) {
    const int c = c0 + ln.c;
    const bool active = ln.slot < ln.slots && c < ln.chunks;
    const __nv_bfloat16* vb = value + (b * S * H + h) * D + c * 8;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int r0 = 0; r0 < rounds; r0 += K::kRB) {
      // every location, then every corner load of the rounds, then FMAs
      Sample sm[K::kRB];
      uint4 v[K::kRB][4];
#pragma unroll
      for (int j = 0; j < K::kRB; ++j) {
        const int s = (r0 + j) * ln.slots + ln.slot;
        sm[j] = sample_at(geom, lp, wp, s, ln.slot < ln.slots && s < LP, P);
      }
#pragma unroll
      for (int j = 0; j < K::kRB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[j][q] = load_corner(vb, row, active ? sm[j].cell[q] : -1);
#pragma unroll
      for (int j = 0; j < K::kRB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x[8];
          unpack8(v[j][q], x);
          const float w = sm[j].a * corner_weight(sm[j], q);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(w, x[k], acc[k]);
        }
    }
    // the other groups into group 0, halving the span: a fixed order
    for (int off = ln.slots / 2; off >= 1; off /= 2)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off * ln.cg);
    if (ln.slot == 0 && c < ln.chunks)
      *reinterpret_cast<uint4*>(out + item * D + c * 8) = pack8(acc);
  }
}

}  // namespace

// shapes: host array [L][2] of (height, width); value [B, S, H, D] bf16,
// loc [B, Q, H, L, P, 2] f32, attw [B, Q, H, L, P] f32, out [B, Q, H * D]
// bf16, all contiguous and 16-byte aligned; D a multiple of 8.
extern "C" int ms_deform_attn_fwd_bf16(const void* value, const void* loc,
                                       const void* attw, void* out,
                                       const int* shapes, int B, int S, int Q,
                                       int H, int D, int L, int P,
                                       void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(lv, shapes, S, D, L, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_items = static_cast<long long>(B) * Q * H;
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  dim3 block(32, msda::WARPS);
  dim3 grid(static_cast<unsigned>((n_items + msda::WARPS - 1) / msda::WARPS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const __nv_bfloat16*>(value);
  const auto* l = static_cast<const float*>(loc);
  const auto* a = static_cast<const float*>(attw);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (D == 32 && L == 4 && P == 4)
    msda_fwd_kernel<32, 4, 4><<<grid, block, 0, s>>>(v, l, a, o, lv, Q, S, H,
                                                     D, L, P, n_items);
  else
    msda_fwd_kernel<0, 0, 0><<<grid, block, 0, s>>>(v, l, a, o, lv, Q, S, H,
                                                    D, L, P, n_items);
  return static_cast<int>(cudaGetLastError());
}
