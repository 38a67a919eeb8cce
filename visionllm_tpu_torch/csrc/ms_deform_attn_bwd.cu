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
// The scatter of grad_value is what costs: up to Q H L P 4 = 4.35 M corner
// rows of 32 fp32 channels at the encoder (3.9 M inside the maps in the
// model's own train step), ~500 MB of adds into an fp32 [B, S, H, D]
// buffer that the 50 MB L2 holds. The L2 adds them at a rate set by the
// bytes, not by the instructions: 32-byte sectors at about the same rate
// for scalar and for vector reductions. The coarse levels concentrate
// them: at 640 px level 3 has 100 cells, each the target of ~1,360 corner
// adds per head at the encoder, from warps that run at the same time.
//
// Design: the forward's layout (msda_layout.cuh). One warp per (b, q, h)
// item, a thread owns 8 channels: it loads its 16-byte chunk of dOut once
// per item and each corner of its sample as one 16-byte load, and adds
// its 8 channels of a corner's grad_value with two vector fp32 reductions
// (sm_90's red.global.add.v4.f32). The weight and location gradients are
// summed over the threads of a sample group (2 shuffles each at D 32, in
// a fixed order) and written by the group's first thread, so they are
// bit-identical from run to run. Two launches:
// - calls of 2048 queries or more (the encoder) take msda_bwd_priv_kernel:
//   a block per (batch, head, tile of queries) sums the rows of the
//   coarsest levels that fit 72 KB (levels 2 and 3 at 640 px) in shared
//   memory, at a pitch of D + 1 floats so the 8 sample groups of a warp
//   hit different banks, and adds them to grad_value once per block; the
//   tiles are sized so that the blocks fill the card in one wave. Shared
//   fp32 atomicAdd is a compare-and-swap loop on sm_90, so privatising
//   more rows costs more than it saves;
// - smaller calls (the decoder) take msda_bwd_kernel, whose blocks run in
//   a golden-ratio order so that the warps in flight sample all over the
//   maps and fewer of them add into the same rows at once.
// A third kernel casts the fp32 grad_value to bf16, 8 channels a thread,
// after a memset of the fp32 buffer.
//
// Determinism: grad_value is summed by atomics, in an order that changes
// from run to run, so it is not bit-reproducible (two repeats differ in
// the last bit of a few dozen of its 2.2 M bf16 elements at the train
// encoder). A route without atomics would sort the ~4.35 M corner entries
// of a train encoder call by (head, cell) every call, gather the dOut rows
// per cell, and need a second pass for grad_loc and grad_attw: about the
// forward's gather traffic twice plus a sort, by that estimate no faster
// than the 0.357 ms of the scalar-atomics kernel it replaces, so it is not
// taken.

#include <algorithm>
#include <numeric>

#include "msda_layout.cuh"

namespace {

using namespace msda;

// sum of x over the cg threads of this lane's sample group, into the
// group's first thread (c == 0), in a fixed order
__device__ __forceinline__ float group_sum(float x, int c, int cg) {
  for (int off = ceil_pow2(cg) / 2; off >= 1; off /= 2) {
    const float o = __shfl_down_sync(0xffffffffu, x, off);
    if (c + off < cg) x += o;
  }
  return x;
}

// p[0..8) += x[0..8) by two vector fp32 reductions (16-byte aligned p)
__device__ __forceinline__ void red_add8(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < 8; i += 4)
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p + i), "f"(x[i]), "f"(x[i + 1]), "f"(x[i + 2]),
                    "f"(x[i + 3])
                 : "memory");
}

// The privatised launch: the bytes of shared memory a block may give the
// coarse levels' accumulator (levels 2 and 3 at 640 px: 500 rows of 33
// floats); the fewest queries for which it is taken (below, the scatter is
// spread over few adds a row and one warp per item fills the card
// better); the fewest queries of a block's tile (its flush is paid once a
// tile).
constexpr int PRIV_BYTES = 72 * 1024;
constexpr int PRIV_MIN_Q = 2048;
constexpr int PRIV_MIN_TILE = 64;

struct Args {
  const __nv_bfloat16* value;
  const float* loc;
  const float* attw;
  const __nv_bfloat16* gout;
  float* gvalue;
  float* gloc;
  float* gattw;
  int Q, S, H, D, L, P;
  long long n_items;
  int priv_start;   // first value row accumulated in shared memory (= S: none)
  long long stride; // block k of the one-warp-an-item launch takes the
                    // items of block k * stride mod n (golden ratio)
  int q_tile, tiles; // queries of a privatised block, and its tiles a head
};

// One item's gradients: grad_loc and grad_attw written, grad_value added
// into gvalue, or, for rows >= priv_start, into the block's shared
// accumulator `priv` (rows from priv_start, D floats each at a pitch of
// D + 1, so the 8 sample groups of a warp, adding channel k of 8 rows at
// once, fall on different banks).
template <int kD, int kL, int kP>
__device__ __forceinline__ void bwd_item(const Args& A, const LevelGeom* geom,
                                         const Lanes& ln, long long item,
                                         float* priv) {
  using K = Instance<kD, kL, kP>;
  const int D = kD ? kD : A.D, L = kL ? kL : A.L, P = kP ? kP : A.P;
  const int LP = L * P;
  const int rounds = (LP + ln.slots - 1) / ln.slots;
  const int h = static_cast<int>(item % A.H);
  const long long b = item / A.H / A.Q;
  const long long row = static_cast<long long>(A.H) * D;   // value row stride
  const long long head0 = (b * A.S * A.H + h) * D;         // (b, row 0, h)
  const float2* lp = reinterpret_cast<const float2*>(A.loc) + item * LP;
  const float* wp = A.attw + item * LP;

  for (int r0 = 0; r0 < rounds; r0 += K::kRB) {
    Sample sm[K::kRB];
    float ga[K::kRB], gx[K::kRB], gy[K::kRB];
#pragma unroll
    for (int j = 0; j < K::kRB; ++j) {
      const int s = (r0 + j) * ln.slots + ln.slot;
      sm[j] = sample_at(geom, lp, wp, s, ln.slot < ln.slots && s < LP, P);
      ga[j] = gx[j] = gy[j] = 0.f;
    }
    for (int c0 = 0; c0 < ln.chunks; c0 += 32) {
      const int c = c0 + ln.c;
      const bool active = ln.slot < ln.slots && c < ln.chunks;
      float g[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (active)
        unpack8(__ldg(reinterpret_cast<const uint4*>(A.gout + item * D) + c),
                g);
      const __nv_bfloat16* vb = A.value + head0 + c * 8;
      float* gvb = A.gvalue + head0 + c * 8;
      uint4 v[K::kRB][4];
#pragma unroll
      for (int j = 0; j < K::kRB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[j][q] = load_corner(vb, row, active ? sm[j].cell[q] : -1);
#pragma unroll
      for (int j = 0; j < K::kRB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cell = sm[j].cell[q];
          if (cell < 0 || !active) continue;
          float x[8], gv[8];
          unpack8(v[j][q], x);
          const float w = corner_weight(sm[j], q);
          const float aw = sm[j].a * w;
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            dot = fmaf(g[k], x[k], dot);
            gv[k] = aw * g[k];
          }
          if (cell >= A.priv_start) {
            float* pr = priv + (cell - A.priv_start) * (D + 1) + c * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) atomicAdd(pr + k, gv[k]);
          } else {
            red_add8(gvb + cell * row, gv);
          }
          const float wx = (q & 1) ? sm[j].fx : 1.f - sm[j].fx;
          const float wy = (q >> 1) ? sm[j].fy : 1.f - sm[j].fy;
          ga[j] = fmaf(w, dot, ga[j]);
          gx[j] = fmaf((q & 1) ? wy : -wy, dot, gx[j]);
          gy[j] = fmaf((q >> 1) ? wx : -wx, dot, gy[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < K::kRB; ++j) {
      const int s = (r0 + j) * ln.slots + ln.slot;
      const float a_ = group_sum(ga[j], ln.c, ln.cg);
      const float x_ = group_sum(gx[j], ln.c, ln.cg);
      const float y_ = group_sum(gy[j], ln.c, ln.cg);
      if (ln.c == 0 && ln.slot < ln.slots && s < LP) {
        A.gattw[item * LP + s] = a_;
        reinterpret_cast<float2*>(A.gloc)[item * LP + s] =
            make_float2(sm[j].a * sm[j].fw * x_, sm[j].a * sm[j].fh * y_);
      }
    }
  }
}

// One warp per item, every add straight to gvalue.
template <int kD, int kL, int kP>
__global__ void __launch_bounds__(32 * WARPS)
msda_bwd_kernel(Args A, Levels lv) {
  __shared__ LevelGeom geom[MAX_LEVELS];
  load_levels(geom, lv, kL ? kL : A.L);
  const long long blk = blockIdx.x * A.stride % gridDim.x;
  const long long item = blk * WARPS + threadIdx.y;
  if (item >= A.n_items) return;
  bwd_item<kD, kL, kP>(A, geom, lanes(kD ? kD : A.D), item, nullptr);
}

// A block per (batch, head, tile of q_tile queries): the rows of the
// coarse levels (from priv_start) are summed in shared memory, then added
// to gvalue once per block with vector reductions. Those levels hold few
// rows that take many adds each (at 640 px level 3 has 100 cells, each
// the target of ~1,360 corner adds per head and call at the encoder).
template <int kD, int kL, int kP>
__global__ void __launch_bounds__(32 * WARPS)
msda_bwd_priv_kernel(Args A, Levels lv) {
  extern __shared__ float priv[];
  __shared__ LevelGeom geom[MAX_LEVELS];
  const int D = kD ? kD : A.D;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int rows = A.S - A.priv_start;
  for (int i = tid; i < rows * (D + 1); i += 32 * WARPS) priv[i] = 0.f;
  load_levels(geom, lv, kL ? kL : A.L);       // also orders the zeroing
  const int h = blockIdx.x % A.H;
  const long long b = blockIdx.x / A.H / A.tiles;
  const int q0 = (blockIdx.x / A.H) % A.tiles * A.q_tile;
  const int q1 = min(q0 + A.q_tile, A.Q);
  const Lanes ln = lanes(D);
  for (int q = q0 + threadIdx.y; q < q1; q += WARPS)
    bwd_item<kD, kL, kP>(A, geom, ln, (b * A.Q + q) * A.H + h, priv);
  __syncthreads();
  const long long row = static_cast<long long>(A.H) * D;
  float* gv = A.gvalue + (b * A.S * A.H + h) * D +
              static_cast<long long>(A.priv_start) * row;
  for (int i = tid; i < rows * D / 4; i += 32 * WARPS) {
    const int r = 4 * i / D, col = 4 * i % D;
    const float* p = priv + r * (D + 1) + col;
    const float4 x = make_float4(p[0], p[1], p[2], p[3]);
    if (x.x == 0.f && x.y == 0.f && x.z == 0.f && x.w == 0.f) continue;
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(gv + r * row + col), "f"(x.x), "f"(x.y), "f"(x.z),
                    "f"(x.w)
                 : "memory");
  }
}

template <int kD, int kL, int kP>
cudaError_t launch_bwd(Args A, const Levels& lv, cudaStream_t s) {
  dim3 block(32, WARPS);
  if (A.priv_start >= A.S) {
    A.priv_start = A.S;
    const long long n = (A.n_items + WARPS - 1) / WARPS;
    // the warps in flight then sample all over the maps, not one band
    // of them, so fewer of them add into the same rows at once
    A.stride = std::max(1LL, static_cast<long long>(0.6180339887 * n));
    while (std::gcd(A.stride, n) != 1) ++A.stride;
    dim3 grid(static_cast<unsigned>(n));
    msda_bwd_kernel<kD, kL, kP><<<grid, block, 0, s>>>(A, lv);
    return cudaGetLastError();
  }
  const int smem = (A.S - A.priv_start) * (A.D + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      msda_bwd_priv_kernel<kD, kL, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // one wave: each (batch, head) gets an equal share of the blocks the
  // card holds at once, each block an equal share of the queries
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, msda_bwd_priv_kernel<kD, kL, kP>, 32 * WARPS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long bh = A.n_items / A.Q;
  const long long share = std::max(1LL, per_sm * sms / bh);
  A.q_tile = static_cast<int>(std::max<long long>(
      PRIV_MIN_TILE, (A.Q + share - 1) / share));
  A.tiles = (A.Q + A.q_tile - 1) / A.q_tile;
  dim3 grid(static_cast<unsigned>(bh * A.tiles));
  msda_bwd_priv_kernel<kD, kL, kP><<<grid, block, smem, s>>>(A, lv);
  return cudaGetLastError();
}

// fp32 -> bf16, 8 elements a thread (n a multiple of 8)
__global__ void cast_bf16_kernel(const float4* __restrict__ src,
                                 uint4* __restrict__ dst, long long n8) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 a = src[2 * i], b = src[2 * i + 1];
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    dst[i] = pack8(x);
  }
}

}  // namespace

// shapes: host array [L][2] of (height, width); value [B, S, H, D] bf16,
// loc [B, Q, H, L, P, 2] f32, attw [B, Q, H, L, P] f32, gout [B, Q, H * D]
// bf16, all contiguous and 16-byte aligned; D a multiple of 8. Writes
// gvalue_f32 (scratch [B, S, H, D]; zeroed here), gvalue [B, S, H, D]
// bf16, gloc and gattw (f32, shaped as loc and attw).
extern "C" int ms_deform_attn_bwd_bf16(const void* value, const void* loc,
                                       const void* attw, const void* gout,
                                       void* gvalue_f32, void* gvalue,
                                       void* gloc, void* gattw,
                                       const int* shapes, int B, int S, int Q,
                                       int H, int D, int L, int P,
                                       void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(lv, shapes, S, D, L, P))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_value = static_cast<long long>(B) * S * H * D;
  cudaError_t err = cudaMemsetAsync(gvalue_f32, 0, sizeof(float) * n_value, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_items = static_cast<long long>(B) * Q * H;
  if (n_items > 0) {
    Args A{static_cast<const __nv_bfloat16*>(value),
           static_cast<const float*>(loc),
           static_cast<const float*>(attw),
           static_cast<const __nv_bfloat16*>(gout),
           static_cast<float*>(gvalue_f32),
           static_cast<float*>(gloc),
           static_cast<float*>(gattw),
           Q, S, H, D, L, P, n_items, S, 1, 0, 0};
    // privatise the coarsest levels whose rows fit PRIV_BYTES, for calls
    // with queries enough to make a tile's shared sums worth their flush
    if (Q >= PRIV_MIN_Q)
      for (int l = 0; l < L; ++l)
        if (static_cast<long long>(S - lv.start[l]) * (D + 1) * 4 <=
            PRIV_BYTES) {
          A.priv_start = lv.start[l];
          break;
        }
    err = (D == 32 && L == 4 && P == 4) ? launch_bwd<32, 4, 4>(A, lv, s)
                                        : launch_bwd<0, 0, 0>(A, lv, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n8 = n_value / 8;
  if (n8 > 0) {
    const long long blocks = (n8 + 255) / 256;
    cast_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                       256, 0, s>>>(static_cast<const float4*>(gvalue_f32),
                                    static_cast<uint4*>(gvalue), n8);
  }
  return static_cast<int>(cudaGetLastError());
}
