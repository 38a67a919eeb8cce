// w4a16 group-wise int4 matrix product for Hopper (sm_90a) on the tensor
// cores, bf16 in/out, fp32 sums.
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
// most 16 products, so the bytes of wp (0.5 byte per weight) set the
// least time: 7.0 us for 4096x11008 at 3.35 TB/s. At prefill (M 2560) the
// products do: 231 GFLOP for 4096x11008, 0.233 ms on the bf16 tensor
// cores at 989 TFLOP/s. So the products have to run on the tensor cores,
// and at decode the weights have to stream with many bytes in flight.
//
// Design (one kernel, one launch a call, no split-K):
//  - A block owns a BM x BN output tile and walks all K/(2G) low groups
//    itself. Step g takes the packed chunk wp[gG:(g+1)G, n0:n0+BN], which
//    holds the low group g and the high group g + K/(2G), with the two x
//    tiles x[m0:m0+BM, gG:(g+1)G] and x[m0:m0+BM, K/2+gG:K/2+(g+1)G] and
//    the two scale rows.
//  - Those arrive by 16-byte cp.async into a ring of STAGES stages: past
//    the barrier that opens step g, step g+STAGES-1 is issued into the
//    stage that step g-1 used. Rows of x past M are never copied (their
//    fragments read a zero chunk); columns past N are zero-filled
//    (src-size 0). Where N % 16 != 0 or wp or scale is not 16-byte
//    aligned (tiny test widths only; every LLaMA width is a multiple of
//    16), weights and scales are staged by guarded plain loads into the
//    same layout. A group shorter than 128 rows is padded with zeros.
//  - Dequant, shared memory to shared memory: each thread turns 16 packed
//    bytes into 16 low and 16 high bf16 values (exact: -8..7) with
//    byte_perm, one lop3 to the bf16 bits of 128 + (nibble ^ 8), and one
//    bf16 subtraction of 136, into two swizzled [128, BN] bf16 tiles; then
//    a barrier.
//  - Products: mma.sync m16n8k16 bf16 with fp32 sums. x is the A operand
//    by ldmatrix (as flash reads Q); the dequantized W is the B operand by
//    ldmatrix.trans (as flash reads V). Each MMA warp owns a WM x WN
//    sub-tile: for the low group, 8 k-steps of 16 into a zeroed partial,
//    then acc = fma(partial, s_lo, acc); then the high group the same way.
//    A warp with few fragments runs the two partials' k-steps side by side
//    (two chains for the tensor cores), still scaling the low one first.
//  - Shared memory is XOR-swizzled in 16-byte chunks (swz), so 8
//    consecutive rows at one chunk hit 8 bank groups for ldmatrix, the
//    dequant's reads and its writes.
//  - Tiles. Decode and short prompts (M <= 64): 16 rows, BN 16, 32 or 64
//    with n8 or n16 warp tiles and 4 warps (the warps without products
//    copy and dequantize), a 4-stage ring; the host takes the narrowest
//    BN whose grid needs the fewest waves of blocks. Prefill (M > 64):
//    128 x 128, 8 warps of 32 x 64, a 2-stage ring.
//  - Shared memory a block: 2 * 128 BN * 2 bytes of dequantized tiles
//    plus STAGES * (2 * BM * 128 * 2 + 128 BN + 4 BN) of ring: 48 KB,
//    64.5 KB and 97 KB for the 16-row tiles, 225 KB for the prefill tile
//    (one block an SM); all within the 227 KB a block may have.
//
// Batch invariance, by construction: for every tile shape, out[m, n] is
// computed by the same sequence of operations: groups in ascending order;
// per group, the low group's k-steps in order from a zero partial, one
// fmaf by the low scale, then the high group's k-steps from a zero
// partial and one fmaf by the high scale; one bf16 rounding at the end.
// A tensor-core product of row m reads only row m of x. BM, BN, the warp
// layout and the ring depth decide which rows and columns a warp owns,
// never the order, so a row is bit-identical whether M is 1, 4 or 2560.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GMAX = 128;   // largest group; tiles are sized for it

// ---- fragment helpers (as in flash_attn_fwd.cu) ----

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

// the two 8x8 matrices at the row addresses of lanes 0-15, transposed
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// 16-byte chunk index of (row, chunk c) in a swizzled tile of CH chunks a
// row: flash's XOR of c with (row & 7), generalised to rows narrower than
// 128 bytes (XOR with the row's place among the 8 / CH rows of a line)
template <int CH>
__device__ __forceinline__ int swz(int row, int c) {
  constexpr int R = CH >= 8 ? 1 : 8 / CH;
  constexpr int MASK = (CH >= 8 ? 8 : CH) - 1;
  return row * CH + (c ^ ((row / R) & MASK));
}

// two 16-bit lanes holding a signed nibble in bits 0-3 (the rest of the
// lane ignored) -> bf16x2 of the nibbles' values: the lanes become the
// bf16 bits of 128 + (nibble ^ 8) = 136 + value, then 136 is taken off
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t t) {
  uint32_t b = (t & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t off = 0x43084308u;   // bf16x2 (136, 136)
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A block tile of BM x BN outputs; MMA warps of WM x WN each; WARPS
// warps in all, those past the MMA warps only copying and dequantizing; a
// ring of STAGES; KU k-steps unrolled.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int WARPS_, int KU_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, KU = KU_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int MMA_WARPS = (BM / WM) * WARPS_N;
  static constexpr int THREADS = 32 * WARPS_;
  static constexpr int MT = WM / 16;   // m16 tiles a warp
  static constexpr int NT = WN / 8;    // n8 tiles a warp
  // a warp with few fragments computes the low and the high partial side
  // by side (two independent chains for the tensor cores)
  static constexpr int NH = MT * NT <= 4 ? 2 : 1;
  // shared memory, in this order: dequantized W [2][GMAX][BN] bf16, x
  // [STAGES][2][BM][GMAX] bf16, packed W [STAGES][GMAX][BN] int8, scales
  // [STAGES][2][BN] bf16, one zero chunk of 16 bytes
  static constexpr int WD = 2 * GMAX * BN;   // bf16 elements
  static constexpr int XS = 2 * BM * GMAX;   // a stage, bf16 elements
  static constexpr int WQ = GMAX * BN;       // a stage, bytes
  static constexpr int SC = 2 * BN;          // a stage, bf16 elements
  static constexpr size_t SMEM = 2 * WD + STAGES * (2 * XS + WQ + 2 * SC) + 16;
  static_assert(BM % WM == 0 && BN % WN == 0 && WARPS_ >= MMA_WARPS,
                "warp layout");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BN % 16 == 0, "fragments");
  static_assert((2 * BM * GMAX / 8) % THREADS == 0 &&
                (GMAX * BN / 16) % THREADS == 0, "whole copy rounds");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
  static_assert((GMAX / 16) % KU == 0, "whole unrolled rounds");
};

// 16 packed bytes (16 columns of one row) -> 16 low and 16 high bf16
// values, written as chunks 2c and 2c + 1 of row r of the two tiles
template <int WCH>
__device__ __forceinline__ void dequant16(const uint4 p, __nv_bfloat16* wd_lo,
                                          __nv_bfloat16* wd_hi, int r, int c) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bytes 0, 1 and 2, 3 of the word into the low byte of 16-bit lanes
    const uint32_t t01 = __byte_perm(w[i], 0, 0x4140);
    const uint32_t t23 = __byte_perm(w[i], 0, 0x4342);
    lo[2 * i] = nibbles_to_bf16x2(t01);
    lo[2 * i + 1] = nibbles_to_bf16x2(t23);
    hi[2 * i] = nibbles_to_bf16x2(t01 >> 4);
    hi[2 * i + 1] = nibbles_to_bf16x2(t23 >> 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int off = swz<WCH>(r, 2 * c + k) * 8;
    *reinterpret_cast<uint4*>(wd_lo + off) =
        make_uint4(lo[4 * k], lo[4 * k + 1], lo[4 * k + 2], lo[4 * k + 3]);
    *reinterpret_cast<uint4*>(wd_hi + off) =
        make_uint4(hi[4 * k], hi[4 * k + 1], hi[4 * k + 2], hi[4 * k + 3]);
  }
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                const int8_t* __restrict__ wp,
                const __nv_bfloat16* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS, MT = C::MT, NT = C::NT, NH = C::NH;
  constexpr int XCH = GMAX / 8;   // 16-byte chunks of an x row
  constexpr int WCH = BN / 8;     // ... of a dequantized W row
  constexpr int PCH = BN / 16;    // ... of a packed W row
  constexpr int KS = GMAX / 16;   // k-steps a group (zeros past G)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* wd = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = wd + C::WD;
  int8_t* wq = reinterpret_cast<int8_t*>(xs + STAGES * C::XS);
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(wq + STAGES * C::WQ);
  uint4* zero = reinterpret_cast<uint4*>(sc + STAGES * C::SC);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bool mma_warp = warp < C::MMA_WARPS;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
  const int half = K / 2;
  const int ngh = half / G;       // low groups; group g + ngh is g's twin
  const int mv = min(BM, M - m0); // rows of x this block holds
  const int xch = G / 8;          // chunks of one group's x row
  if (tid == 0) *zero = make_uint4(0, 0, 0, 0);

  auto load_step = [&](int g, int st) {
    const int r0 = g * G;
    __nv_bfloat16* xst = xs + st * C::XS;
    // x row by row (both halves of a row in one round), up to row mv
#pragma unroll
    for (int i = 0; i < 2 * BM * XCH / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int c = e % XCH, h = (e / XCH) % 2, r = e / (2 * XCH);
      if ((i * THREADS) / (2 * XCH) >= mv) break;   // the round's first row
      if (r < mv)
        cp_async16(xst + h * BM * GMAX + swz<XCH>(r, c) * 8,
                   c < xch ? x + (m0 + r) * ldx + h * half + r0 + c * 8 : x,
                   c < xch);
    }
    int8_t* wst = wq + st * C::WQ;
    __nv_bfloat16* sst = sc + st * C::SC;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < GMAX * PCH / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int c = e % PCH, r = e / PCH;
        const bool ok = r < G && n0 + c * 16 < N;
        cp_async16(wst + swz<PCH>(r, c) * 16,
                   ok ? wp + static_cast<long long>(r0 + r) * N + n0 + c * 16
                      : wp,
                   ok);
      }
      for (int e = tid; e < 2 * WCH; e += THREADS) {
        const int c = e % WCH, h = e / WCH;
        const bool ok = n0 + c * 8 < N;
        cp_async16(sst + h * BN + c * 8,
                   ok ? scale + static_cast<long long>(g + h * ngh) * N +
                            n0 + c * 8
                      : scale,
                   ok);
      }
    } else {
      for (int e = tid; e < GMAX * BN; e += THREADS) {
        const int c = e % BN, r = e / BN;
        const int8_t v = r < G && n0 + c < N
                             ? wp[static_cast<long long>(r0 + r) * N + n0 + c]
                             : 0;
        wst[swz<PCH>(r, c / 16) * 16 + c % 16] = v;
      }
      for (int e = tid; e < 2 * BN; e += THREADS) {
        const int c = e % BN, h = e / BN;
        sst[h * BN + c] =
            n0 + c < N ? scale[static_cast<long long>(g + h * ngh) * N + n0 + c]
                       : __float2bfloat16_rn(0.f);
      }
    }
  };

  // prologue: steps 0 .. STAGES-2, one commit group each
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ngh) load_step(s, s);
    cp_async_commit();
  }

  // per m16 tile, this lane's ldmatrix row of x, or -1 past M
  int arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm0 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    arow[i] = r < mv ? r : -1;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  int stage = 0, next = STAGES - 1;   // stage of step g, of g+STAGES-1
  for (int g = 0; g < ngh; ++g) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of step g landed
    // every thread's copies of step g are visible, and every warp is done
    // with step g-1: its stage and the dequantized tiles are free
    __syncthreads();
    if (g + STAGES - 1 < ngh) load_step(g + STAGES - 1, next);
    cp_async_commit();

    // dequant: consecutive threads take consecutive rows of one chunk
    const int8_t* wst = wq + stage * C::WQ;
#pragma unroll
    for (int it = 0; it < GMAX * PCH / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e % GMAX, c = e / GMAX;
      dequant16<WCH>(*reinterpret_cast<const uint4*>(wst + swz<PCH>(r, c) * 16),
                     wd, wd + GMAX * BN, r, c);
    }
    __syncthreads();

    if (mma_warp) {
      const __nv_bfloat16* xst = xs + stage * C::XS;
      const __nv_bfloat16* sst = sc + stage * C::SC;
#pragma unroll
      for (int h0 = 0; h0 < 2; h0 += NH) {
        float part[NH][MT][NT][4];
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              part[hh][i][j][0] = part[hh][i][j][1] = part[hh][i][j][2] =
                  part[hh][i][j][3] = 0.f;
#pragma unroll 1
        for (int k0 = 0; k0 < KS; k0 += C::KU) {
#pragma unroll
          for (int ks = k0; ks < k0 + C::KU; ++ks) {
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              const __nv_bfloat16* xa = xst + (h0 + hh) * BM * GMAX;
              const __nv_bfloat16* wb = wd + (h0 + hh) * GMAX * BN;
              uint32_t af[MT][4];
#pragma unroll
              for (int i = 0; i < MT; ++i)
                ldsm_x4(af[i],
                        arow[i] < 0
                            ? static_cast<const void*>(zero)
                            : xa + swz<XCH>(arow[i], 2 * ks + (lane >> 4)) * 8);
              const int brow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
              for (int jp = 0; jp < NT / 2; ++jp) {
                uint32_t bf[4];
                ldsm_x4_trans(bf, wb + swz<WCH>(brow, wn0 / 8 + 2 * jp +
                                                          (lane >> 4)) * 8);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                  mma_bf16(part[hh][i][2 * jp], af[i], bf[0], bf[1]);
                  mma_bf16(part[hh][i][2 * jp + 1], af[i], bf[2], bf[3]);
                }
              }
              if constexpr (NT % 2) {   // an n8 tile of its own
                uint32_t bf[2];
                ldsm_x2_trans(bf, wb + swz<WCH>(brow, wn0 / 8 + NT - 1) * 8);
#pragma unroll
                for (int i = 0; i < MT; ++i)
                  mma_bf16(part[hh][i][NT - 1], af[i], bf[0], bf[1]);
              }
            }
          }
        }
        // one fma by the group's scale per output, the low group first:
        // columns 2 t4 and 2 t4 + 1 of each n8 tile
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int cl = (h0 + hh) * BN + wn0 + j * 8 + 2 * t4;
            const float s0 = __bfloat162float(sst[cl]);
            const float s1 = __bfloat162float(sst[cl + 1]);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              acc[i][j][0] = __fmaf_rn(part[hh][i][j][0], s0, acc[i][j][0]);
              acc[i][j][1] = __fmaf_rn(part[hh][i][j][1], s1, acc[i][j][1]);
              acc[i][j][2] = __fmaf_rn(part[hh][i][j][2], s0, acc[i][j][2]);
              acc[i][j][3] = __fmaf_rn(part[hh][i][j][3], s1, acc[i][j][3]);
            }
          }
        }
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    next = next + 1 == STAGES ? 0 : next + 1;
  }
  cp_async_wait<0>();   // no copy outlives the block (the tail's are empty)
  if (!mma_warp) return;

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + wm0 + i * 16 + g8 + 8 * e;
      if (row >= M) continue;
      __nv_bfloat16* orow = out + static_cast<long long>(row) * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn0 + j * 8 + 2 * t4;
        if constexpr (VEC) {   // N % 16 == 0: the pair is in or out
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
        } else {
          if (col < N) orow[col] = __float2bfloat16_rn(acc[i][j][2 * e]);
          if (col + 1 < N)
            orow[col + 1] = __float2bfloat16_rn(acc[i][j][2 * e + 1]);
        }
      }
    }
  }
}

// once per device and tile: raise the dynamic shared memory limit and
// ask how many blocks an SM holds
template <class C, bool VEC>
cudaError_t prepare(int* per_sm) {
  constexpr int MAX_DEVICES = 64;
  static int known[MAX_DEVICES] = {};   // blocks an SM, 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && known[dev]) {
    *per_sm = known[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(int4_mma_kernel<C, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, int4_mma_kernel<C, VEC>, C::THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) known[dev] = *per_sm;
  return cudaSuccess;
}

template <class C, bool VEC>
cudaError_t launch(const void* x, long long ldx, const void* wp,
                   const void* scale, void* out, int M, int K, int N, int G,
                   cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = prepare<C, VEC>(&per_sm);
  if (err != cudaSuccess) return err;
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int4_mma_kernel<C, VEC><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const int8_t*>(wp), static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N, G);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_any(bool vec, const void* x, long long ldx, const void* wp,
                       const void* scale, void* out, int M, int K, int N,
                       int G, cudaStream_t stream) {
  return vec ? launch<C, true>(x, ldx, wp, scale, out, M, K, N, G, stream)
             : launch<C, false>(x, ldx, wp, scale, out, M, K, N, G, stream);
}

// waves of blocks the grid of tile C takes on `sms` SMs
template <class C>
cudaError_t waves(bool vec, int M, int N, int sms, long long* w) {
  int per_sm = 0;
  cudaError_t err =
      vec ? prepare<C, true>(&per_sm) : prepare<C, false>(&per_sm);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((N + C::BN - 1) / C::BN) *
                           ((M + C::BM - 1) / C::BM);
  const long long slots = static_cast<long long>(per_sm) * sms;
  *w = (blocks + slots - 1) / slots;
  return cudaSuccess;
}

// among tiles A, B, D (narrowest first): the narrowest whose grid takes
// the fewest waves (each block walks all of K, so more blocks means
// shorter chains a block)
template <class A, class B, class D>
cudaError_t launch_narrowest(bool vec, const void* x, long long ldx,
                             const void* wp, const void* scale, void* out,
                             int M, int K, int N, int G, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long wa = 0, wb = 0, wd = 0;
  if (err == cudaSuccess) err = waves<A>(vec, M, N, sms, &wa);
  if (err == cudaSuccess) err = waves<B>(vec, M, N, sms, &wb);
  if (err == cudaSuccess) err = waves<D>(vec, M, N, sms, &wd);
  if (err != cudaSuccess) return err;
  if (wa <= wb && wa <= wd)
    return launch_any<A>(vec, x, ldx, wp, scale, out, M, K, N, G, st);
  if (wb <= wd)
    return launch_any<B>(vec, x, ldx, wp, scale, out, M, K, N, G, st);
  return launch_any<D>(vec, x, ldx, wp, scale, out, M, K, N, G, st);
}

// tiles: (BM, BN, WM, WN, STAGES, WARPS, KU)
using Decode16 = Cfg<16, 16, 16, 8, 4, 4, 8>;
using Decode32 = Cfg<16, 32, 16, 8, 4, 4, 8>;
using Decode64 = Cfg<16, 64, 16, 16, 4, 4, 8>;
using Prefill = Cfg<128, 128, 32, 64, 2, 8, 2>;

}  // namespace

// x bf16 [M, K] with row stride ldx (a multiple of 8, unit column stride,
// 16-byte aligned); wp int8 [K/2, N], scale bf16 [K/G, N], out bf16
// [M, N], all contiguous. Needs G a multiple of 16 up to 128 and
// K % (2G) == 0. The tile is chosen from M, N and the card; the result
// is not.
extern "C" int int4_matmul_bf16(const void* x, long long ldx, const void* wp,
                                const void* scale, void* out, int M, int K,
                                int N, int G, void* stream) {
  if (G < 16 || G > GMAX || G % 16 != 0 || K % (2 * G) != 0 || M < 0 ||
      N < 0 || ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (M <= 64)
    return static_cast<int>(launch_narrowest<Decode16, Decode32, Decode64>(
        vec, x, ldx, wp, scale, out, M, K, N, G, st));
  return static_cast<int>(
      launch_any<Prefill>(vec, x, ldx, wp, scale, out, M, K, N, G, st));
}
