// The two gather probes of the MSDA kernel study, for Hopper (sm_90a).
//
// Replaces: tools/msda_kernel_attempts.py
//  * attempt_a_dynamic_gather: a lane gather inside one block,
//    out[r, e] = v[r, idx[r, e]] (jnp.take_along_axis(v, idx, axis=1)),
//    f32 v [R, E], int32 idx [R, E]. Mosaic's in-register dynamic_gather
//    takes E <= 128 only, as it keeps the whole row on one core.
//  * attempt_b_dma_gather: a row gather, out[i] = table[idx[i]], bf16
//    table [S, W], int32 idx [n], RPB rows per grid step (the TPU kernel
//    issued one DMA per row). Here a block takes RPB rows and moves each
//    row as 16-byte vector loads and stores (a 256-byte row = 16 lanes).
// An index outside the row (lane gather) or the table (row gather) reads
// zeros.
//
// Bound on an H100: both move bytes and compute nothing. The row gather
// reads n W 2 bytes of rows, n 4 bytes of indices and writes n W 2 bytes
// (n 131072, W 128: 67 MB, 20 us at 3.35 TB/s; the 4 MB table itself
// stays in L2); the random accesses are whole 16-byte vectors of a row.
//
// The lane gather moves 12 R E bytes (v and idx read, out written once:
// 5.5 MB, 1.6 us at [8, 57344]), so at the probe's sizes it is bound by
// the launch, its barriers and the reads between SMs more than by bytes.
// One block per row put a row's 12 E bytes through one SM (8 of 132 SMs
// busy at R = 8). Here a thread-block cluster of C CTAs takes a row: CTA
// k stages the slice [k chunk, (k + 1) chunk) of v in its own shared
// memory, one thread per 4 floats with one 16-byte load of v and one of
// idx in flight together; the cluster syncs; each thread makes 4
// independent reads through distributed shared memory, from whichever CTA
// holds each index, and one 16-byte store. So a row's traffic is spread
// over C SMs. C depends on E alone (`lane_cluster`): 1 up to LANE_ONE_CTA
// floats (launched without a cluster, read from the CTA's own shared
// memory), then one CTA per LANE_ONE_CTA floats up to 16, the
// non-portable maximum: 128 CTAs at [8, 57344]. A second, split barrier
// (arrive before the store, wait after it) keeps every slice alive until
// its neighbours have read it. Random indices send 15 of 16 reads to
// another SM, one 4-byte request each; those requests, not bytes, take
// most of the time at E = 57344 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int LANE_ONE_CTA = 1024;   // floats a CTA of a lane cluster takes
constexpr int LANE_MAX_CLUSTER = 16;
constexpr int LANE_MAX_THREADS = 1024;

// CTAs per row, from E alone, and the floats of a slice (a multiple of 4,
// so that every slice starts 16-byte aligned in an aligned row). A slice
// has at most 4 LANE_MAX_THREADS floats for E <= 16 * 4096.
int lane_cluster(int E) {
  const int c = (E + LANE_ONE_CTA - 1) / LANE_ONE_CTA;
  return c < LANE_MAX_CLUSTER ? c : LANE_MAX_CLUSTER;
}

int lane_chunk(int E, int C) { return ((E + C - 1) / C + 3) / 4 * 4; }

// grid: R * C CTAs, in clusters of C along x when C > 1: CTA k =
// blockIdx.x % C (its rank in the cluster) of row blockIdx.x / C; one
// thread for each 4 floats of a slice, thread t owning [4 t, 4 t + 4).
// `vec`: v, idx and out are 16-byte aligned and E % 4 == 0, so each
// thread's 4 floats move as one 16-byte access.
template <bool kCluster>
__global__ void __launch_bounds__(LANE_MAX_THREADS)
lane_gather_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                   float* __restrict__ out, int E, int chunk, int C,
                   bool vec) {
  extern __shared__ __align__(16) float slice[];
  const int k = static_cast<int>(blockIdx.x) % C;
  const int lo = k * chunk;
  const int n = max(0, min(chunk, E - lo));   // the last slice is ragged
  const long long at = static_cast<long long>(blockIdx.x / C) * E + lo;
  const int e0 = 4 * static_cast<int>(threadIdx.x);

  // this thread's 4 values and 4 indices, both loads in flight at once
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  int j[4] = {-1, -1, -1, -1};
  if (vec && e0 < n) {
    const float4 x4 = __ldcs(reinterpret_cast<const float4*>(v + at + e0));
    const int4 j4 = __ldcs(reinterpret_cast<const int4*>(idx + at + e0));
    x[0] = x4.x; x[1] = x4.y; x[2] = x4.z; x[3] = x4.w;
    j[0] = j4.x; j[1] = j4.y; j[2] = j4.z; j[3] = j4.w;
  } else if (!vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e0 + q < n) {
        x[q] = __ldcs(v + at + e0 + q);
        j[q] = __ldcs(idx + at + e0 + q);
      }
  }
  if (e0 < n) {
    if (vec) {
      *reinterpret_cast<float4*>(slice + e0) = make_float4(x[0], x[1], x[2],
                                                           x[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e0 + q < n) slice[e0 + q] = x[q];
    }
  }
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();

  // 4 independent reads, each from the CTA whose slice holds the index
  float r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int jq = j[q];
    r[q] = 0.f;
    if (jq >= 0 && jq < E) {
      if constexpr (kCluster)
        r[q] = *cg::this_cluster().map_shared_rank(slice + jq % chunk,
                                                   jq / chunk);
      else
        r[q] = slice[jq];
    }
  }
  // this thread's reads are done once their values are in registers: it
  // arrives before its store and waits after it, so that no slice goes
  // away while a neighbour still reads it
  if constexpr (kCluster) cg::this_cluster().barrier_arrive();
  if (vec && e0 < n) {
    __stcs(reinterpret_cast<float4*>(out + at + e0),
           make_float4(r[0], r[1], r[2], r[3]));
  } else if (!vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e0 + q < n) out[at + e0 + q] = r[q];
  }
  if constexpr (kCluster) cg::this_cluster().barrier_wait();
}

// vec = 16-byte vectors per row (W * 2 / 16)
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                  uint4* __restrict__ out, int S, int vec, long long n,
                  int rpb) {
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long rows = n - r0 < rpb ? n - r0 : rpb;
  for (long long w = threadIdx.x; w < rows * vec; w += THREADS) {
    const long long r = r0 + w / vec;
    const int c = static_cast<int>(w % vec);
    const int j = idx[r];
    out[r * vec + c] = (j >= 0 && j < S)
                           ? table[static_cast<long long>(j) * vec + c]
                           : make_uint4(0u, 0u, 0u, 0u);
  }
}

cudaLaunchConfig_t lane_config(int R, int E, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  const int C = lane_cluster(E);
  const int chunk = lane_chunk(E, C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * C);
  cfg.blockDim = dim3((chunk / 4 + 31) / 32 * 32);
  cfg.dynamicSmemBytes = sizeof(float) * chunk;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;     // one CTA a row launches no cluster
  return cfg;
}

// The clusters of this launch's shape that fit on the card at once; 0
// means the launch cannot run. A slice stays under the 48 KB a block
// gets without opting in (14.2 KB at E = 58112), so only the cluster
// size needs an attribute.
cudaError_t lane_active_clusters(const cudaLaunchConfig_t& cfg, int* n) {
  if (cfg.numAttrs == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, lane_gather_kernel<false>, static_cast<int>(cfg.blockDim.x),
        cfg.dynamicSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      lane_gather_kernel<true>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, lane_gather_kernel<true>, &cfg);
  return err;
}

// per cluster size, the largest slice (bytes) already found to fit
size_t lane_checked[LANE_MAX_CLUSTER + 1];

}  // namespace

// The launch shape of a lane gather of extent E: CTAs per row, floats per
// slice, and the clusters of that shape that fit on the card at once (for
// one CTA a row, the CTAs that fit on one SM).
extern "C" int lane_gather_plan(int E, int* cluster, int* chunk,
                                int* active) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = lane_config(1, E, nullptr, &attr);
  *cluster = lane_cluster(E);
  *chunk = lane_chunk(E, *cluster);
  return static_cast<int>(lane_active_clusters(cfg, active));
}

// v, out: f32 [R, E]; idx: int32 [R, E]; all contiguous.
extern "C" int lane_gather_f32(const void* v, const void* idx, void* out,
                               int R, int E, void* stream) {
  if (R <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  const int C = lane_cluster(E);
  const int chunk = lane_chunk(E, C);
  if (chunk > 4 * LANE_MAX_THREADS ||
      static_cast<long long>(R) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      lane_config(R, E, static_cast<cudaStream_t>(stream), &attr);
  if (cfg.dynamicSmemBytes > lane_checked[C]) {   // once per shape class
    int active = 0;
    cudaError_t err = lane_active_clusters(cfg, &active);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active == 0) return static_cast<int>(cudaErrorInvalidClusterSize);
    lane_checked[C] = cfg.dynamicSmemBytes;
  }
  const bool vec = E % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, C > 1 ? lane_gather_kernel<true> : lane_gather_kernel<false>,
      static_cast<const float*>(v), static_cast<const int*>(idx),
      static_cast<float*>(out), E, chunk, C, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// table: bf16 [S, W] with W a multiple of 8 and 16-byte aligned rows;
// idx: int32 [n]; out: bf16 [n, W]; all contiguous.
extern "C" int row_gather_bf16(const void* table, const void* idx, void* out,
                               int S, int W, long long n, int rpb,
                               void* stream) {
  if (W % 8 != 0 || rpb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + rpb - 1) / rpb;
  row_gather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(idx),
      static_cast<uint4*>(out), S, W / 8, n, rpb);
  return static_cast<int>(cudaGetLastError());
}
