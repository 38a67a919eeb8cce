// The two gather probes of the MSDA kernel study, for Hopper (sm_90a).
//
// Replaces: tools/msda_kernel_attempts.py
//  * attempt_a_dynamic_gather: a lane gather inside one block,
//    out[r, e] = v[r, idx[r, e]] (jnp.take_along_axis(v, idx, axis=1)),
//    f32 v [R, E], int32 idx [R, E]. Mosaic's in-register dynamic_gather
//    takes E <= 128 only. Here each row is staged in shared memory and
//    gathered from there, so any E whose row fits a block's shared memory
//    (227 KB: E <= 58112 f32) runs.
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
// stays in L2); the lane gather reads v and idx and writes out once.
// Its design keeps every global access coalesced: the rows go through
// shared memory, and the random accesses stay in shared memory (lane
// gather) or are whole 16-byte vectors of a row (row gather).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                   float* __restrict__ out, int E) {
  extern __shared__ float row[];
  const long long base = static_cast<long long>(blockIdx.x) * E;
  for (int e = threadIdx.x; e < E; e += THREADS) row[e] = v[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const int j = idx[base + e];
    out[base + e] = (j >= 0 && j < E) ? row[j] : 0.f;
  }
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

}  // namespace

// v, out: f32 [R, E]; idx: int32 [R, E]; all contiguous.
extern "C" int lane_gather_f32(const void* v, const void* idx, void* out,
                               int R, int E, void* stream) {
  if (R <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = sizeof(float) * static_cast<size_t>(E);
  cudaError_t err = cudaFuncSetAttribute(
      lane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_gather_kernel<<<R, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(idx),
      static_cast<float*>(out), E);
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
