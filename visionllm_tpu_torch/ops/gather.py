"""The two gather probes of the MSDA kernel study (counterparts of the
Pallas kernels in `tools/msda_kernel_attempts.py`), through the
hand-written CUDA kernels of `csrc/gather_probes.cu`:

* `lane_gather(v, idx)`: `out[r, e] = v[r, idx[r, e]]` (the JAX
  `take_along_axis(v, idx, axis=1)` of `attempt_a_dynamic_gather`), f32
  `v` [R, E], int32 `idx` [R, E]; each row is spread over the shared
  memory of a thread-block cluster of up to 16 CTAs and gathered through
  distributed shared memory (`lane_gather_plan` gives the cluster size),
  for E up to `MAX_LANE_EXTENT`.
* `row_gather(table, idx, rows_per_block)`: `out[i] = table[idx[i]]` (the
  `jnp.take(table, idx, axis=0)` of `attempt_b_dma_gather` and of the
  baseline), bf16 `table` [S, W] with W a multiple of 8, int32 `idx` [n].

An index outside the row (lane gather) or the table (row gather) reads
zeros in the kernels and in the plain versions. CUDA tensors launch the
kernel (or raise); CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from visionllm_tpu_torch.kernels.build import check, library

# the lane gather's largest extent: a row in one block's shared memory,
# as the first kernel held it (the clustered kernel keeps the limit)
MAX_SMEM_BYTES = 232448
MAX_LANE_EXTENT = MAX_SMEM_BYTES // 4


def lane_gather_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    E = v.shape[1]
    ok = (idx >= 0) & (idx < E)
    got = torch.gather(v, 1, idx.clamp(0, E - 1).long())
    return torch.where(ok, got, torch.zeros_like(got))


def lane_gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_along_axis(v, idx, axis=1)` through the lane-gather kernel."""
    if v.device.type == "cpu":
        return lane_gather_plain(v, idx)
    if v.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("lane_gather: v must be float32 and idx int32")
    if v.dim() != 2 or idx.shape != v.shape or idx.device != v.device:
        raise ValueError("lane_gather: v and idx must be [R, E] on one device")
    R, E = v.shape
    if E > MAX_LANE_EXTENT:
        raise ValueError(f"lane_gather: extent {E} exceeds a block's shared "
                         f"memory ({MAX_LANE_EXTENT} floats)")
    v, idx = v.contiguous(), idx.contiguous()
    out = torch.empty_like(v)
    fn = library("gather_probes").lane_gather_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    check(fn(v.data_ptr(), idx.data_ptr(), out.data_ptr(), R, E,
             torch.cuda.current_stream(v.device).cuda_stream),
          "lane_gather_f32")
    lane_gather.launches += 1
    return out


lane_gather.launches = 0


def lane_gather_plan(E: int) -> dict:
    """The lane-gather kernel's launch shape at extent E on the current
    card: CTAs per row (`cluster`), floats each CTA stages (`chunk`), and
    the clusters of that shape that fit on the card at once (`active`)."""
    fn = library("gather_probes").lane_gather_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    out = [ctypes.c_int() for _ in range(3)]
    check(fn(E, *[ctypes.byref(o) for o in out]), "lane_gather_plan")
    return dict(zip(("cluster", "chunk", "active"), (o.value for o in out)))


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    S = table.shape[0]
    ok = (idx >= 0) & (idx < S)
    rows = torch.index_select(table, 0, idx.clamp(0, S - 1).long())
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               rows_per_block: int = 64) -> torch.Tensor:
    """`table[idx]` through the row-gather kernel, `rows_per_block` rows
    per block."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError("row_gather: table must be bfloat16 and idx int32")
    if table.dim() != 2 or idx.dim() != 1 or idx.device != table.device:
        raise ValueError("row_gather: table [S, W] and idx [n] on one device")
    S, W = table.shape
    if W % 8 or rows_per_block < 1:
        raise ValueError(f"row_gather: row width {W} must be a multiple of "
                         f"8 and rows_per_block >= 1")
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape[0], W, dtype=table.dtype, device=table.device)
    fn = library("gather_probes").row_gather_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), S, W,
             idx.shape[0], rows_per_block,
             torch.cuda.current_stream(table.device).cuda_stream),
          "row_gather_bf16")
    row_gather.launches += 1
    return out


row_gather.launches = 0
