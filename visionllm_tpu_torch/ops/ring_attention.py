"""Ring attention over the "context" mesh axis (counterpart of
`visionllm_tpu/ops/ring_attention.py`).

Each of the S ranks of the context group holds one contiguous block of
the sequence, [B, Lc, H, D], in rank order. In S steps every rank
attends its query block to each key/value block while the K/V blocks
travel one hop around the ring (`dist.batch_isend_irecv`, posted before
the block is computed so the transfer overlaps it), and merges each
block's (out, lse) into an fp32 running (acc, lse) (Liu et al., "Ring
Attention with Blockwise Transformers", arXiv:2310.01889).

The block is `ops.attention.attention_lse`: the hand-written flash
kernel for bf16 CUDA blocks that `multi_head_attention` would flash (Lc
>= 128, D 64 or 128), which writes the row logsumexp beside its output;
the plain fp32 block elsewhere. Under `causal` the diagonal block is
causal with Lq == Lk (its start-aligned mask is the global one), earlier
blocks are full, and later blocks are skipped: JAX computes them under a
-1e9 fill whose merge weight is exactly 0. K/V travel with their H_kv
heads and the block handles GQA (JAX repeats them before rotating; the
values are the same).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from visionllm_tpu_torch.ops.attention import attention_lse

_NEG = -1e9     # the running lse before any block: exp(_NEG - x) == 0


def ring_init(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The empty running state for query block q [B, Lc, H, D]: acc
    fp32 [B, Lc, H, D] zeros, lse fp32 [B, H, Lc] at -1e9."""
    B, Lc, H, D = q.shape
    return (torch.zeros(B, Lc, H, D, dtype=torch.float32, device=q.device),
            torch.full((B, H, Lc), _NEG, dtype=torch.float32,
                       device=q.device))


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              acc: torch.Tensor, lse: torch.Tensor, *, q_block: int,
              kv_block: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend query block `q_block` to key/value block `kv_block` and merge
    the result into the running (acc, lse); returns the new pair. Under
    `causal` a later block is skipped."""
    if causal and kv_block > q_block:
        return acc, lse
    out_b, lse_b = attention_lse(q, k, v,
                                 causal=causal and kv_block == q_block)
    new = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return acc * w_old + out_b.float() * w_blk, new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: Optional[dist.ProcessGroup] = None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention over a sequence split in rank order over `group`:
    q [B, Lc, H, D] and k/v [B, Lc, H_kv, D] are this rank's blocks;
    returns this rank's output block in q's dtype."""
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt, prv = (me + 1) % S, (me - 1) % S
    if group is not None:
        nxt, prv = (dist.get_global_rank(group, r) for r in (nxt, prv))
    acc, lse = ring_init(q)
    kb, vb = k.contiguous(), v.contiguous()
    for step in range(S):
        reqs = []
        if step < S - 1:
            nk, nv = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group),
                dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, nk, prv, group),
                dist.P2POp(dist.irecv, nv, prv, group)])
        acc, lse = ring_step(q, kb, vb, acc, lse, q_block=me,
                             kv_block=(me - step) % S, causal=causal)
        for r in reqs:
            r.wait()
        if reqs:
            kb, vb = nk, nv
    return acc.to(q.dtype)


def ring_attention_spmd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, *, axis_name: str = "context",
                        causal: bool = False,
                        batch_axis: Optional[str] = "data") -> torch.Tensor:
    """Ring attention on global [B, L, H, D] tensors held by every rank:
    this rank takes its sequence block by its `axis_name` rank (and its
    batch block by its `batch_axis` rank, when the mesh has that axis),
    runs the ring, and all-gathers the output back to [B, L, H, D]."""
    names = tuple(mesh.mesh_dim_names)
    sub = mesh[axis_name]
    S, c = sub.size(), sub.get_local_rank()
    L = q.shape[1]
    if L % S:
        raise ValueError(f"sequence {L} does not split over {S} ranks")
    parts = [(1, S, c, sub)]
    if batch_axis and batch_axis in names:
        bm = mesh[batch_axis]
        if q.shape[0] % bm.size():
            raise ValueError(f"batch {q.shape[0]} does not split over "
                             f"{bm.size()} ranks")
        parts.append((0, bm.size(), bm.get_local_rank(), bm))
    for dim, n, r, _ in parts:
        q, k, v = (t.chunk(n, dim)[r] for t in (q, k, v))
    out = ring_attention(q.contiguous(), k, v, group=sub.get_group(),
                         causal=causal)
    for dim, n, _, m in reversed(parts):
        pieces = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(pieces, out.contiguous(), group=m.get_group())
        out = torch.cat(pieces, dim)
    return out
