"""Attention entry points, [B, L, H, D] in and out.

Counterpart of `visionllm_tpu/ops/attention.py`. `multi_head_attention`
takes the flash kernel (`csrc/flash_attn_fwd.cu`, which replaces the
Pallas TPU flash-attention kernel) where the JAX package takes its flash
branch: no explicit `mask`, and causal only for Lq == Lk (the kernel
start-aligns the causal mask; the einsum branch end-aligns it, query i
attending keys <= i + Lk - Lq). Everything else takes the einsum branch,
as in JAX. The kernel handles head dims 64 and 128 and any length.

`flash_attention` launches the kernel for CUDA tensors (or raises) and
runs its plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from visionllm_tpu_torch.kernels.build import check, library

FLASH_HEAD_DIMS = (64, 128)


def _einsum_attention(q, k, v, mask, scale):
    """Line-for-line port of the JAX `_einsum_attention`: fp32 scores,
    masked with the fp32 minimum, fp32 softmax, probs cast to v's dtype."""
    H, H_kv = q.shape[2], k.shape[2]
    if H_kv != H:  # GQA: repeat kv heads
        k = k.repeat_interleave(H // H_kv, dim=2)
        v = v.repeat_interleave(H // H_kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _segment_mask(segment_ids):
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def flash_attention_plain(q, k, v, *, causal=False, segment_ids=None):
    """The flash kernel's function in plain PyTorch: start-aligned causal
    mask, segment ids, GQA."""
    mask = None
    if segment_ids is not None:
        mask = _segment_mask(segment_ids)
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        cm = (torch.arange(Lk, device=q.device)[None, :]
              <= torch.arange(Lq, device=q.device)[:, None])[None, None]
        mask = cm if mask is None else mask & cm
    return _einsum_attention(q, k, v, mask, q.shape[-1] ** -0.5)


def _check_flash_args(q, k, v, causal, segment_ids):
    B, Lq, H, D = q.shape
    Lk, H_kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if t.stride(3) != 1 or any(s % 2 for s in t.stride()[:3]) \
                or t.data_ptr() % 4:
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             "stride, even other strides and 4-byte "
                             "alignment")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{FLASH_HEAD_DIMS}")
    if k.shape != (B, Lk, H_kv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % H_kv:
        raise ValueError(f"flash_attention: {H} heads not a multiple of "
                         f"{H_kv} kv heads")
    if causal and Lq != Lk:
        raise ValueError("flash_attention: causal needs Lq == Lk "
                         "(start-aligned mask)")
    if segment_ids is not None and (Lq != Lk or segment_ids.shape != (B, Lq)):
        raise ValueError("flash_attention: segment_ids must be [B, L] of a "
                         "self-attention")


def flash_attention(q, k, v, *, causal=False, segment_ids=None):
    """softmax(q kᵀ / sqrt(D)) v through the hand-written CUDA kernel.

    q [B, Lq, H, D], k/v [B, Lk, H_kv, D] bf16 with a unit last stride;
    `segment_ids` int [B, L]. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     segment_ids=segment_ids)
    _check_flash_args(q, k, v, causal, segment_ids)
    B, Lq, H, D = q.shape
    Lk, H_kv = k.shape[1], k.shape[2]
    out = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    seg_ptr, segb = None, 0
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        seg_ptr, segb = seg.data_ptr(), seg.stride(0)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = library("flash_attn_fwd").flash_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             seg_ptr, B, Lq, Lk, H, H_kv, D, strides, segb, int(causal),
             D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream),
          "flash_attn_fwd_bf16")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _flash_ok(q, k, mask, causal) -> bool:
    """The JAX flash predicate by shape (`_flash_ok` / `_flash_causal_ok`):
    no explicit mask, causal only for Lq == Lk, a head dim the kernel
    takes."""
    if mask is not None or q.shape[-1] not in FLASH_HEAD_DIMS:
        return False
    return not causal or q.shape[1] == k.shape[1]


def multi_head_attention(q, k, v, *, mask: Optional[torch.Tensor] = None,
                         causal: bool = False,
                         segment_ids: Optional[torch.Tensor] = None):
    """Scaled dot-product attention, [B, L, H, D] in/out.

    `mask` is a boolean attend-mask broadcastable to [B, H, Lq, Lk]."""
    if _flash_ok(q, k, mask, causal):
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if segment_ids is not None:
        seg_mask = _segment_mask(segment_ids)
        mask = seg_mask if mask is None else mask & seg_mask
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        # end-aligned: query i attends keys <= i + (Lk - Lq)
        cm = (torch.arange(Lk, device=q.device)[None, :]
              <= torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq))
        cm = cm[None, None]
        mask = cm if mask is None else mask & cm
    return _einsum_attention(q, k, v, mask, q.shape[-1] ** -0.5)
