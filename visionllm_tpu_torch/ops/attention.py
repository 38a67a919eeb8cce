"""Attention entry points, [B, L, H, D] in and out.

Counterpart of `visionllm_tpu/ops/attention.py`. `multi_head_attention`
takes the flash kernel (`csrc/flash_attn_fwd.cu`, which replaces the
Pallas TPU flash-attention kernel) where the JAX package takes its flash
branch: no explicit `mask`, Lq >= 128 and Lk >= 128, and causal only for
Lq == Lk (the kernel start-aligns the causal mask; the einsum branch
end-aligns it, query i attending keys <= i + Lk - Lq). Everything else
takes the einsum branch, as in JAX, which rounds the probabilities to v's
dtype before P V, and trains through PyTorch autograd as JAX's does
through autodiff. One difference is deliberate: JAX also flashes head
dims 192 and 256 (D % 64 == 0); the kernel takes 64 and 128, the head
dims of every config of the repo, and other head dims take the einsum
branch here.

`flash_attention` launches the kernel for CUDA tensors (or raises) and
runs its plain version only for tensors on the CPU. Under grad mode, with
an input that requires grad, it is the autograd function
`FlashAttentionFn`: the forward also writes the row logsumexp, and the
backward launches `csrc/flash_attn_bwd.cu` (the counterpart of the Pallas
`_flash_attention_bwd_dkv` / `_flash_attention_bwd_dq`) through
`flash_attention_bwd`, whose plain version is autograd of
`flash_attention_plain`.

`attention_lse` returns the row logsumexp beside the output, without
autograd, for callers that merge attention blocks (`ops/ring_attention.py`):
the same kernel where `multi_head_attention` would flash a bf16 CUDA call,
`attention_lse_plain` (fp32) elsewhere.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from visionllm_tpu_torch.kernels.build import check, library

FLASH_HEAD_DIMS = (64, 128)
FLASH_MIN_LEN = 128        # JAX's `_flash_ok`: Lq and Lk at least 128


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
    mask, segment ids, GQA, all in fp32, rounding only the output to q's
    dtype. The kernel rounds each tile of unnormalised probabilities to
    bf16 before P V, with fp32 sums, as the Pallas kernel does
    (`p.astype(v.dtype)`); this version keeps them in fp32, and the
    tolerance the kernel is held to (0.02 + 0.01 max|plain|) covers the
    difference."""
    mask = None
    if segment_ids is not None:
        mask = _segment_mask(segment_ids)
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        cm = (torch.arange(Lk, device=q.device)[None, :]
              <= torch.arange(Lq, device=q.device)[:, None])[None, None]
        mask = cm if mask is None else mask & cm
    return _einsum_attention(q.float(), k.float(), v.float(), mask,
                             q.shape[-1] ** -0.5).to(q.dtype)


def _check_flash_args(q, k, v, causal, segment_ids):
    B, Lq, H, D = q.shape
    Lk, H_kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        # the kernel copies 16-byte chunks of rows: no silent copy here
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             "stride, (batch, seq, head) strides that are "
                             "multiples of 8 elements and a 16-byte "
                             "aligned pointer")
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


@functools.cache
def _fwd_entry():
    """The forward's C entry, its ctypes signature bound once."""
    fn = library("flash_attn_fwd").flash_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def _bwd_entry():
    """The backward's C entry, its ctypes signature bound once."""
    fn = library("flash_attn_bwd").flash_attn_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch_fwd(q, k, v, causal, segment_ids, lse=None):
    B, Lq, H, D = q.shape
    Lk, H_kv = k.shape[1], k.shape[2]
    out = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    seg_ptr, segb = None, 0
    if segment_ids is not None:
        seg_ptr, segb = segment_ids.data_ptr(), segment_ids.stride(0)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    check(_fwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), seg_ptr, B, Lq, Lk, H, H_kv,
        D, strides, segb, int(causal), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attn_fwd_bf16")
    flash_attention.launches += 1
    return out


def _segments_on(q, segment_ids):
    if segment_ids is None:
        return None
    return segment_ids.to(device=q.device, dtype=torch.int32).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its backward kernel (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids):
        B, Lq, H, _ = q.shape
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
        out = _launch_fwd(q, k, v, causal, segment_ids, lse)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal, segment_ids=seg)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=False, segment_ids=None):
    """softmax(q kᵀ / sqrt(D)) v through the hand-written CUDA kernel.

    q [B, Lq, H, D], k/v [B, Lk, H_kv, D] bf16 with a unit last stride;
    `segment_ids` int [B, L]. CPU tensors take the plain version. Under
    grad mode with an input that requires grad the result carries the
    backward kernel (`FlashAttentionFn`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     segment_ids=segment_ids)
    _check_flash_args(q, k, v, causal, segment_ids)
    seg = _segments_on(q, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, seg)
    return _launch_fwd(q, k, v, causal, seg)


flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, dout, *, causal=False,
                              segment_ids=None):
    """(dq, dk, dv) of `flash_attention_plain` by autograd."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=causal,
                                    segment_ids=segment_ids)
        return torch.autograd.grad(out, qkv, dout)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=False,
                        segment_ids=None):
    """(dq, dk, dv) through the backward kernels `csrc/flash_attn_bwd.cu`
    (Di = rowsum(dO * O) into a scratch buffer, then one grid of the dQ
    and dK/dV blocks: two launches, one count), given the forward's output
    `out` and row logsumexp `lse` (fp32 [B, H, Lq]). CPU tensors take
    `flash_attention_bwd_plain` (which needs neither `out` nor `lse`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         segment_ids=segment_ids)
    _check_flash_args(q, k, v, causal, segment_ids)
    B, Lq, H, D = q.shape
    Lk, H_kv = k.shape[1], k.shape[2]
    if dout.dtype != torch.bfloat16 or dout.shape != q.shape \
            or out.shape != q.shape:
        raise ValueError("flash_attention_bwd: out and dout must be bf16 "
                         f"{tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, H, Lq):
        raise ValueError(f"flash_attention_bwd: lse must be fp32 "
                         f"{(B, H, Lq)}")
    # the kernels read out and dout by 16-byte copies, as q, k and v
    q, k, v, out, dout, lse = (
        t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
            memory_format=torch.contiguous_format)
        for t in (q, k, v, out, dout, lse))
    seg = _segments_on(q, segment_ids)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    check(_bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if seg is None else seg.data_ptr(), di.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, H_kv, D,
        int(causal), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attn_bwd_bf16")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def attention_lse_plain(q, k, v, *, causal=False):
    """(out, lse) of the flash kernel's function in fp32: out [B, Lq, H, D]
    and the row logsumexp of the scaled scores [B, H, Lq] (start-aligned
    causal mask, GQA)."""
    H, H_kv = q.shape[2], k.shape[2]
    k, v = k.float(), v.float()
    if H_kv != H:
        k = k.repeat_interleave(H // H_kv, dim=2)
        v = v.repeat_interleave(H // H_kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * q.shape[-1] ** -0.5
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        cm = (torch.arange(Lk, device=q.device)[None, :]
              <= torch.arange(Lq, device=q.device)[:, None])
        s = s.masked_fill(~cm, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return out, lse


def attention_lse(q, k, v, *, causal=False):
    """(out, lse) of softmax attention, without autograd, for callers that
    merge blocks (ring attention): the flash kernel, which writes the row
    logsumexp beside its bf16 output, where `multi_head_attention` would
    flash a bf16 CUDA call; the plain version in fp32 elsewhere."""
    if q.device.type == "cuda" and q.dtype == torch.bfloat16 \
            and _flash_ok(q, k, None, causal):
        _check_flash_args(q, k, v, causal, None)
        B, Lq, H, _ = q.shape
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
        return _launch_fwd(q, k, v, causal, None, lse), lse
    return attention_lse_plain(q, k, v, causal=causal)


def _flash_ok(q, k, mask, causal) -> bool:
    """The JAX flash predicate by shape (`_flash_ok` / `_flash_causal_ok`):
    no explicit mask, Lq >= 128 and Lk >= 128, causal only for Lq == Lk,
    and a head dim the kernel takes (64 or 128; JAX also takes 192 and
    256, which no config of the repo has)."""
    Lq, Lk = q.shape[1], k.shape[1]
    if mask is not None or q.shape[-1] not in FLASH_HEAD_DIMS \
            or Lq < FLASH_MIN_LEN or Lk < FLASH_MIN_LEN:
        return False
    return not causal or Lq == Lk


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
