"""GPipe pipeline parallelism over the LLaMA layer stack (counterpart of
`visionllm_tpu/parallel/pipeline.py`).

The S ranks of a mesh axis (default "pipe") are the stages: stage s
runs layers [s L/S, (s+1) L/S) of the port's `LlamaModel` (every rank
holds the whole model, as every JAX device holds the whole param tree
before `shard_map` slices it). The batch is split into M microbatches;
stage s takes microbatch m from stage s-1 (stage 0 from the inputs),
runs its layers and sends the activation to stage s+1, so stage s works
on microbatch m while stage s+1 works on m-1: GPipe's schedule, with
only the in-window steps computed (JAX computes the out-of-window steps
on garbage and masks them; the values are the same). The last stage
applies the final norm and `lm_head` and broadcasts the logits to every
rank (JAX's `psum` of the last stage's outputs).

The sends and receives are autograd functions, so `loss.backward()` on
every rank runs the schedule backwards: a send's backward receives the
activation's gradient from the next stage, a receive's backward sends
the input's gradient to the previous one, and the broadcast's backward
keeps the last stage's gradient (every rank's loss is the same value).
The backward visits microbatches from the last to the first on every
stage (autograd runs the latest-created node first), so the blocking
transfers pair up.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from visionllm_tpu_torch.config import LLMConfig
from visionllm_tpu_torch.models.common import rope_cos_sin


class _Send(torch.autograd.Function):
    """Send y to `peer`; returns a scalar token that carries the backward
    (which receives y's gradient from `peer`)."""

    @staticmethod
    def forward(ctx, y, peer: int, group):
        ctx.peer, ctx.group = peer, group
        ctx.meta = (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), peer, group=group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.peer, group=ctx.group)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor from `peer`; its backward sends the gradient back.
    `anchor` is a scalar that requires grad, so the output joins the
    graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, peer: int, group):
        ctx.peer, ctx.group = peer, group
        x = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(x, peer, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.peer, group=ctx.group)
        return None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """Broadcast the last stage's x to every stage. The backward keeps
    the source's gradient and gives the other stages' send tokens a zero
    gradient, which starts their sends' backwards."""

    @staticmethod
    def forward(ctx, x, src: int, group, *tokens):
        ctx.is_src = dist.get_rank() == src
        ctx.n_tokens = len(tokens)
        out = x.detach().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        zeros = [grad.new_zeros(())] * ctx.n_tokens
        return (grad if ctx.is_src else None, None, None, *zeros)


def pipeline_llm_forward(cfg: LLMConfig, llm: torch.nn.Module,
                         inputs_embeds: torch.Tensor,
                         positions: torch.Tensor, mesh, *, n_microbatch: int,
                         axis_name: str = "pipe",
                         compute_logits: bool = True) -> torch.Tensor:
    """The cache-less prefill of `llm` (a `LlamaModel`) with its layers
    split over the `axis_name` ranks of `mesh` and the batch over
    `n_microbatch` microbatches. inputs_embeds [B, L, hid], positions [B,
    L] (the same on every rank). Returns fp32 logits [B, L, vocab] (or
    the hidden states after the final norm under compute_logits=False)
    on every rank, equal to `llm(inputs_embeds, positions)`'s."""
    B, L, hid = inputs_embeds.shape
    M = n_microbatch
    sub = mesh[axis_name]
    S, s = sub.size(), sub.get_local_rank()
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers do not split over {S} "
                         "stages")
    group = sub.get_group()
    per = cfg.num_layers // S
    layers = llm.layers[s * per:(s + 1) * per]
    dtype = llm.norm.weight.dtype
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            dtype=dtype)
    rank = (lambda i: dist.get_global_rank(group, i)) if S > 1 else None
    anchor = inputs_embeds.new_zeros((), requires_grad=True) \
        if torch.is_grad_enabled() else inputs_embeds.new_zeros(())
    mb_shape = (B // M, L, hid)
    outs: List[torch.Tensor] = []
    tokens: List[torch.Tensor] = []
    for m, (x, c, sn) in enumerate(zip(inputs_embeds.chunk(M),
                                       cos.chunk(M), sin.chunk(M))):
        x = x.to(dtype) if s == 0 else _Recv.apply(anchor, mb_shape, dtype,
                                                   rank(s - 1), group)
        for layer in layers:
            x = layer(x, c, sn)
        if s < S - 1:
            tokens.append(_Send.apply(x, rank(s + 1), group))
        else:
            outs.append(x)
    out: Optional[torch.Tensor] = None
    if s == S - 1:
        out = llm.norm(torch.cat(outs))
        if compute_logits:
            out = llm.lm_head(out).float()
    if S == 1:
        return out
    if out is None:
        width = cfg.vocab_size if compute_logits else hid
        out = torch.empty(B, L, width, device=inputs_embeds.device,
                          dtype=torch.float32 if compute_logits else dtype)
    return _Broadcast.apply(out, rank(S - 1), group, *tokens)
