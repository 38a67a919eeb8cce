"""LLaMA-family causal decoder with a KV cache (counterpart of
`visionllm_tpu/models/llama.py` without LoRA or the int8 modes). The layer
stack is a ModuleList `layers` run by a Python loop (the flax tree stacks
it on axis 0 under `layers/layer`).

* `cache=None` runs causal attention over the sequence. With a `KVCache`,
  L > 1 is a prefill that writes the cache window [index, index + L) and
  attends within the fresh window; L == 1 is a decode step that writes
  K/V at `cache.index` and attends the whole buffer through the einsum
  branch, masked by `pos <= index` and the key-valid mask
  (`llama.py:162-172`, `:292-297`). `extend=True` is the cached extend
  window (`llama.py:121-127`, `:281-290`): L > 1 new tokens written at
  the index, every query attending the whole buffer under
  `pos <= index + i` and the key-valid mask, through the einsum branch as
  in JAX. The cache is updated in place (JAX returns a new one) and its
  index advances by L.
* `KVCache.index` is a Python int (one fill level for the batch) or an
  int64 tensor [B] of per-row fill levels (the slot engine's batched
  step): positions, cache writes and the decode mask are then per row,
  the work JAX does by `jax.vmap` of the scalar-index step. Writes clamp
  their start so the window fits the buffer, as `dynamic_update_slice`
  does in JAX.
* A key-valid mask [B, L] on a prefill (left-padded prompts) becomes
  segment ids - valid tokens 1, pads 0 - so the flash kernel stays on the
  path, as in the JAX package (`llama.py:110-119`).
* `quant="int4"` makes every projection and `lm_head` an `Int4Linear`
  (`llama.py:95-98`, `:245-248`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import LLMConfig
from visionllm_tpu_torch.models.common import RMSNorm, apply_rope, rope_cos_sin
from visionllm_tpu_torch.ops.attention import multi_head_attention
from visionllm_tpu_torch.ops.quant4 import Int4Linear


class KVCache:
    """Preallocated K/V buffers [n_layers, B, max_len, H_kv, D] in the
    model dtype, and `index`, the number of positions already written:
    an int, or an int64 tensor [B] with one fill level per row."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 index: Union[int, torch.Tensor] = 0):
        self.k, self.v, self.index = k, v, index

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _write_window(buf: torch.Tensor, new: torch.Tensor,
                  index: Union[int, torch.Tensor]) -> None:
    """Write `new` [B, L, ...] into `buf` [B, max_len, ...] at `index` (an
    int, or [B] per row), the start clamped to max_len - L."""
    L, max_len = new.shape[1], buf.shape[1]
    if isinstance(index, int):
        start = min(max(index, 0), max_len - L)
        buf[:, start:start + L] = new
        return
    cols = index.clamp(0, max_len - L)[:, None] + torch.arange(
        L, device=buf.device)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, cols] = new


def _buffer_bias(index: Union[int, torch.Tensor], B: int, L: int,
                 max_len: int, attn_mask: Optional[torch.Tensor],
                 device) -> torch.Tensor:
    """[B, 1, L, max_len] attend-mask of L queries written at `index` over
    the whole buffer: key j is visible to query i iff j <= index + i and
    the key-valid mask [B, max_len] (when given) holds at j."""
    qpos = torch.arange(L, device=device)
    qpos = qpos + (index if isinstance(index, int) else index[:, None])
    vis = torch.arange(max_len, device=device) <= qpos[..., None]
    vis = vis.expand(B, L, max_len)
    if attn_mask is not None:
        vis = vis & attn_mask.bool()[:, None, :]
    return vis[:, None]


def _dense(cfg: LLMConfig, fin: int, fout: int) -> nn.Module:
    if cfg.quant == "int4":
        return Int4Linear(fin, fout)
    return nn.Linear(fin, fout, bias=False)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        hid, hd = cfg.hidden_size, cfg.head_dim
        self.input_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.q_proj = _dense(cfg, hid, cfg.num_heads * hd)
        self.k_proj = _dense(cfg, hid, cfg.num_kv_heads * hd)
        self.v_proj = _dense(cfg, hid, cfg.num_kv_heads * hd)
        self.o_proj = _dense(cfg, cfg.num_heads * hd, hid)
        self.post_attention_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.gate_proj = _dense(cfg, hid, cfg.intermediate_size)
        self.up_proj = _dense(cfg, hid, cfg.intermediate_size)
        self.down_proj = _dense(cfg, cfg.intermediate_size, hid)

    def forward(self, hidden, cos, sin, segment_ids=None, bias=None,
                k_cache=None, v_cache=None, cache_index=0):
        """k_cache/v_cache: this layer's [B, max_len, H_kv, D] buffers,
        written in place at `cache_index`; `bias` [B, 1, L, max_len], given
        for a decode step or an extend window, is the mask over the whole
        buffer."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        x = self.input_layernorm(hidden)
        q = self.q_proj(x).reshape(B, L, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, L, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, L, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        if k_cache is not None:
            _write_window(k_cache, k, cache_index)
            _write_window(v_cache, v, cache_index)
        if bias is None:
            # no cache, or a prefill: attend within the fresh window
            attn = multi_head_attention(q, k, v, causal=True,
                                        segment_ids=segment_ids)
        else:
            # decode or extend: the whole (masked) buffer; the bias holds
            # causality
            attn = multi_head_attention(q, k_cache, v_cache, mask=bias)
        hidden = hidden + self.o_proj(attn.reshape(B, L, -1))
        x = self.post_attention_layernorm(hidden)
        return hidden + self.down_proj(F.silu(self.gate_proj(x))
                                       * self.up_proj(x))


class LlamaModel(nn.Module):
    """Decoder stack + embeddings + lm_head (untied, like Vicuna)."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = _dense(cfg, cfg.hidden_size, cfg.vocab_size)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                compute_logits: bool = True, extend: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """inputs_embeds [B, L, hid], positions [B, L]; attn_mask (1 =
        valid) is [B, L] for a prefill or cache-less run and [B, max_len]
        for a decode step or an extend window (`extend=True`: L tokens
        appended at the cache's index, attending history and the causal
        part of the window). Returns (hidden after the final norm, fp32
        logits or None); a given cache is written and advanced by L."""
        cfg = self.cfg
        dtype = self.norm.weight.dtype
        B, L, _ = inputs_embeds.shape
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                dtype=dtype)
        seg = bias = None
        if cache is not None and (L == 1 or extend):
            bias = _buffer_bias(cache.index, B, L, cache.k.shape[2],
                                attn_mask, inputs_embeds.device)
        elif attn_mask is not None and L > 1:
            seg = attn_mask.to(torch.int32)
        hidden = inputs_embeds.to(dtype)
        for i, layer in enumerate(self.layers):
            kc = vc = None
            if cache is not None:
                kc, vc = cache.k[i], cache.v[i]
            hidden = layer(hidden, cos, sin, seg, bias, kc, vc,
                           0 if cache is None else cache.index)
        if cache is not None:
            cache.index = cache.index + L
        hidden = self.norm(hidden)
        logits = self.lm_head(hidden).float() if compute_logits else None
        return hidden, logits
