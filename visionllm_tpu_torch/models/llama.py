"""LLaMA-family causal decoder with a KV cache (counterpart of
`visionllm_tpu/models/llama.py`). The layer stack is a ModuleList
`layers` run by a Python loop (the flax tree stacks it on axis 0 under
`layers/layer`).

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
* An int8 cache (`kv_quant="int8"`, `KVCache.create(..., torch.int8)`)
  stores K/V as int8 with per-(token, head) bf16 scales
  (`llama.py:134-157`): every window's new K/V are quantized and
  written; a prefill attends its fresh window in the model dtype (the
  flash kernel where JAX flashes), a decode step or an extend window
  attends the whole quantized buffer through `int8_kv_attention`.
* A key-valid mask [B, L] on a prefill (left-padded prompts) becomes
  segment ids - valid tokens 1, pads 0 - so the flash kernel stays on the
  path, as in the JAX package (`llama.py:110-119`).
* `quant` makes every projection and `lm_head` an `Int8Linear` ("int8"),
  an `Int8ActLinear` ("w8a8") or an `Int4Linear` ("int4";
  `llama.py:87-98`, `:237-248`).
* `lora_r > 0` makes the seven projections of every layer `LoraLinear`s
  (`models/lora.py`), ahead of `quant` as in JAX (`llama.py:82-95`);
  `lm_head` stays as `quant` makes it.
* `remat` ("dots" or "full") runs each layer under
  `models/remat.remat_call` while autograd records and no cache is
  passed (JAX `nn.remat` of the scanned layer, `llama.py:219-225`):
  "dots" saves the 2-D products' outputs (`dots_with_no_batch_dims_
  saveable`), "full" recomputes the layer.
* Under tensor parallelism (`parallel/mesh.apply_tensor_parallel`, which
  sets `LlamaModel.tp_size`) each rank's projections hold H / tp query
  and H_kv / tp kv heads: the layer reshapes by the head dim alone, and
  the cache holds the local kv heads. `constrain_seq` runs where JAX
  calls it (`llama.py:186`, `:275`); on the plain activations the model
  runs on today it returns them unchanged (`ROADMAP.md` A.8.3).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import LLMConfig
from visionllm_tpu_torch.models.common import RMSNorm, apply_rope, rope_cos_sin
from visionllm_tpu_torch.models.lora import LoraLinear
from visionllm_tpu_torch.models.remat import NO_BATCH_DOTS, remat_call
from visionllm_tpu_torch.ops.attention import multi_head_attention
from visionllm_tpu_torch.ops.quant import (Int8ActLinear, Int8Linear,
                                           int8_kv_attention, quantize_kv)
from visionllm_tpu_torch.ops.quant4 import Int4Linear
from visionllm_tpu_torch.parallel.sequence import constrain_seq


class KVCache:
    """Preallocated K/V buffers [n_layers, B, max_len, H_kv, D] and
    `index`, the number of positions already written: an int, or an int64
    tensor [B] with one fill level per row. An int8 cache also holds
    `k_scale` / `v_scale`, bf16 [n_layers, B, max_len, H_kv] (ones until
    written)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 index: Union[int, torch.Tensor] = 0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.k, self.v, self.index = k, v, index
        self.k_scale, self.v_scale = k_scale, v_scale

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype: torch.dtype, device, tp_size: int = 1) -> "KVCache":
        """Zeroed buffers in `dtype`; `torch.int8` makes an int8 cache.
        Under tensor parallelism of `tp_size` ranks each holds H_kv /
        tp_size heads."""
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads // tp_size,
                 cfg.head_dim)
        k, v = (torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(2))
        if dtype != torch.int8:
            return cls(k, v)
        ks, vs = (torch.ones(shape[:-1], dtype=torch.bfloat16,
                             device=device) for _ in range(2))
        return cls(k, v, k_scale=ks, v_scale=vs)

    def layer(self, i: int):
        """Layer i's (k, v, k_scale, v_scale) buffers (scales None unless
        int8)."""
        if self.k_scale is None:
            return self.k[i], self.v[i], None, None
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]


def _write_window(buf: torch.Tensor, new: torch.Tensor,
                  index: Union[int, torch.Tensor]) -> None:
    """Write `new` [B, L, ...] into `buf` [B, max_len, ...] (K/V, or the
    int8 cache's scales [B, max_len, H_kv]) at `index` (an int, or [B] per
    row), the start clamped to max_len - L."""
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


_QUANT_LINEAR = {"int8": Int8Linear, "w8a8": Int8ActLinear,
                 "int4": Int4Linear}


def _dense(cfg: LLMConfig, fin: int, fout: int, lora: bool = False
           ) -> nn.Module:
    if lora and cfg.lora_r > 0:
        return LoraLinear(fin, fout, cfg.lora_r, cfg.lora_alpha)
    if cfg.quant:
        return _QUANT_LINEAR[cfg.quant](fin, fout)
    return nn.Linear(fin, fout, bias=False)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        hid, hd = cfg.hidden_size, cfg.head_dim
        self.input_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.q_proj = _dense(cfg, hid, cfg.num_heads * hd, lora=True)
        self.k_proj = _dense(cfg, hid, cfg.num_kv_heads * hd, lora=True)
        self.v_proj = _dense(cfg, hid, cfg.num_kv_heads * hd, lora=True)
        self.o_proj = _dense(cfg, cfg.num_heads * hd, hid, lora=True)
        self.post_attention_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.gate_proj = _dense(cfg, hid, cfg.intermediate_size, lora=True)
        self.up_proj = _dense(cfg, hid, cfg.intermediate_size, lora=True)
        self.down_proj = _dense(cfg, cfg.intermediate_size, hid, lora=True)

    def forward(self, hidden, cos, sin, segment_ids=None, bias=None,
                k_cache=None, v_cache=None, cache_index=0, ks_cache=None,
                vs_cache=None):
        """k_cache/v_cache: this layer's [B, max_len, H_kv, D] buffers
        (with ks_cache/vs_cache [B, max_len, H_kv] when int8), written in
        place at `cache_index`; `bias` [B, 1, L, max_len], given for a
        decode step or an extend window, is the mask over the whole
        buffer."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        x = self.input_layernorm(hidden)
        # by the head dim alone: under tensor parallelism the projections
        # give this rank's heads
        q = self.q_proj(x).reshape(B, L, -1, cfg.head_dim)
        k = self.k_proj(x).reshape(B, L, -1, cfg.head_dim)
        v = self.v_proj(x).reshape(B, L, -1, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        if k_cache is not None and k_cache.dtype == torch.int8:
            for buf, sbuf, new in ((k_cache, ks_cache, k),
                                   (v_cache, vs_cache, v)):
                nq, ns = quantize_kv(new)
                _write_window(buf, nq, cache_index)
                _write_window(sbuf, ns, cache_index)
        elif k_cache is not None:
            _write_window(k_cache, k, cache_index)
            _write_window(v_cache, v, cache_index)
        if bias is None:
            # no cache, or a prefill: attend within the fresh window (in
            # the model dtype, int8 cache or not)
            attn = multi_head_attention(q, k, v, causal=True,
                                        segment_ids=segment_ids)
        elif k_cache.dtype == torch.int8:
            attn = int8_kv_attention(q, k_cache, ks_cache, v_cache,
                                     vs_cache, bias)
        else:
            # decode or extend: the whole (masked) buffer; the bias holds
            # causality
            attn = multi_head_attention(q, k_cache, v_cache, mask=bias)
        hidden = hidden + self.o_proj(attn.reshape(B, L, -1))
        x = self.post_attention_layernorm(hidden)
        hidden = hidden + self.down_proj(F.silu(self.gate_proj(x))
                                         * self.up_proj(x))
        return constrain_seq(hidden)


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
        self.tp_size = 1    # set by parallel/mesh.apply_tensor_parallel

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
        inputs_embeds = constrain_seq(inputs_embeds)
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
            if cache is None:
                hidden = remat_call(cfg.remat, NO_BATCH_DOTS, layer, hidden,
                                    cos, sin, seg, bias)
                continue
            kc, vc, ks, vs = cache.layer(i)
            hidden = layer(hidden, cos, sin, seg, bias, kc, vc, cache.index,
                           ks, vs)
        if cache is not None:
            cache.index = cache.index + L
        hidden = self.norm(hidden)
        logits = self.lm_head(hidden).float() if compute_logits else None
        return hidden, logits
