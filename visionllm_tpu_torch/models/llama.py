"""LLaMA-family causal decoder, cache-less prefill (counterpart of
`visionllm_tpu/models/llama.py` without the KV cache, quantization or
LoRA). The layer stack is a ModuleList `layers` run by a Python loop
(the flax tree stacks it on axis 0 under `layers/layer`).

A key-valid mask [B, L] (left-padded prefill) becomes segment ids —
valid tokens 1, pads 0 — so the flash kernel stays on the path, as in
the JAX package (`llama.py:110-119`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import LLMConfig
from visionllm_tpu_torch.models.common import RMSNorm, apply_rope, rope_cos_sin
from visionllm_tpu_torch.ops.attention import multi_head_attention


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        hid, hd = cfg.hidden_size, cfg.head_dim
        self.input_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.q_proj = nn.Linear(hid, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(hid, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(hid, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, hid, bias=False)
        self.post_attention_layernorm = RMSNorm(hid, cfg.rms_norm_eps)
        self.gate_proj = nn.Linear(hid, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(hid, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, hid, bias=False)

    def forward(self, hidden, cos, sin, segment_ids=None):
        cfg = self.cfg
        B, L, _ = hidden.shape
        x = self.input_layernorm(hidden)
        q = self.q_proj(x).reshape(B, L, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, L, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, L, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        attn = multi_head_attention(q, k, v, causal=True,
                                    segment_ids=segment_ids)
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
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                compute_logits: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """inputs_embeds [B, L, hid], positions [B, L], attn_mask [B, L]
        (1 = valid) -> (hidden after the final norm, fp32 logits or None)."""
        cfg = self.cfg
        dtype = self.norm.weight.dtype
        B, L, _ = inputs_embeds.shape
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                dtype=dtype)
        seg = None
        if attn_mask is not None and L > 1:
            seg = attn_mask.to(torch.int32)
        hidden = inputs_embeds.to(dtype)
        for layer in self.layers:
            hidden = layer(hidden, cos, sin, seg)
        hidden = self.norm(hidden)
        logits = self.lm_head(hidden).float() if compute_logits else None
        return hidden, logits
