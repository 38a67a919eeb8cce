"""CLIP text encoder, SD-1.5's conditioning tower (counterpart of
`visionllm_tpu/models/stable_diffusion/clip_text.py`, after the HF
CLIPTextModel of the reference's modeling_sd.py:88): 12 layers, hidden
768, 12 heads, causal attention, quick_gelu, a final LayerNorm.

Nothing in the JAX package calls it and no dataset gives
`caption_embeds`, so nothing here calls it either; it is ported for
parity, with the flax parameter names (`utils/convert.py` maps a flax
tree onto it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from visionllm_tpu_torch.models.common import quick_gelu


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


class ClipTextLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, hidden: torch.Tensor, causal: torch.Tensor
                ) -> torch.Tensor:
        """hidden [B, L, D]; causal [L, L] bool, True = attend."""
        B, L, D = hidden.shape
        h = self.cfg.num_heads
        x = self.layer_norm1(hidden)
        q, k, v = (proj(x).reshape(B, L, h, D // h)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores * ((D // h) ** -0.5)
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
        hidden = hidden + self.out_proj(attn)
        x = self.fc2(quick_gelu(self.fc1(self.layer_norm2(hidden))))
        return hidden + x


class ClipTextModel(nn.Module):
    """input_ids [B, L <= 77] -> the last hidden state [B, L, 768] after
    the final LayerNorm."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ClipTextLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)[None]
        hidden = self.token_embedding(input_ids) + self.position_embedding(pos)
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=input_ids.device).tril()
        for i in range(self.cfg.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, causal)
        return self.final_layer_norm(hidden)
