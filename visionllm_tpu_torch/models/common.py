"""Shared building blocks: RMSNorm, rotary embeddings, flax's dtype-casting
conv, MLPs, and the seeded random init used when no checkpoint is loaded.

Counterpart of `visionllm_tpu/models/common.py`. Parameter names follow
the flax ones so `utils/convert.py` maps a flax tree mechanically.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


# flax's nn.LayerNorm and nn.GroupNorm epsilon (torch's default is 1e-5)
FLAX_LN_EPS = 1e-6


class RMSNorm(nn.Module):
    """apex FusedRMSNorm numerics: fp32 variance, then cast back."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(-1, keepdim=True)
        normed = xf * torch.rsqrt(var + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACT2FN: dict = {
    "gelu": F.gelu,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables, HF-LLaMA convention (half-split rotate_half).
    positions: [B, L] int -> cos, sin [B, L, head_dim]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, L, H, D], k [B, L, H_kv, D], cos/sin [B, L, D]."""
    cos_b = cos[:, :, None, :]
    sin_b = sin[:, :, None, :]
    q_out = q * cos_b + _rotate_half(q) * sin_b
    k_out = k * cos_b + _rotate_half(k) * sin_b
    return q_out.to(q.dtype), k_out.to(k.dtype)


class Conv(nn.Conv2d):
    """flax `nn.Conv(dtype=...)`: the input cast to the weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class MLP(nn.Module):
    """N-layer MLP head (DETR-style), ReLU between layers; Linear i is
    named `layers_{i}` like the flax module."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


# plain parameters whose flax initializer is not normal(0.02)
_PARAM_INIT = {
    "vision_param": ("const", 1e-4),
    "text_param": ("const", 1e-4),
    "level_embed": ("normal", 1.0),
    "query_position_embeddings": ("normal", 1.0),
    "tgt_embed": ("normal", 1.0),
    "hw": ("normal", 1.0),
    "hw_append": ("normal", 1.0),
    "ls1": ("const", 0.1),            # InternViT layer scale
    "ls2": ("const", 0.1),
    "mapper_queries": ("normal", 1.0),   # the LLM2SD mapper's queries
    "lora_b": ("const", 0.0),         # a fresh LoRA adapter adds nothing
}


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of every parameter, in `named_parameters`
    order: norms to (1, 0), Linear/Conv weights lecun-normal (flax's
    default, std 1/sqrt(fan_in)) with zero bias, embeddings and plain
    parameters (a `LoraLinear`'s factors too) as their flax
    initializers."""
    for mod in module.modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
            own["weight"].fill_(1.0)
            if "bias" in own:
                own["bias"].zero_()
            continue
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = own["weight"]
            fan_in = w[0].numel()
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if own.get("bias") is not None:
                own["bias"].zero_()
            own = {n: p for n, p in own.items() if n not in ("weight", "bias")}
        for name, p in own.items():
            kind, val = _PARAM_INIT.get(name, ("normal", 0.02))
            if kind == "const":
                p.fill_(val)
            else:
                p.normal_(0.0, val, generator=generator)
