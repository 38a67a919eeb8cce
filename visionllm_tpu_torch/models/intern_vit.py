"""InternViT-6B vision tower, the 26B flagship's encoder.

Counterpart of `visionllm_tpu/models/intern_vit.py`: a CLIP-style ViT
with pre-RMSNorm blocks, a fused qkv projection, QK RMSNorm across the
*concatenated* heads (one norm over all 3200 channels of q, one of k, not
per head), layer-scale residuals (`ls1`, `ls2`: fp32 parameters in JAX,
cast to the compute dtype before the product), class and position
embeddings as plain parameters, no post-embedding norm and a GELU MLP.
It returns every hidden state stacked, as `ClipVisionTower` does, so the
composite reads either. Attention goes through `multi_head_attention`,
so at 448 px (1025 tokens, 25 heads of 128) it takes the flash kernel;
the kernel masks the ragged last key tile itself, where JAX pads to 1152
with segment ids.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from visionllm_tpu_torch.config import VisionEncoderConfig
from visionllm_tpu_torch.models.common import ACT2FN, RMSNorm
from visionllm_tpu_torch.ops.attention import multi_head_attention


class InternVitLayer(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = RMSNorm(D, cfg.layer_norm_eps)
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        if cfg.qk_normalization:
            self.q_norm = RMSNorm(D, cfg.layer_norm_eps)
            self.k_norm = RMSNorm(D, cfg.layer_norm_eps)
        self.proj = nn.Linear(D, D)
        self.ls1 = nn.Parameter(torch.zeros(D))
        self.norm2 = RMSNorm(D, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(D, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, D)
        self.ls2 = nn.Parameter(torch.zeros(D))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, D = hidden.shape
        h = cfg.num_heads
        q, k, v = self.qkv(self.norm1(hidden)).split(D, dim=-1)
        if cfg.qk_normalization:
            q, k = self.q_norm(q), self.k_norm(k)
        attn = multi_head_attention(
            q.reshape(B, L, h, D // h), k.reshape(B, L, h, D // h),
            v.reshape(B, L, h, D // h)).reshape(B, L, D)
        hidden = hidden + self.proj(attn) * self.ls1.to(hidden.dtype)
        x = ACT2FN[cfg.hidden_act](self.fc1(self.norm2(hidden)))
        return hidden + self.fc2(x) * self.ls2.to(hidden.dtype)


class InternVisionTower(nn.Module):
    """pixel_values [B, H, W, 3] (NHWC, normalized) -> all hidden states
    [num_layers + 1, B, 1 + P, D]."""

    def __init__(self, cfg: VisionEncoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, D))
        self.layers = nn.ModuleList(
            InternVitLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        B = pixel_values.shape[0]
        D = self.cfg.hidden_size
        w = self.patch_embedding.weight
        x = pixel_values.to(w.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(w.dtype).expand(B, 1, D)
        hidden = torch.cat([cls, patches], dim=1)
        hidden = hidden + self.position_embedding.to(w.dtype)
        states = [hidden]
        for layer in self.layers:
            hidden = layer(hidden)
            states.append(hidden)
        return torch.stack(states, dim=0)
