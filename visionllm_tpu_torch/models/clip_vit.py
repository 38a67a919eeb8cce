"""CLIP-ViT vision tower (ViT-L/14-336 default).

Counterpart of `visionllm_tpu/models/clip_vit.py`: returns every hidden
state stacked like HF's `hidden_states` (entry 0 = embeddings output,
entry i = output of layer i); the bridge reads `output_layer` (-2). The
layer stack is a ModuleList `layers` (the flax tree stacks it on axis 0
under `layers/layer`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from visionllm_tpu_torch.config import VisionEncoderConfig
from visionllm_tpu_torch.models.common import ACT2FN
from visionllm_tpu_torch.ops.attention import multi_head_attention


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.layer_norm2 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(D, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, D)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        B, L, D = hidden.shape
        h = self.cfg.num_heads
        x = self.layer_norm1(hidden)
        q = self.q_proj(x).reshape(B, L, h, D // h)
        k = self.k_proj(x).reshape(B, L, h, D // h)
        v = self.v_proj(x).reshape(B, L, h, D // h)
        attn = multi_head_attention(q, k, v).reshape(B, L, D)
        hidden = hidden + self.out_proj(attn)
        x = self.layer_norm2(hidden)
        x = ACT2FN[self.cfg.hidden_act](self.fc1(x))
        return hidden + self.fc2(x)


class ClipVisionTower(nn.Module):
    """pixel_values [B, H, W, 3] (NHWC, CLIP-normalized) -> all hidden
    states [num_layers + 1, B, 1 + P, D]."""

    def __init__(self, cfg: VisionEncoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, D)
        self.pre_layrnorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            ClipEncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        B = pixel_values.shape[0]
        D = self.cfg.hidden_size
        w = self.patch_embedding.weight
        x = pixel_values.to(w.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(w.dtype).expand(B, 1, D)
        hidden = torch.cat([cls, patches], dim=1)
        hidden = hidden + self.position_embedding.weight[None]
        hidden = self.pre_layrnorm(hidden)
        states = [hidden]
        for layer in self.layers:
            hidden = layer(hidden)
            states.append(hidden)
        return torch.stack(states, dim=0)
