"""Transformer layers of the Grounding-DINO decoder: sine position
embeddings, torch-MHA-compatible attention, the deformable attention
module (routed to the port's MSDA kernel), GLIP-style bi-attention
fusion, the text enhancer and the deformable encoder layer.

Counterpart of `visionllm_tpu/models/grounding_dino/layers.py`. The
attention blocks that are einsum code in JAX are explicit matmul +
softmax here. Norms use flax's default eps 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS
from visionllm_tpu_torch.ops import ms_deform_attn as msda

NEG_INF = torch.finfo(torch.float32).min


def sine_position_embedding(mask: torch.Tensor, dim: int,
                            temperature: float = 20.0) -> torch.Tensor:
    """2D sine embeddings from a validity mask [B, H, W] -> [B, H, W, dim]
    (normalize=True, scale 2π)."""
    m = mask.float()
    y = torch.cumsum(m, 1)
    x = torch.cumsum(m, 2)
    eps = 1e-6
    scale = 2 * math.pi
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     dim=-1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     dim=-1).flatten(-2)
    return torch.cat([py, px], dim=-1)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128,
                       temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """Sine embedding of coordinates: pos [..., n] -> [..., n * F]."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    x = pos[..., None] * scale / dim_t
    emb = torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                      dim=-1).flatten(-2)
    parts = [emb[..., i, :] for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


class TorchMHA(nn.Module):
    """torch nn.MultiheadAttention-compatible attention with separate
    q/k/v projections."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, *, attn_mask=None,
                key_padding_mask=None):
        """attn_mask: bool [Lq, Lk] or [B, Lq, Lk], True = NOT allowed.
        key_padding_mask: bool [B, Lk], True = pad."""
        B, Lq, D = query.shape
        Lk = key.shape[1]
        h, hd = self.num_heads, self.dim // self.num_heads
        q = self.q_proj(query).reshape(B, Lq, h, hd).transpose(1, 2)
        k = self.k_proj(key).reshape(B, Lk, h, hd).transpose(1, 2)
        v = self.v_proj(value).reshape(B, Lk, h, hd).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (hd ** -0.5)
        if attn_mask is not None:
            blocked = attn_mask if attn_mask.ndim == 3 else attn_mask[None]
            scores = scores.masked_fill(blocked[:, None], NEG_INF)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, Lq, D)
        return self.out_proj(out)


class DeformableAttention(nn.Module):
    """Multi-scale deformable attention module."""

    def __init__(self, d_model: int, num_heads: int, num_levels: int,
                 num_points: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        H, L, P = num_heads, num_levels, num_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, H * L * P * 2)
        self.attention_weights = nn.Linear(d_model, H * L * P)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, hidden_states, encoder_hidden_states, *,
                position_embeddings=None, reference_points=None,
                spatial_shapes: Sequence[Tuple[int, int]] = (),
                value_mask=None):
        """hidden_states [B, Q, C]; encoder_hidden_states [B, S, C];
        reference_points [B, Q, L, 2|4]; value_mask [B, S] True = valid."""
        H, L, P = self.num_heads, self.num_levels, self.num_points
        B, Q, C = hidden_states.shape
        S = encoder_hidden_states.shape[1]
        if position_embeddings is not None:
            hidden_states = hidden_states + position_embeddings
        value = self.value_proj(encoder_hidden_states)
        if value_mask is not None:
            value = torch.where(value_mask[..., None], value,
                                torch.zeros_like(value))
        value = value.reshape(B, S, H, C // H)
        # sampling geometry stays fp32 whatever the model dtype
        offsets = self.sampling_offsets(hidden_states).float().reshape(
            B, Q, H, L, P, 2)
        attw = self.attention_weights(hidden_states).float().reshape(
            B, Q, H, L * P)
        attw = torch.softmax(attw, dim=-1).reshape(B, Q, H, L, P)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            norm = torch.tensor([(w, h) for (h, w) in spatial_shapes],
                                dtype=torch.float32, device=ref.device)
            loc = (ref[:, :, None, :, None, :]
                   + offsets / norm[None, None, None, :, None, :])
        else:
            loc = (ref[:, :, None, :, None, :2]
                   + offsets / P * ref[:, :, None, :, None, 2:] * 0.5)
        out = msda.ms_deform_attn(value, spatial_shapes, loc, attw)
        return self.output_proj(out)


class BiMultiHeadAttention(nn.Module):
    """GLIP-style bidirectional image<->text attention: one score matrix,
    max-subtracted and clamped to ±50000, softmaxed over text for the
    vision update and over vision for the text update."""

    def __init__(self, d_model: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.vision_proj = nn.Linear(d_model, embed_dim)
        self.text_proj = nn.Linear(d_model, embed_dim)
        self.values_vision_proj = nn.Linear(d_model, embed_dim)
        self.values_text_proj = nn.Linear(d_model, embed_dim)
        self.out_vision_proj = nn.Linear(embed_dim, d_model)
        self.out_text_proj = nn.Linear(embed_dim, d_model)

    def forward(self, vision, text, *, vision_pad_mask=None,
                text_pad_mask=None):
        """pad masks: True = padding."""
        B, Lv, _ = vision.shape
        Lt = text.shape[1]
        h, hd = self.num_heads, self.embed_dim // self.num_heads
        vq = self.vision_proj(vision) * (hd ** -0.5)
        tk = self.text_proj(text)
        vv = self.values_vision_proj(vision)
        tv = self.values_text_proj(text)
        vq = vq.reshape(B, Lv, h, hd).transpose(1, 2)
        tk = tk.reshape(B, Lt, h, hd).transpose(1, 2)
        vv = vv.reshape(B, Lv, h, hd).transpose(1, 2)
        tv = tv.reshape(B, Lt, h, hd).transpose(1, 2)

        scores = torch.matmul(vq.float(), tk.float().transpose(-1, -2))
        scores = (scores - scores.max()).clamp(-50000, 50000)   # [B,h,Lv,Lt]
        t_scores = scores.transpose(-1, -2)
        t_scores = (t_scores - t_scores.amax(-1, keepdim=True)).clamp(
            -50000, 50000)
        if vision_pad_mask is not None:
            t_scores = t_scores.masked_fill(vision_pad_mask[:, None, None, :],
                                            NEG_INF)
        text_attn = torch.softmax(t_scores, dim=-1)
        if text_pad_mask is not None:
            scores = scores.masked_fill(text_pad_mask[:, None, None, :],
                                        NEG_INF)
        vision_attn = torch.softmax(scores, dim=-1)
        v_out = torch.matmul(vision_attn.to(tv.dtype), tv)
        t_out = torch.matmul(text_attn.to(vv.dtype), vv)
        v_out = v_out.transpose(1, 2).reshape(B, Lv, self.embed_dim)
        t_out = t_out.transpose(1, 2).reshape(B, Lt, self.embed_dim)
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class FusionLayer(nn.Module):
    """Pre-LN bi-attention with layer-scale residuals."""

    def __init__(self, d_model: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.layer_norm_vision = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.layer_norm_text = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.attn = BiMultiHeadAttention(d_model, embed_dim, num_heads)
        self.vision_param = nn.Parameter(torch.full((d_model,), 1e-4))
        self.text_param = nn.Parameter(torch.full((d_model,), 1e-4))

    def forward(self, vision, text, *, vision_pad_mask=None,
                text_pad_mask=None):
        v = self.layer_norm_vision(vision)
        t = self.layer_norm_text(text)
        dv, dt = self.attn(v, t, vision_pad_mask=vision_pad_mask,
                           text_pad_mask=text_pad_mask)
        return v + self.vision_param * dv, t + self.text_param * dt


class TextEnhancerLayer(nn.Module):
    """Text self-attention block, post-LN residuals."""

    def __init__(self, d_model: int, ffn_dim: int, num_heads: int):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.layer_norm_before = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.layer_norm_after = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, text, *, attn_mask=None, position_embeddings=None):
        """attn_mask: bool [B, Lt, Lt], True = NOT allowed."""
        q = text if position_embeddings is None else text + position_embeddings
        attn = self.self_attn(q, q, text, attn_mask=attn_mask)
        text = self.layer_norm_before(text + attn)
        x = self.fc2(F.relu(self.fc1(text)))
        return self.layer_norm_after(text + x)


class DeformableEncoderLayer(nn.Module):
    """Vision deformable self-attention + FFN."""

    def __init__(self, d_model: int, ffn_dim: int, num_heads: int,
                 num_levels: int, num_points: int):
        super().__init__()
        self.self_attn = DeformableAttention(d_model, num_heads, num_levels,
                                             num_points)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, hidden, *, position_embeddings, reference_points,
                spatial_shapes, value_mask=None):
        attn = self.self_attn(hidden, hidden,
                              position_embeddings=position_embeddings,
                              reference_points=reference_points,
                              spatial_shapes=spatial_shapes,
                              value_mask=value_mask)
        hidden = self.self_attn_layer_norm(hidden + attn)
        x = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + x)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-token normalized reference points [B, S, L, 2]; valid_ratios
    [B, L, 2] (w_ratio, h_ratio)."""
    dev = valid_ratios.device
    pts = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, device=dev),
            torch.linspace(0.5, w - 0.5, w, device=dev), indexing="ij")
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        pts.append(torch.stack([rx, ry], dim=-1))
    ref = torch.cat(pts, dim=1)
    return ref[:, :, None] * valid_ratios[:, None]
