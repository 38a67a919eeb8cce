"""The SD-1.5 conditional UNet.

Counterpart of `visionllm_tpu/models/stable_diffusion/unet.py`: the
diffusers UNet2DConditionModel of the reference's [GEN] and [EDIT] heads
(block_out_channels (320, 640, 1280, 1280), 2 resnets a block, one
transformer block per attention with 8 heads, cross_attention_dim 768,
GEGLU feed-forward), sized by `UNetConfig` so one module serves SD-1.5
(in_channels 4) and InstructPix2Pix (in_channels 8). Layers keep the
flax names (`down_{i}_res_{j}`, `down_{i}_attn_{j}`, `mid_attn`,
`up_{i}_upsample`, `time_dense1`, ...) so `utils/convert.py` maps a flax
tree mechanically.

Precision follows flax's per-layer `dtype`: the GroupNorms compute and
return fp32 (their parameters stay fp32 under a bf16 model), every
conv and dense layer runs in its weight's dtype (bf16 on the card), the
LayerNorms keep fp32 parameters, take fp32 statistics and return the
compute dtype, and the attention takes its scores in fp32, its softmax
in fp32 and its PV product in the compute dtype. The API is NHWC, as
JAX's; inside, the maps are NCHW tensors in `MAP_FORMAT`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS, Conv


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8        # heads (SD-1.5 names it this way)
    norm_num_groups: int = 32
    # which down/up blocks carry cross-attention (SD-1.5: all but last)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    freq_shift: int = 0
    flip_sin_to_cos: bool = True


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       freq_shift: int = 0) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers convention (fp32)."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class GroupNorm32(nn.GroupNorm):
    """flax `nn.GroupNorm` without a dtype: fp32 statistics, parameters
    and output whatever the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=...)`: the input cast to the weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=...)`: fp32 parameters (the heads list it
    among their `fp32_modules`) and statistics, the output in the input's
    dtype (the compute dtype)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=FLAX_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> Conv:
    return Conv(cin, cout, 3, stride=stride, padding=padding)


# The memory format of the UNet's and the VAE's maps and conv weights,
# chosen on device time by `tools/sd_layout_probe.py`: on an H100 (80GB
# HBM3, 700 W) a full-width B3 UNet pass takes 40.5 ms in channels_last
# against 43.0 ms in contiguous NCHW (cuDNN's NCHW->NHWC transposes go),
# a 512² VAE decode 31.4 against 25.4 ms; 50 steps outweigh one decode.
# channels_last also makes the API's NHWC <-> NCHW permutes free.
MAP_FORMAT = torch.channels_last


def nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as an NCHW map in `MAP_FORMAT`."""
    return x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=MAP_FORMAT)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, L, heads * d] inputs with JAX's
    roundings: fp32 scores (exact products of the compute-dtype inputs)
    and softmax, probabilities cast to v's dtype before the PV product."""
    B, L, inner = q.shape
    Lk = k.shape[1]
    hd = inner // heads
    q = q.reshape(B, L, heads, hd).transpose(1, 2)
    k = k.reshape(B, Lk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Lk, heads, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(
        hd ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, inner)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(groups, cin, eps=1e-5)
        self.conv1 = conv3x3(cin, cout)
        self.time_emb_proj = Dense(temb_dim, cout)
        self.norm2 = GroupNorm32(groups, cout, eps=1e-5)
        self.conv2 = conv3x3(cout, cout)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        context_dim = context_dim or query_dim
        self.to_q = Dense(query_dim, query_dim, bias=False)
        self.to_k = Dense(context_dim, query_dim, bias=False)
        self.to_v = Dense(context_dim, query_dim, bias=False)
        self.to_out = Dense(query_dim, query_dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        out = scaled_dot_attention(self.to_q(x), self.to_k(context),
                                   self.to_v(context), self.heads)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff_geglu = GEGLU(dim, dim * 4)
        self.ff_out = Dense(dim * 4, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class Transformer2D(nn.Module):
    """GroupNorm -> 1x1 proj_in -> one transformer block -> 1x1 proj_out
    + residual (diffusers Transformer2DModel as SD-1.5 configures it)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 groups: int):
        super().__init__()
        self.norm = GroupNorm32(groups, channels, eps=FLAX_LN_EPS)
        self.proj_in = Conv(channels, channels, 1)
        self.block_0 = BasicTransformerBlock(channels, heads, context_dim)
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = tokens(self.proj_in(self.norm(x)))
        h = self.block_0(h, context)
        h = nchw(h.reshape(B, H, W, C))
        return x + self.proj_out(h)


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        chs, G = cfg.block_out_channels, cfg.norm_num_groups
        ch0 = chs[0]
        temb = ch0 * 4
        heads, ctx = cfg.attention_head_dim, cfg.cross_attention_dim
        self.time_dense1 = Dense(ch0, temb)
        self.time_dense2 = Dense(temb, temb)
        self.conv_in = conv3x3(cfg.in_channels, ch0)
        skip_chs = [ch0]
        cin = ch0
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}",
                                ResnetBlock(cin, ch, temb, G))
                if cfg.cross_attn_blocks[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(ch, heads, ctx, G))
                cin = ch
                skip_chs.append(ch)
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                conv3x3(ch, ch, stride=2))
                skip_chs.append(ch)
        self.mid_res_0 = ResnetBlock(cin, cin, temb, G)
        self.mid_attn = Transformer2D(cin, heads, ctx, G)
        self.mid_res_1 = ResnetBlock(cin, cin, temb, G)
        for i, (ch, cross) in enumerate(zip(reversed(chs),
                                            reversed(cfg.cross_attn_blocks))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock(cin + skip_chs.pop(), ch, temb, G))
                if cross:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, heads, ctx, G))
                cin = ch
            if i < len(chs) - 1:
                self.add_module(f"up_{i}_upsample", conv3x3(ch, ch))
        self.conv_norm_out = GroupNorm32(G, cin, eps=1e-5)
        self.conv_out = conv3x3(cin, cfg.out_channels)
        self.to(memory_format=MAP_FORMAT)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample [B, H, W, C_in], timesteps [B], context [B, 77, 768] ->
        predicted noise [B, H, W, C_out] in the compute dtype."""
        cfg = self.cfg
        chs = cfg.block_out_channels
        dtype = self.conv_in.weight.dtype
        context = encoder_hidden_states.to(dtype)
        temb = timestep_embedding(timesteps, chs[0], cfg.flip_sin_to_cos,
                                  cfg.freq_shift).to(dtype)
        temb = self.time_dense2(F.silu(self.time_dense1(temb)))

        h = self.conv_in(nchw(sample.to(dtype)))
        skips = [h]
        for i in range(len(chs)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.cross_attn_blocks[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i < len(chs) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)

        rev_cross = tuple(reversed(cfg.cross_attn_blocks))
        for i in range(len(chs)):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if rev_cross[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i < len(chs) - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)

