"""AutoencoderKL, the SD-1.5 VAE.

Counterpart of `visionllm_tpu/models/stable_diffusion/vae.py`: the
diffusers AutoencoderKL of the reference (block_out_channels (128, 256,
512, 512), 2 resnets per encoder block and 3 per decoder block, one mid
attention, latent channels 4, scaling_factor 0.18215). Precision and
layout as in `unet.py`: fp32 GroupNorms (eps 1e-6), convs and dense
layers in their weight's dtype, NHWC at the API, NCHW maps inside in
`unet.MAP_FORMAT`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS
from visionllm_tpu_torch.models.stable_diffusion.unet import (
    MAP_FORMAT, Conv, Dense, GroupNorm32, conv3x3, nchw,
    scaled_dot_attention, tokens)


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(groups, cin, eps=FLAX_LN_EPS)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm32(groups, cout, eps=FLAX_LN_EPS)
        self.conv2 = conv3x3(cout, cout)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """One-head self-attention over the map's H*W tokens."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm32(groups, channels, eps=FLAX_LN_EPS)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = tokens(self.group_norm(x))
        out = self.to_out(scaled_dot_attention(
            self.to_q(h), self.to_k(h), self.to_v(h), 1))
        return x + nchw(out.reshape(B, H, W, C))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chs, G = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, chs[0])
        cin = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(cin, ch, G))
                cin = ch
            if i < len(chs) - 1:
                # diffusers pads (0, 1) on H and W, then a VALID stride 2
                self.add_module(f"down_{i}_downsample",
                                conv3x3(ch, ch, stride=2, padding=0))
        self.mid_res_0 = VAEResnet(cin, cin, G)
        self.mid_attn = VAEAttention(cin, G)
        self.mid_res_1 = VAEResnet(cin, cin, G)
        self.conv_norm_out = GroupNorm32(G, cin, eps=FLAX_LN_EPS)
        self.conv_out = conv3x3(cin, 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW map of the image in the compute dtype."""
        cfg = self.cfg
        h = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chs, G = cfg.block_out_channels, cfg.norm_num_groups
        cin = chs[-1]
        self.conv_in = conv3x3(cfg.latent_channels, cin)
        self.mid_res_0 = VAEResnet(cin, cin, G)
        self.mid_attn = VAEAttention(cin, G)
        self.mid_res_1 = VAEResnet(cin, cin, G)
        for i, ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(cin, ch, G))
                cin = ch
            if i < len(chs) - 1:
                self.add_module(f"up_{i}_upsample", conv3x3(ch, ch))
        self.conv_norm_out = GroupNorm32(G, cin, eps=FLAX_LN_EPS)
        self.conv_out = conv3x3(cin, cfg.in_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: NCHW latent map in the compute dtype."""
        cfg = self.cfg
        h = self.conv_in(z)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * cfg.latent_channels,
                               2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1)
        self.to(memory_format=MAP_FORMAT)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image [B, H, W, 3] -> latent [B, H/8, W/8, 4], scaled by
        scaling_factor: the posterior mean, or with a `generator` a sample
        of the posterior (fp32 standard normal noise drawn from it; a test
        may pass the `noise` [B, H/8, W/8, 4] itself)."""
        h = self.encoder(nchw(x.to(self.encoder.conv_in.weight.dtype)))
        mean, logvar = self.quant_conv(h).permute(0, 2, 3, 1).chunk(2, -1)
        if generator is not None and noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                dtype=torch.float32, device=mean.device)
        if noise is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
            mean = mean + (std * noise).to(mean.dtype)
        return mean * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent [B, h, w, 4] (scaled) -> image [B, 8h, 8w, 3] in the
        compute dtype."""
        z = nchw(z.to(self.decoder.conv_in.weight.dtype)
                 / self.cfg.scaling_factor)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
