"""InternImage backbone, the 26B flagship's det backbone.

Counterpart of `visionllm_tpu/models/intern_image.py` (InternImage-H:
channels 320, depths (6, 6, 32, 6), groups (10, 20, 40, 80),
res_post_norm). NHWC throughout. A layer is

    x += res_post_norm1(dcn(norm1(x)));  x += res_post_norm2(mlp(norm2(x)))

with `DCNv3` (`ops/dcnv3.py`, sampled by the MSDA CUDA kernel) as its
core op. The stem is two stride-2 3x3 convs with LayerNorm and GELU
between; a stride-2 conv and a LayerNorm downsample between stages; each
stage's output goes through its `out_norm{s}`. The layers keep the flax
names `stage{s}_block{b}`, so `utils.convert.load_jax_params` maps the
tree mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS
from visionllm_tpu_torch.ops.dcnv3 import DCNv3


@dataclass(frozen=True)
class InternImageConfig:
    channels: int = 320
    depths: Tuple[int, ...] = (6, 6, 32, 6)
    groups: Tuple[int, ...] = (10, 20, 40, 80)
    mlp_ratio: float = 4.0
    offset_scale: float = 1.0
    res_post_norm: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)

    def stage_dim(self, i: int) -> int:
        return self.channels * (2 ** i)


def intern_image_h_config(**kw) -> InternImageConfig:
    return InternImageConfig(**kw)


def intern_image_tiny_config(**kw) -> InternImageConfig:
    """The JAX package's test geometry (channels 16)."""
    base = dict(channels=16, depths=(2, 2), groups=(2, 4))
    base.update(kw)
    out = base.pop("out_indices", tuple(range(len(base["depths"]))))
    return InternImageConfig(out_indices=out, **base)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LN_EPS)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class InternImageLayer(nn.Module):
    def __init__(self, channels: int, groups: int, mlp_ratio: float,
                 offset_scale: float, res_post_norm: bool):
        super().__init__()
        self.res_post_norm = res_post_norm
        self.norm1 = _ln(channels)
        self.dcn = DCNv3(channels, group=groups, offset_scale=offset_scale)
        self.norm2 = _ln(channels)
        self.mlp_fc1 = nn.Linear(channels, int(channels * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(channels * mlp_ratio), channels)
        if res_post_norm:
            self.res_post_norm1 = _ln(channels)
            self.res_post_norm2 = _ln(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dcn(self.norm1(x))
        if self.res_post_norm:
            h = self.res_post_norm1(h)
        x = x + h
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        h = self.mlp_fc2(h)
        if self.res_post_norm:
            h = self.res_post_norm2(h)
        return x + h


class InternImage(nn.Module):
    """pixel_values [B, H, W, 3] NHWC -> the stages' normed maps, NHWC,
    at strides 4, 8, 16, 32."""

    def __init__(self, cfg: InternImageConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.stem_conv1 = nn.Conv2d(3, c // 2, 3, stride=2, padding=1)
        self.stem_norm1 = _ln(c // 2)
        self.stem_conv2 = nn.Conv2d(c // 2, c, 3, stride=2, padding=1)
        self.stem_norm2 = _ln(c)
        n = len(cfg.depths)
        for s, depth in enumerate(cfg.depths):
            ch = cfg.stage_dim(s)
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", InternImageLayer(
                    ch, cfg.groups[s], cfg.mlp_ratio, cfg.offset_scale,
                    cfg.res_post_norm))
            if s in cfg.out_indices:
                self.add_module(f"out_norm{s}", _ln(ch))
            if s < n - 1:
                self.add_module(f"downsample{s}", nn.Conv2d(
                    ch, cfg.stage_dim(s + 1), 3, stride=2, padding=1))
                self.add_module(f"downsample_norm{s}",
                                _ln(cfg.stage_dim(s + 1)))

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        x = pixel_values.to(self.stem_conv1.weight.dtype)
        x = F.gelu(self.stem_norm1(_conv_nhwc(self.stem_conv1, x)),
                   approximate="none")
        x = self.stem_norm2(_conv_nhwc(self.stem_conv2, x))
        outs = []
        for s, depth in enumerate(cfg.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s in cfg.out_indices:
                outs.append(getattr(self, f"out_norm{s}")(x))
            if s < len(cfg.depths) - 1:
                x = getattr(self, f"downsample_norm{s}")(
                    _conv_nhwc(getattr(self, f"downsample{s}"), x))
        return outs
