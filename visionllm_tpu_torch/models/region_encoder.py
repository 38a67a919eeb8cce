"""Region (visual-prompt) encoder: a binary mask and its image to one LLM
token (counterpart of `visionllm_tpu/models/region_encoder.py`).

concat(RGB, mask) -> a conv stem to the ViT's patch stride (k = p / 2
with stride k, then 2x2 stride 2, then 1x1, with channel LayerNorms and
exact GELUs) -> the last three ViT feature levels added one by one ->
each accumulated map pooled over the region -> `up_dim` (ViT width to
LLM width), averaged over the levels.

The pooling is the JAX package's closed form of the reference's
random-point estimator: the mean of bilinear reads at every in-mask
pixel, sum_cells f * w / n with w = A_y^T . mask . A_x (A_y [H, h_f] and
A_x [W, w_f] hold each pixel's bilinear weights onto feature cells under
y_f = y * h_f / H - 0.5, zero outside the map) and n the mask's pixel
count, clamped at 1. Weight that falls outside the map is lost from the
numerator only, as the reference's zero-padded grid_sample loses it. Two
small matmuls per region, no random draw.

Precision as flax's: the convs and `up_dim` compute in the weights'
dtype (bf16 in a bf16 model), `LayerNorm2d` takes fp32 statistics and
fp32 parameters (the model lists it among its `fp32_modules`) and
returns the input's dtype, the level sums stay in the conv's dtype, the
pooling is an fp32 product, and the mean over levels sums in fp32.

I/O is the JAX layout, `images` [N, H, W, 3] NHWC; the stem runs on the
channels_last view of it (one permute, no copy).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import RegionEncoderConfig
from visionllm_tpu_torch.models.common import FLAX_LN_EPS, Conv


class LayerNorm2d(nn.LayerNorm):
    """Channel LayerNorm of an NCHW map (the reference's LayerNorm2d, eps
    1e-6): fp32 statistics, the fp32 `weight` / `bias`, the output in the
    input's dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=FLAX_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(1, keepdim=True)
        s = (xf - u).pow(2).mean(1, keepdim=True)
        out = (xf - u) / torch.sqrt(s + self.eps)
        w = self.weight.float()[:, None, None]
        b = self.bias.float()[:, None, None]
        return (out * w + b).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _bilinear_adjoint_matrix(in_size: int, out_size: int) -> np.ndarray:
    """A [in_size, out_size]: row i holds input pixel i's bilinear
    weights onto output cells under y_f = i * out_size / in_size - 0.5
    (the reference's grid_sample(2 * (i / in) - 1, align_corners=False)).
    Cached, so read-only."""
    A = np.zeros((in_size, out_size), dtype=np.float32)
    for i in range(in_size):
        yf = i * out_size / in_size - 0.5
        y0 = int(np.floor(yf))
        f = yf - y0
        for c, w in ((y0, 1 - f), (y0 + 1, f)):
            if 0 <= c < out_size:
                A[i, c] = w
    A.setflags(write=False)
    return A


def pooling_weights(masks: torch.Tensor, hf: int, wf: int) -> torch.Tensor:
    """masks [N, H, W] -> fp32 weights [N, hf, wf] of the closed-form
    pooling: A_y^T . mask . A_x over the mask's pixel count (at least
    1)."""
    _, H, W = masks.shape
    dev = masks.device
    Ay = torch.tensor(_bilinear_adjoint_matrix(H, hf), device=dev)
    Ax = torch.tensor(_bilinear_adjoint_matrix(W, wf), device=dev)
    m = masks.float()
    wmap = Ay.t() @ m @ Ax
    denom = m.sum((1, 2)).clamp(min=1.0)[:, None, None]
    return wmap / denom


class RegionEncoder(nn.Module):
    """(images [N, H, W, 3], masks [N, H, W], three ViT levels
    [N, P, embed_dim] with P = (H / patch)^2) -> [N, out_dim]."""

    def __init__(self, cfg: RegionEncoderConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.patch_size // 2
        self.stem_conv0 = Conv(4, cfg.hidden_dim // 4, k, stride=k)
        self.stem_norm0 = LayerNorm2d(cfg.hidden_dim // 4)
        self.stem_conv1 = Conv(cfg.hidden_dim // 4, cfg.hidden_dim, 2,
                               stride=2)
        self.stem_norm1 = LayerNorm2d(cfg.hidden_dim)
        self.stem_conv2 = Conv(cfg.hidden_dim, cfg.embed_dim, 1)
        self.up_dim = nn.Linear(cfg.embed_dim, cfg.out_dim)

    def forward(self, images: torch.Tensor, masks: torch.Tensor,
                image_features: Sequence[torch.Tensor]) -> torch.Tensor:
        N, H, W, _ = images.shape
        p = self.cfg.patch_size
        if H % p or W % p:
            # flax's SAME padding pads nothing only at multiples of the
            # patch, and the level maps need the ViT's patch grid
            raise ValueError(f"region encoder: image {H}x{W} is not a "
                             f"multiple of the patch size {p}")
        # the mask-embedding stem, on the channels_last view of the input
        x = torch.cat([images, masks[..., None].to(images.dtype)], dim=-1)
        x = x.permute(0, 3, 1, 2)
        x = F.gelu(self.stem_norm0(self.stem_conv0(x)))
        x = F.gelu(self.stem_norm1(self.stem_conv1(x)))
        acc = self.stem_conv2(x)                  # [N, embed_dim, H/p, W/p]
        hf, wf = acc.shape[2], acc.shape[3]
        wmap = pooling_weights(masks, hf, wf).flatten(1)[..., None]
        w = self.up_dim.weight
        outs = []
        for feats in image_features:
            f = feats.reshape(N, hf, wf, -1).permute(0, 3, 1, 2)
            acc = acc + f.to(acc.dtype)               # level accumulation
            pooled = (acc.float().flatten(2) @ wmap)[..., 0]      # [N, C]
            outs.append(self.up_dim(pooled.to(w.dtype)))
        return torch.stack(outs).float().mean(0).to(w.dtype)
