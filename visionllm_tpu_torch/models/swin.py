"""Swin Transformer backbone (Swin-T default, Swin-L preset) for the det
and pose decoders.

Counterpart of `visionllm_tpu/models/swin.py`: NHWC at the public
functions; per-stage pre-downsample features with a per-stage LayerNorm;
windows always partitioned (HF `always_partition=True`): the shift is
applied regardless of grid size and small grids are padded, never
window-shrunk. Window attention is explicit matmul + softmax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    out_stages: Tuple[int, ...] = (1, 2, 3)

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


def swin_tiny_config(**kw) -> SwinConfig:
    return SwinConfig(**kw)


def swin_large_config(**kw) -> SwinConfig:
    """Swin-L (JAX `swin.py:49-53`): embed 192, depths (2, 2, 18, 2),
    heads (6, 12, 24, 48), window 12."""
    base = dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                window_size=12)
    base.update(kw)
    return SwinConfig(**base)


def _rel_pos_index(window: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(pad_h: int, pad_w: int, window: int,
                     shift: int) -> np.ndarray:
    """[nW, w*w, w*w] additive mask (0 / -100) for shifted windows."""
    img = np.zeros((pad_h, pad_w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(pad_h // window, window, pad_w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, window*window, C] (H, W divisible)."""
    B, H, W, Cd = x.shape
    x = x.reshape(B, H // window, window, W // window, window, Cd)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, Cd)


def window_reverse(x: torch.Tensor, window: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    Cd = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, Cd)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, Cd)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shift: int):
        super().__init__()
        self.cfg, self.heads, self.shift = cfg, heads, shift
        w = cfg.window_size
        eps = cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        hidden = int(dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        # index constants, moved to the parameters' device at first use
        self._rel_idx = torch.from_numpy(_rel_pos_index(w).reshape(-1))
        self._masks = {}        # (PH, PW, device) -> shift attention mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.cfg.window_size
        B, H, W, Cd = x.shape
        pad_h = (w - H % w) % w
        pad_w = (w - W % w) % w
        PH, PW = H + pad_h, W + pad_w
        shift = self.shift

        shortcut = x
        xs = self.layernorm_before(x)
        xs = F.pad(xs, (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        windows = window_partition(xs, w)
        nW = (PH // w) * (PW // w)
        hd = Cd // self.heads
        q = self.query(windows).reshape(-1, w * w, self.heads, hd)
        k = self.key(windows).reshape(-1, w * w, self.heads, hd)
        v = self.value(windows).reshape(-1, w * w, self.heads, hd)

        table = self.relative_position_bias_table
        if self._rel_idx.device != table.device:
            self._rel_idx = self._rel_idx.to(table.device)
        bias = table[self._rel_idx].reshape(
            w * w, w * w, self.heads).permute(2, 0, 1)
        scores = torch.matmul(q.transpose(1, 2).float(),
                              k.permute(0, 2, 3, 1).float())
        scores = scores * (hd ** -0.5) + bias[None].float()
        if shift:
            key = (PH, PW, scores.device)
            amask = self._masks.get(key)
            if amask is None:
                amask = torch.from_numpy(
                    _shift_attn_mask(PH, PW, w, shift)).to(scores.device)
                self._masks[key] = amask
            scores = scores.reshape(-1, nW, self.heads, w * w, w * w)
            scores = (scores + amask[None, :, None]).reshape(
                -1, self.heads, w * w, w * w)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v.transpose(1, 2))       # [b, h, q, d]
        attn = self.proj(attn.transpose(1, 2).reshape(-1, w * w, Cd))

        xs = window_reverse(attn, w, B, PH, PW)
        if shift:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        x = shortcut + xs[:, :H, :W]
        xs = self.layernorm_after(x)
        xs = self.fc2(F.gelu(self.fc1(xs), approximate="none"))
        return x + xs


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=cfg.layer_norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, Cd = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """pixel_values [B, H, W, 3] -> the requested stages' features, each
    with its output LayerNorm: list of [B, H_s, W_s, C_s], strides
    4 * 2^s."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=eps)
        for s in range(cfg.num_stages):
            dim = cfg.stage_dim(s)
            for b in range(cfg.depths[s]):
                shift = 0 if b % 2 == 0 else cfg.window_size // 2
                self.add_module(f"stage{s}_block{b}",
                                SwinBlock(cfg, dim, cfg.num_heads[s], shift))
            if s in cfg.out_stages:
                self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=eps))
            if s < cfg.num_stages - 1:
                self.add_module(f"downsample{s}", PatchMerging(cfg, dim))

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        p = cfg.patch_size
        B, H, W, _ = pixel_values.shape
        x = F.pad(pixel_values, (0, 0, 0, (p - W % p) % p, 0, (p - H % p) % p))
        x = x.to(self.patch_embed.weight.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        outputs = []
        for s in range(cfg.num_stages):
            for b in range(cfg.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s in cfg.out_stages:
                outputs.append(getattr(self, f"out_norm{s}")(x))
            if s < cfg.num_stages - 1:
                x = getattr(self, f"downsample{s}")(x)
        return outputs
