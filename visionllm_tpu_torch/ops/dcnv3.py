"""DCNv3 (deformable convolution v3), InternImage's core op.

Counterpart of `visionllm_tpu/ops/dcnv3.py`: `dcnv3_core` and the
`DCNv3` module (depthwise conv -> offset and softmax-mask heads ->
sampling -> output projection). DCNv3's sampling is single-level
multi-scale deformable attention with the groups as heads and the
softmaxed modulation mask as the attention weights, so the core hands it
to `ops.ms_deform_attn.ms_deform_attn`: the MSDA CUDA kernel
(`csrc/ms_deform_attn_fwd.cu`) for CUDA tensors, its plain version for
CPU ones. The value is the zero-padded input [N, (H+2p)(W+2p), G, C/G]
at the one level (H+2p, W+2p); the locations are normalized over that
padded extent. (On the TPU the JAX package runs the same function
through its quad-row gather, which reaches no Pallas kernel.)

The kernel takes fp32 locations and weights. JAX softmaxes the mask in
fp32 and rounds it to the compute dtype before sampling; the module does
the same, and the core widens the rounded mask to fp32, so the kernel
weighs the samples by the values JAX weighs them by.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS
from visionllm_tpu_torch.ops import ms_deform_attn as msda


@functools.lru_cache(maxsize=64)
def _tap_locations(H_in: int, W_in: int, H_out: int, W_out: int,
                   kernel: int, stride: int, dilation: int,
                   offset_scale: float, device: torch.device):
    """The sampling locations before the offsets, [1, H_out, W_out, 1, P,
    2] fp32 (each output's reference point plus the kernel's taps,
    normalized over the padded extent), and the normalizer (W_in, H_in):
    built once per geometry and device, so a call copies nothing from
    the host."""
    P = kernel * kernel
    base = (dilation * (kernel - 1)) // 2 + 0.5
    ry = (base + np.arange(H_out) * stride) / H_in
    rx = (base + np.arange(W_out) * stride) / W_in
    ref = np.stack(np.meshgrid(rx, ry, indexing="xy"), -1)  # [H_out,W_out,2]
    # the kernel's taps, normalized, x varying slowest ("ij" over (x, y))
    gx = -((dilation * (kernel - 1)) // 2) + np.arange(kernel) * dilation
    gxx, gyy = np.meshgrid(gx, gx.copy(), indexing="ij")
    grid = np.stack([gxx / W_in, gyy / H_in], -1).reshape(P, 2)
    ref_t = torch.from_numpy(ref.astype(np.float32)).to(device)
    grid_t = torch.from_numpy(grid.astype(np.float32)).to(device)
    loc = (ref_t[None, :, :, None, None]
           + grid_t[None, None, None, None] * offset_scale)
    norm = torch.tensor([W_in, H_in], dtype=torch.float32, device=device)
    return loc, norm


def dcnv3_msda_args(x: torch.Tensor, offset: torch.Tensor,
                    mask: torch.Tensor, *, kernel: int = 3, stride: int = 1,
                    pad: int = 1, dilation: int = 1, group: int = 4,
                    offset_scale: float = 1.0):
    """The MSDA arguments of a DCNv3 sampling: (value [N, S, G, C/G] in
    x's dtype, ((H_in, W_in),), locations [N, Q, G, 1, P, 2] fp32,
    weights [N, Q, G, 1, P] fp32) and the output's (H_out, W_out)."""
    N, H, W, C = x.shape
    gc = C // group
    P = kernel * kernel
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    H_in, W_in = H + 2 * pad, W + 2 * pad
    H_out = (H_in - (dilation * (kernel - 1) + 1)) // stride + 1
    W_out = (W_in - (dilation * (kernel - 1) + 1)) // stride + 1

    loc, norm = _tap_locations(H_in, W_in, H_out, W_out, kernel, stride,
                               dilation, offset_scale, x.device)
    off = offset.float().reshape(N, H_out, W_out, group, P, 2)
    loc = loc + off * offset_scale / norm

    Q = H_out * W_out
    value = xp.reshape(N, H_in * W_in, group, gc)
    sampling = loc.reshape(N, Q, group, 1, P, 2)
    weights = mask.float().reshape(N, Q, group, 1, P)
    return (value, ((H_in, W_in),), sampling, weights), (H_out, W_out)


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, *,
               kernel: int = 3, stride: int = 1, pad: int = 1,
               dilation: int = 1, group: int = 4,
               offset_scale: float = 1.0) -> torch.Tensor:
    """x [N, H, W, C] (unpadded), offset [N, H_out, W_out, G*P*2] (x, y
    in pixels), mask [N, H_out, W_out, G*P] (softmaxed) -> [N, H_out,
    W_out, C] in x's dtype, sampled by `ms_deform_attn`."""
    args, (H_out, W_out) = dcnv3_msda_args(
        x, offset, mask, kernel=kernel, stride=stride, pad=pad,
        dilation=dilation, group=group, offset_scale=offset_scale)
    out = msda.ms_deform_attn(*args)
    return out.reshape(x.shape[0], H_out, W_out, x.shape[3])


class DCNv3(nn.Module):
    """The DCNv3 module on NHWC input: `input_proj`, the depthwise
    `dw_conv` (`groups=channels`) with `dw_norm` and GELU, the `offset`
    and `mask` heads, `dcnv3_core`, `output_proj`."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dilation: int = 1, group: int = 4,
                 offset_scale: float = 1.0):
        super().__init__()
        self.kernel, self.stride, self.pad = kernel, stride, pad
        self.dilation, self.group = dilation, group
        self.offset_scale = offset_scale
        P = kernel * kernel
        self.input_proj = nn.Linear(channels, channels)
        self.dw_conv = nn.Conv2d(channels, channels, kernel,
                                 padding=(kernel - 1) // 2, groups=channels)
        self.dw_norm = nn.LayerNorm(channels, eps=FLAX_LN_EPS)
        self.offset = nn.Linear(channels, group * P * 2)
        self.mask = nn.Linear(channels, group * P)
        self.output_proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        G, P = self.group, self.kernel * self.kernel
        proj_in = self.input_proj(x)
        dw = self.dw_conv(proj_in.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dw = F.gelu(self.dw_norm(dw), approximate="none")
        offset = self.offset(dw)
        mask = self.mask(dw)
        B, H, W, _ = mask.shape
        mask = torch.softmax(mask.reshape(B, H, W, G, P).float(), dim=-1)
        mask = mask.reshape(B, H, W, G * P).to(proj_in.dtype)
        out = dcnv3_core(proj_in, offset, mask, kernel=self.kernel,
                         stride=self.stride, pad=self.pad,
                         dilation=self.dilation, group=G,
                         offset_scale=self.offset_scale)
        return self.output_proj(out)
