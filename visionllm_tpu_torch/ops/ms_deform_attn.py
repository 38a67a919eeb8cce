"""Multi-scale deformable attention (MSDA), the gather op of every
Grounding-DINO encoder and decoder layer.

Counterpart of `visionllm_tpu/ops/ms_deform_attn.py`. For each (query,
head, level, point), bilinearly sample `value` at a normalized location
and take the attention-weighted sum over all (level, point) samples.
Sampling follows `grid_sample(bilinear, zeros, align_corners=False)`:
the pixel coordinate of a location t is `t * extent - 0.5`, and
out-of-bounds corners contribute zero. Locations, weights and the sum
are fp32 whatever the value dtype.

`ms_deform_attn` launches the CUDA kernel `csrc/ms_deform_attn_fwd.cu`
(which replaces the Pallas TPU kernel `_msda_kernel`) for CUDA tensors,
at any size, or raises; it runs the plain version only for CPU tensors.
Under grad mode, with an input that requires grad, it is the autograd
function `MSDeformAttnFn`, whose backward launches
`csrc/ms_deform_attn_bwd.cu` through `ms_deform_attn_bwd`: the gradients
of value, locations and weights in the convention of the JAX
`ms_deform_attn_reference` (autodiff through its gathers), whose plain
version is autograd of `ms_deform_attn_plain`.

Arrays (B=batch, S=sum of level sizes, H=heads, D=head dim, Q=queries,
L=levels, P=points):
  value:              [B, S, H, D]
  sampling_locations: [B, Q, H, L, P, 2]   (x, y), nominally in [0, 1]
  attention_weights:  [B, Q, H, L, P]
  returns:            [B, Q, H * D]
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from visionllm_tpu_torch.kernels.build import check, library

MAX_LEVELS = 8


def _bilinear_gather_level(value_l, loc, height, width):
    """value_l [B, H, HW, D] f32, loc [B, Q, H, P, 2] f32 ->
    [B, H, Q, P, D]: explicit corner gathers, as the JAX reference."""
    B, nH, _, D = value_l.shape
    Q, P = loc.shape[1], loc.shape[3]
    x = loc[..., 0] * width - 0.5                     # [B, Q, H, P]
    y = loc[..., 1] * height - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    out = value_l.new_zeros(B, nH, Q, P, D)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            w = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
            valid = (xi >= 0) & (xi <= width - 1) & (yi >= 0) & (yi <= height - 1)
            # invalid corners read cell 0 with weight 0 (also for
            # non-finite locations, which an int cast would not survive)
            xi_c = torch.where(valid, xi, torch.zeros_like(xi)).long()
            yi_c = torch.where(valid, yi, torch.zeros_like(yi)).long()
            idx = (yi_c * width + xi_c).permute(0, 2, 1, 3).reshape(B, nH, Q * P)
            g = torch.gather(value_l, 2, idx[..., None].expand(-1, -1, -1, D))
            g = g.reshape(B, nH, Q, P, D)
            wv = torch.where(valid, w, torch.zeros_like(w)).permute(0, 2, 1, 3)
            out = out + g * wv[..., None]
    return out


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                         attention_weights):
    """Plain PyTorch port of `ms_deform_attn_reference` (fp32 sums)."""
    B, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    sizes = [h * w for (h, w) in spatial_shapes]
    if sum(sizes) != S or sampling_locations.shape[3] != len(sizes):
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"value {tuple(value.shape)} / locations "
                         f"{tuple(sampling_locations.shape)}")
    loc = sampling_locations.float()
    attw = attention_weights.float()
    out = value.new_zeros(B, H, Q, D, dtype=torch.float32)
    pos = 0
    for lvl, (h_l, w_l) in enumerate(spatial_shapes):
        v_l = value[:, pos:pos + h_l * w_l].float().permute(0, 2, 1, 3)
        pos += h_l * w_l
        sampled = _bilinear_gather_level(v_l, loc[:, :, :, lvl], h_l, w_l)
        w_l_ = attw[:, :, :, lvl].permute(0, 2, 1, 3)          # [B,H,Q,P]
        out = out + (sampled * w_l_[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(value.dtype)


def _check_args(value, spatial_shapes, loc, attw):
    B, S, H, D = value.shape
    Q = loc.shape[1]
    L = len(spatial_shapes)
    P = loc.shape[4]
    if value.dtype != torch.bfloat16:
        raise TypeError(f"ms_deform_attn: value must be bfloat16, got "
                        f"{value.dtype}")
    if loc.dtype != torch.float32 or attw.dtype != torch.float32:
        raise TypeError("ms_deform_attn: locations and weights must be "
                        "float32")
    if not (1 <= L <= MAX_LEVELS):
        raise ValueError(f"ms_deform_attn: {L} levels, at most {MAX_LEVELS}")
    if loc.shape != (B, Q, H, L, P, 2) or attw.shape != (B, Q, H, L, P):
        raise ValueError(f"ms_deform_attn: locations {tuple(loc.shape)} / "
                         f"weights {tuple(attw.shape)} do not match value "
                         f"{tuple(value.shape)} and {L} levels")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"ms_deform_attn: spatial_shapes {spatial_shapes} "
                         f"do not sum to S={S}")
    for t in (loc, attw):
        if t.device != value.device:
            raise ValueError("ms_deform_attn: inputs on different devices")


def _shapes_arg(spatial_shapes):
    L = len(spatial_shapes)
    return (ctypes.c_int * (2 * L))(
        *[int(x) for hw in spatial_shapes for x in hw])


def _launch_fwd(value, spatial_shapes, loc, attw):
    B, S, H, D = value.shape
    Q, L, P = loc.shape[1], len(spatial_shapes), loc.shape[4]
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    fn = library("ms_deform_attn_fwd").ms_deform_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    check(fn(value.data_ptr(), loc.data_ptr(), attw.data_ptr(),
             out.data_ptr(), _shapes_arg(spatial_shapes), B, S, Q, H, D, L,
             P, torch.cuda.current_stream(value.device).cuda_stream),
          "ms_deform_attn_fwd_bf16")
    ms_deform_attn.launches += 1
    return out


class MSDeformAttnFn(torch.autograd.Function):
    """The MSDA kernel with its backward kernel (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attw):
        ctx.save_for_backward(value, loc, attw)
        ctx.spatial_shapes = spatial_shapes
        return _launch_fwd(value, spatial_shapes, loc, attw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        gv, gl, ga = ms_deform_attn_bwd(value, ctx.spatial_shapes, loc, attw,
                                        grad_out)
        return gv, None, gl, ga


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA through the hand-written CUDA kernel (bf16 value, f32
    locations and weights) -> [B, Q, H * D] bf16. CPU tensors take the
    plain version. Under grad mode with an input that requires grad the
    result carries the backward kernel (`MSDeformAttnFn`)."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes,
                                    sampling_locations, attention_weights)
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    args = (value.contiguous(), tuple(tuple(int(x) for x in hw)
                                      for hw in spatial_shapes),
            sampling_locations.contiguous(), attention_weights.contiguous())
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations,
                                      attention_weights)):
        return MSDeformAttnFn.apply(*args)
    return _launch_fwd(*args)


ms_deform_attn.launches = 0


def ms_deform_attn_bwd_plain(value, spatial_shapes, sampling_locations,
                             attention_weights, grad_out):
    """(grad_value, grad_locations, grad_weights) of
    `ms_deform_attn_plain` by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_plain(ins[0], spatial_shapes, ins[1], ins[2])
        return torch.autograd.grad(out, ins, grad_out)


def ms_deform_attn_bwd(value, spatial_shapes, sampling_locations,
                       attention_weights, grad_out):
    """(grad_value bf16, grad_locations f32, grad_weights f32) through the
    backward kernel `csrc/ms_deform_attn_bwd.cu`; `grad_out` is
    [B, Q, H * D] bf16. CPU tensors take `ms_deform_attn_bwd_plain`."""
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_plain(value, spatial_shapes,
                                        sampling_locations,
                                        attention_weights, grad_out)
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = value.shape
    Q, L, P = (sampling_locations.shape[1], len(spatial_shapes),
               sampling_locations.shape[4])
    if grad_out.dtype != torch.bfloat16 or grad_out.shape != (B, Q, H * D):
        raise ValueError(f"ms_deform_attn_bwd: grad_out must be bf16 "
                         f"{(B, Q, H * D)}")
    value, loc, attw, grad_out = (t.contiguous() for t in (
        value, sampling_locations, attention_weights, grad_out))
    gv32 = torch.empty(B, S, H, D, dtype=torch.float32, device=value.device)
    gv = torch.empty_like(value)
    gl = torch.empty_like(loc)
    ga = torch.empty_like(attw)
    fn = library("ms_deform_attn_bwd").ms_deform_attn_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    check(fn(value.data_ptr(), loc.data_ptr(), attw.data_ptr(),
             grad_out.data_ptr(), gv32.data_ptr(), gv.data_ptr(),
             gl.data_ptr(), ga.data_ptr(), _shapes_arg(spatial_shapes), B, S,
             Q, H, D, L, P,
             torch.cuda.current_stream(value.device).cuda_stream),
          "ms_deform_attn_bwd_bf16")
    ms_deform_attn_bwd.launches += 1
    return gv, gl, ga


ms_deform_attn_bwd.launches = 0
