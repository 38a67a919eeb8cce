"""Int4 (w4a16, group-128) weight-only quantization for serving.

Counterpart of `visionllm_tpu/ops/quant4.py`, with the same packed format
so trees packed by either package load into the other: byte `[r, o]` of
the packed kernel holds input rows `r` (low nibble) and `r + in/2` (high
nibble), both signed two's-complement nibbles (-8..7), stored as uint8
viewed as int8; one bf16 scale per (group of G input rows, output column).

`int4_matmul` launches the hand-written CUDA kernel
(`csrc/int4_matmul.cu`, which replaces the Pallas `_int4_kernel`) for CUDA
tensors, or raises; it runs its plain version `int4_matmul_plain` only for
tensors on the CPU. The kernel is one launch a call: each block walks all
of K for its output tile (no split-K, no partial buffer), dequantizes
each packed group in shared memory and runs the products on the tensor
cores (`mma.sync`), taking the groups, their k-steps and the two scale
FMAs in the same order for every tile shape, so a row's result does not
depend on M. Unlike the JAX package, the kernel takes any output width,
so `lm_head` (32096 columns) runs it too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn as nn

from visionllm_tpu_torch.kernels.build import check, library
from visionllm_tpu_torch.models.lora import LoraLinear

GROUP = 128           # input rows per scale group (shrinks for tiny dims)
# the plain version bounds its [rows, groups, N] fp32 partials to about
# this many elements per chunk of rows
_PLAIN_CHUNK_ELEMS = 1 << 28


def group_size(cin: int) -> int:
    """Scale-group length along the input axis: 128, shrunk so it divides
    `cin // 2` (tiny test dims)."""
    g = min(GROUP, cin // 2)
    while (cin // 2) % g:
        g //= 2
    return g


@torch.no_grad()
def pack_int4(w: torch.Tensor):
    """Quantize `w [..., in, out]` to packed int4 + group scales, bit for
    bit as the JAX `pack_int4`: the scale is rounded to bf16 before the
    division, rounding is half-to-even, values clip to -8..7.

    Returns `(wp int8 [..., in/2, out], scale bf16 [..., in/G, out])`."""
    *lead, cin, cout = w.shape
    G = group_size(cin)
    if cin % (2 * G):
        raise ValueError(f"pack_int4: in={cin} not a multiple of 2*{G}")
    g = w.float().reshape(*lead, cin // G, G, cout)
    amax = g.abs().amax(dim=-2)
    scale = (amax / 7.0).clamp_min(1e-8).to(torch.bfloat16)
    q = torch.round(g / scale[..., None, :].float()).clamp(-8, 7)
    q = q.to(torch.int32).reshape(*lead, cin, cout)
    half = cin // 2
    lo = q[..., :half, :] & 0xF
    hi = q[..., half:, :] & 0xF
    wp = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return wp, scale


def int4_matmul_plain(x: torch.Tensor, wp: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Line-for-line port of the JAX `int4_matmul_ref`: split-half signed
    nibbles, per-group fp32 partial dots, each partial scaled once, the
    low-half and high-half sums added. It runs in chunks of rows to bound
    the [rows, groups, N] partials (same arithmetic)."""
    half, cout = wp.shape[-2], wp.shape[-1]
    ngh = scale.shape[-2] // 2
    g = half // ngh
    wi = wp.to(torch.int32)
    lo = ((wi & 0xF) ^ 8) - 8          # signed low nibble
    hi = wi >> 4                       # signed high nibble (arith. shift)
    dt = x.dtype
    sf = scale.float()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    rows = x2.shape[0]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, ngh * cout))
    outs = []
    for i in range(0, max(rows, 1), chunk):
        xc = x2[i:i + chunk]
        acc = None
        for nib, sl, x_off in ((lo, slice(0, ngh), 0),
                               (hi, slice(ngh, 2 * ngh), half)):
            wn = nib.float().reshape(ngh, g, cout)
            xg = xc[:, x_off:x_off + half].float().reshape(-1, ngh, g)
            p = torch.einsum("mng,ngo->mno", xg, wn)
            part = (p * sf[sl]).sum(dim=-2)
            acc = part if acc is None else acc + part
        outs.append(acc.to(dt))
    return torch.cat(outs, 0).reshape(*lead, cout)


def _check_args(x, wp, scale):
    if x.dim() != 2 or wp.dim() != 2 or scale.dim() != 2:
        raise ValueError("int4_matmul: x, wp and scale must be 2-D")
    M, K = x.shape
    half, N = wp.shape
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul: x and scale must be bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    if wp.dtype != torch.int8:
        raise TypeError(f"int4_matmul: wp must be int8, got {wp.dtype}")
    if not (x.device == wp.device == scale.device):
        raise ValueError("int4_matmul: x, wp, scale on different devices")
    if K != 2 * half:
        raise ValueError(f"int4_matmul: x has K={K} but wp packs "
                         f"{2 * half} rows")
    n_groups = scale.shape[0]
    if scale.shape[1] != N or n_groups == 0 or K % n_groups:
        raise ValueError(f"int4_matmul: scale {tuple(scale.shape)} does "
                         f"not fit wp {tuple(wp.shape)}")
    G = K // n_groups
    if K % (2 * G) or G % 16 or not 16 <= G <= GROUP:
        raise ValueError(f"int4_matmul: K={K} must be a multiple of 2*G "
                         f"with G={G} a multiple of 16 up to {GROUP}")
    if x.stride(1) != 1 or not wp.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError("int4_matmul: x needs a unit column stride; wp "
                         "and scale must be contiguous")
    # the kernel copies x in 16-byte chunks
    if x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"int4_matmul: x needs a row stride that is a "
                         f"multiple of 8 elements (got {x.stride(0)}) and "
                         f"a 16-byte aligned pointer")
    return M, K, N, G


@functools.cache
def _entry():
    """The kernel's C entry, its ctypes signature bound once."""
    fn = library("int4_matmul").int4_matmul_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def int4_matmul(x: torch.Tensor, wp: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """`x [M, K] @ dequant(wp, scale) -> [M, N]` through the hand-written
    CUDA kernel: x bf16, wp int8 [K/2, N], scale bf16 [K/G, N]. CPU
    tensors take the plain version. The kernel has no backward (int4
    weights serve, they do not train), so on CUDA an `x` that requires
    grad under grad mode raises instead of returning a detached result."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, wp, scale)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int4_matmul: the int4 kernel has no backward; "
                           "call it under torch.no_grad() or on an input "
                           "that does not require grad")
    M, K, N, G = _check_args(x, wp, scale)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    check(_entry()(x.data_ptr(), x.stride(0), wp.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), M, K, N, G,
                   torch.cuda.current_stream(x.device).cuda_stream),
          "int4_matmul_bf16")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


class Int4Linear(nn.Module):
    """Drop-in `nn.Linear(bias=False)` with packed-int4 weights, the
    counterpart of the JAX `Int4Dense`. Buffers in the flax layout:
    `kernel_p` int8 [in/2, out] and `scale` [in/G, out] (bf16 as packed;
    a float32 model holds the same values in float32). Inputs keep their
    dtype: the LLM already computes in its own."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        G = group_size(in_features)
        self.register_buffer("kernel_p", torch.zeros(
            in_features // 2, out_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            in_features // G, out_features, dtype=torch.bfloat16,
            device=device))

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int4Linear":
        """Pack an `nn.Linear` (weight [out, in]) into a new Int4Linear on
        the same device; the scales take the Linear's dtype."""
        w = lin.weight
        mod = cls(w.shape[1], w.shape[0], device=w.device)
        wp, scale = pack_int4(w.t())
        mod.kernel_p.copy_(wp)
        mod.scale = scale.to(w.dtype)
        return mod

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = int4_matmul(x.reshape(-1, self.in_features), self.kernel_p,
                        self.scale)
        return y.reshape(*lead, self.out_features)


_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj", "lm_head")


@torch.no_grad()
def quantize_llm_int4(llm: nn.Module) -> nn.Module:
    """Replace every `{q,k,v,o,gate,up,down}_proj` and `lm_head` Linear of
    a LlamaModel by an Int4Linear, in place (counterpart of the JAX
    `quantize_llm_params_int4` / `quantize_serving_params(bits=4)`); a
    `LoraLinear` stays, as JAX builds LoRA layers whatever `quant` says. One
    Linear at a time is packed and its weight freed, so a 7B never holds
    both copies of the tree."""
    for parent in list(llm.modules()):
        for name, child in list(parent.named_children()):
            if (name in _PROJ_NAMES and isinstance(child, nn.Linear)
                    and not isinstance(child, LoraLinear)):
                if child.bias is not None:
                    raise ValueError(f"{name}: int4 packing takes Linear "
                                     "without bias")
                setattr(parent, name, Int4Linear.from_linear(child))
                # the module list above still holds the Linear: free its
                # weight now, not when the walk ends
                child.weight = None
    return llm
