"""Int8 serving quantization: weight-only int8 (w8a16), w8a8 and the int8
KV cache (counterpart of `visionllm_tpu/ops/quant.py`).

* `quantize_int8` is the JAX function bit for bit: per-output-channel
  symmetric scales reduced over the in-features axis, rounded to bf16
  before the division, half-to-even rounding, values clipped to ±127.
* `Int8Linear` (JAX `Int8Dense`) and `Int8ActLinear` (JAX
  `Int8ActDense`) hold the same buffers: `kernel_q` int8 [out, in] (the
  flax kernel transposed, as an `nn.Linear` weight) and `scale` [out]
  (bf16 as quantized; a float32 model holds the same values in float32).
  One quantized tree serves both modes. `Int8Linear` computes the dot of
  `x` with `kernel_q` cast to the model dtype, then multiplies by the
  scale in the model dtype. `Int8ActLinear` quantizes each row of `x`
  (scale `max(|x|)/127` in fp32), accumulates int8 x int8 in int32 and
  scales in fp32 (`acc * sx * scale`), as JAX does.
* `quantize_kv` and `int8_kv_attention` store and read the int8 KV cache
  (per-(token, head) bf16 scales folded into the scores and the
  probabilities).

The Pallas package has no kernel here: JAX computes these products
outside any `pallas_call`. So do these: `F.linear` on the converted
weights, `torch._int_mm` (cuBLAS's int8 GEMM) for the w8a8 product on
CUDA, einsums for the attention. `int8_matmul` is the int32 product with
its CUDA preconditions met: rows padded with zeros to 17 (`_int_mm`
needs M > 16; rows are independent, so this is exact), K and N multiples
of 8 (it raises otherwise). On the CPU it is an int32 matmul.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.lora import LoraLinear
from visionllm_tpu_torch.ops.quant4 import _PROJ_NAMES, quantize_llm_int4

INT_MM_MIN_ROWS = 17       # torch._int_mm on CUDA: M > 16
INT_MM_ALIGN = 8           # ... and K, N multiples of 8


@torch.no_grad()
def quantize_int8(w: torch.Tensor, dim: int = -2):
    """Symmetric per-output-channel int8 quantization of `w`, whose axis
    `dim` is the in-features axis the scale reduces over (-2 for a flax
    kernel [..., in, out]; -1 for a Linear weight [out, in]).

    Returns `(wq int8, scale bf16)`, the scale shaped like `w` without
    `dim`, with `wq * scale ≈ w`."""
    wf = w.float()
    amax = wf.abs().amax(dim=dim)
    # rounded to its bf16 storage dtype BEFORE quantizing, so wq * scale
    # stays within half a step of w
    scale = (amax / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    wq = torch.round(wf / scale.float().unsqueeze(dim)).clamp(-127, 127)
    return wq.to(torch.int8), scale


@torch.no_grad()
def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of a K or V block
    `[..., D]`: the scale reduces over D only. Returns `(x_q int8,
    scale bf16 [...])`."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = (amax / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    xq = torch.round(xf / scale.float()[..., None]).clamp(-127, 127)
    return xq.to(torch.int8), scale


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """`xq [M, K] int8 @ wq [N, K].T -> [M, N] int32`, exact: an int32
    matmul."""
    return xq.to(torch.int32) @ wq.to(torch.int32).t()


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The w8a8 product `xq [M, K] @ wq [N, K].T` accumulated in int32.
    CUDA tensors go through `torch._int_mm` with the rows zero-padded to
    `INT_MM_MIN_ROWS` (sliced back after); K and N must be multiples of
    `INT_MM_ALIGN`. CPU tensors take `int8_matmul_plain`."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq)
    M, K = xq.shape
    N = wq.shape[0]
    if K % INT_MM_ALIGN or N % INT_MM_ALIGN:
        raise ValueError(f"int8_matmul: K={K} and N={N} must be multiples "
                         f"of {INT_MM_ALIGN} for torch._int_mm")
    if M < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - M))
    return torch._int_mm(xq.contiguous(), wq.t())[:M]


class Int8Linear(nn.Module):
    """Drop-in `nn.Linear(bias=False)` with int8-stored weights, the
    counterpart of the JAX `Int8Dense` (weight-only, w8a16)."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("kernel_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.bfloat16, device=device))

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """Quantize an `nn.Linear` into a new module on its device; the
        scale takes the Linear's dtype (bf16 values either way)."""
        w = lin.weight
        mod = cls(w.shape[1], w.shape[0], device=w.device)
        wq, scale = quantize_int8(w, dim=-1)
        mod.kernel_q.copy_(wq)
        mod.scale = scale.to(w.dtype)
        return mod

    @classmethod
    def sharing(cls, other: "Int8Linear") -> "Int8Linear":
        """A module of this class over `other`'s buffers (no copy)."""
        mod = cls(other.in_features, other.out_features, device="meta")
        mod.kernel_q, mod.scale = other.kernel_q, other.scale
        return mod

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.kernel_q.to(x.dtype))
        return y * self.scale.to(x.dtype)


class Int8ActLinear(Int8Linear):
    """w8a8: the JAX `Int8ActDense`. Each row of `x` is quantized to int8
    with a dynamic fp32 scale `sx = max(max|x| / 127, 1e-8)`, the product
    accumulates in int32 (`int8_matmul`), and `acc * sx * scale` is taken
    in fp32, then cast to the model dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.in_features).float()
        sx = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
        xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        acc = int8_matmul(xq, self.kernel_q)
        y = acc.float() * sx * self.scale.float()
        return y.to(x.dtype).reshape(*lead, self.out_features)


def int8_kv_attention(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                      v_q: torch.Tensor, v_s: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention of q [B, Lq, H, D] over an int8 cache (k_q, v_q
    [B, T, H_kv, D] int8; k_s, v_s [B, T, H_kv] bf16) without
    dequantizing it: fp32 scores scaled by `k_s`, then by D**-0.5, masked
    (`mask` broadcastable to [B, H, Lq, T], True = attend) with the fp32
    minimum, an fp32 softmax, the probabilities scaled by `v_s`, then
    cast to q's dtype for the PV product. GQA by repeat."""
    B, Lq, H, D = q.shape
    H_kv = k_q.shape[2]
    if H_kv != H:
        rep = H // H_kv
        k_q, v_q = (t.repeat_interleave(rep, dim=2) for t in (k_q, v_q))
        k_s, v_s = (t.repeat_interleave(rep, dim=2) for t in (k_s, v_s))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_q.float())
    scores = scores * k_s.float().permute(0, 2, 1)[:, :, None, :]
    scores = scores * D ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_s.float().permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype),
                       v_q.to(q.dtype))
    return out.to(q.dtype)


@torch.no_grad()
def quantize_llm_int8(llm: nn.Module, act: bool = False) -> nn.Module:
    """Replace every `{q,k,v,o,gate,up,down}_proj` and `lm_head` Linear of
    a LlamaModel by an `Int8Linear` (`act=True`: an `Int8ActLinear`), in
    place (counterpart of the JAX `quantize_llm_params`); a `LoraLinear`
    stays, as JAX builds LoRA layers whatever `quant` says. One Linear at a
    time is quantized and its weight freed, so the peak is the bf16 tree
    plus one layer. An int8 module of the other mode is re-wrapped over
    its buffers: one quantized tree serves both modes."""
    cls = Int8ActLinear if act else Int8Linear
    for parent in list(llm.modules()):
        for name, child in list(parent.named_children()):
            if name not in _PROJ_NAMES:
                continue
            if isinstance(child, LoraLinear):
                continue          # LoRA wins over quant, as in JAX
            if isinstance(child, nn.Linear):
                if child.bias is not None:
                    raise ValueError(f"{name}: int8 quantization takes "
                                     "Linear without bias")
                setattr(parent, name, cls.from_linear(child))
                # the module list above still holds the Linear: free its
                # weight now, not when the walk ends
                child.weight = None
            elif isinstance(child, Int8Linear) and type(child) is not cls:
                setattr(parent, name, cls.sharing(child))
    return llm


def quantize_serving_params(model: nn.Module, *, bits: int = 8,
                            act: bool = False) -> nn.Module:
    """`quantize_llm_int8` (`bits=8`; `act=True` for w8a8) or
    `quantize_llm_int4` (`bits=4`) applied wherever the LLM lives: a
    composite (`model.core.llm`), a core (`model.llm`) or a bare
    LlamaModel. Returns `model`, quantized in place."""
    llm = model
    if hasattr(model, "core") and hasattr(model.core, "llm"):
        llm = model.core.llm
    elif hasattr(model, "llm"):
        llm = model.llm
    if bits == 4:
        quantize_llm_int4(llm)
    elif bits == 8:
        quantize_llm_int8(llm, act=act)
    else:
        raise ValueError(f"bits={bits}: only 8 and 4")
    return model
