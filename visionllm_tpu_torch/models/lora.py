"""LoRA adapters on the LLM's projections (counterpart of
`visionllm_tpu/models/lora.py`, after the reference's wrap_llm_lora:
r 32, alpha 64 on q/k/v/o and gate/up/down).

`LoraLinear` is a bias-free `nn.Linear` (the frozen base weight, torch
layout [out, in]) with the factors `lora_a` [in, r] and `lora_b` [r, out]
in flax's layout; `init_weights` draws `lora_a` from N(0, 0.02) and
zeroes `lora_b`, as flax initializes them, so a fresh adapter adds
nothing. The output is `x W + (x A) B * alpha / r`, every product in the
model dtype as JAX computes it. The parameter paths contain `lora_`, which
the Trainer's freezing matrix never freezes (`train/runner.py`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


class LoraLinear(nn.Linear):
    """`nn.Linear(fin, fout, bias=False)` plus the rank-`rank` update."""

    def __init__(self, fin: int, fout: int, rank: int, alpha: float = 64.0):
        super().__init__(fin, fout, bias=False)
        self.rank, self.alpha = rank, alpha
        self.lora_a = nn.Parameter(torch.zeros(fin, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        return y + (x @ self.lora_a) @ self.lora_b * (self.alpha / self.rank)


def lora_frozen_predicate(path: str) -> bool:
    """Train only the LoRA factors and everything outside the LLM: the
    LLM's other parameters (dotted paths under `core.llm.`) are frozen."""
    if "lora_" in path:
        return False
    return path.startswith("core.llm.")


@torch.no_grad()
def merge_lora_params(state: Dict[str, torch.Tensor], alpha: float = 64.0
                      ) -> Dict[str, torch.Tensor]:
    """A LoRA model's `state_dict` with `lora_a @ lora_b * alpha / r`
    folded into each base `weight` and the factors dropped: the
    state_dict of the same model at `lora_r=0`. The fold is computed in
    fp32 and cast to the weight's dtype."""
    out = {}
    for name, t in state.items():
        if name.endswith((".lora_a", ".lora_b")):
            continue
        base = name[:-len("weight")]
        a, b = state.get(base + "lora_a"), state.get(base + "lora_b")
        if name.endswith("weight") and a is not None and b is not None:
            delta = (a.float() @ b.float()) * (alpha / a.shape[-1])
            t = (t.float() + delta.T).to(t.dtype)
        out[name] = t
    return out

