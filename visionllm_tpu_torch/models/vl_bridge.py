"""Vision -> language bridge (counterpart of
`visionllm_tpu/models/vl_bridge.py`): "linear", "internvl_mlp" (LayerNorm,
Linear, exact GELU, Linear: the 26B model's) and "mlpNx_gelu" (N Linear
layers with exact GELU between; mlp2x_gelu for the 7B model). The
modules keep the torch Sequential indices ("0", "2", ... and "0", "1",
"3") that the flax module is named after. `pixel_shuffle` is the 26B
model's token reduction before the bridge."""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.models.common import FLAX_LN_EPS


class VLBridge(nn.Module):
    def __init__(self, bridge_type: str, in_dim: int, out_dim: int):
        super().__init__()
        self.internvl = bridge_type in ("internvl_mlp", "internvl")
        if self.internvl:
            self.add_module("0", nn.LayerNorm(in_dim, eps=FLAX_LN_EPS))
            self.add_module("1", nn.Linear(in_dim, out_dim))
            self.add_module("3", nn.Linear(out_dim, out_dim))
            return
        if bridge_type == "linear":
            depth = 1
        else:
            m = re.match(r"^mlp(\d+)x_gelu*", bridge_type)
            if not m:
                raise NotImplementedError(
                    f"vl_bridge_type {bridge_type!r} not supported")
            depth = int(m.group(1))
        self.depth = depth
        self.add_module("0", nn.Linear(in_dim, out_dim))
        for i in range(1, depth):
            self.add_module(str(2 * i), nn.Linear(out_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = self._modules
        if self.internvl:
            x = mods["1"](mods["0"](x))
            return mods["3"](F.gelu(x, approximate="none"))
        x = mods["0"](x)
        for i in range(1, self.depth):
            x = mods[str(2 * i)](F.gelu(x, approximate="none"))
        return x


def pixel_shuffle(x: torch.Tensor, scale_factor: float = 0.5
                  ) -> torch.Tensor:
    """Token-reduction pixel shuffle, [B, H, W, C] -> [B, H*s, W*s,
    C/(s*s)]: at s = 0.5 a quarter of the tokens. The JAX reshape and
    transpose order, step for step."""
    B, H, W, C = x.shape
    s = scale_factor
    x = x.reshape(B, H, int(W * s), int(C / s))
    x = x.permute(0, 2, 1, 3)                      # [B, W*s, H, C/s]
    x = x.reshape(B, int(W * s), int(H * s), int(C / (s * s)))
    return x.permute(0, 2, 1, 3)                   # [B, H*s, W*s, C/s^2]
