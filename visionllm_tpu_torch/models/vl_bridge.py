"""Vision -> language bridge (counterpart of
`visionllm_tpu/models/vl_bridge.py`): "linear" and "mlpNx_gelu" (N
Linear layers with exact GELU between; mlp2x_gelu for the 7B model).
The Linear modules keep the torch Sequential indices "0", "2", ... that
the flax module is named after."""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F


class VLBridge(nn.Module):
    def __init__(self, bridge_type: str, in_dim: int, out_dim: int):
        super().__init__()
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
        x = self._modules["0"](x)
        for i in range(1, self.depth):
            x = self._modules[str(2 * i)](F.gelu(x, approximate="none"))
        return x
