"""Load a JAX-package flax parameter tree into the port's modules.

`load_jax_params(module, params)` takes the flax params as nested dicts
of numpy arrays (e.g. `jax.tree.map(np.asarray, variables["params"])`)
and fills the module's parameters. The port names its parameters after
the flax ones, so the map is mechanical:

  * Dense `kernel` [in, out]         -> Linear `weight` [out, in]
  * Conv `kernel` HWIO               -> Conv2d `weight` OIHW (a
    depthwise conv's [K, K, 1, C] -> [C, 1, K, K], as DCNv3's `dw_conv`)
  * Embed `embedding`                -> Embedding `weight`
  * LayerNorm / GroupNorm `scale`    -> `weight`
  * `nn.scan`-stacked `layers/layer/...` (stacked on axis 0)
                                     -> ModuleList `layers.{i}...`
  * int4 `Int4Dense` `kernel_p`, `scale` -> `Int4Linear` buffers of the
    same names and layout, no transpose (a tree packed by the JAX
    `quantize_serving_params(..., bits=4)` loads byte for byte)
  * int8 `Int8Dense` / `Int8ActDense` `kernel_q` [in, out] -> the
    `Int8Linear` / `Int8ActLinear` buffer `kernel_q` [out, in], transposed
    like a Dense kernel (scanned stacks are sliced per layer first);
    `scale` [out] as it is (a tree of the JAX `quantize_serving_params`
    loads byte for byte)
  * LoRA `LoraDense` `kernel`, `lora_a` [in, r], `lora_b` [r, out] ->
    `LoraLinear` `weight` (transposed like a Dense kernel) and the two
    factors in flax's layout, untransposed (`models/lora.py`)
  * every other leaf keeps its name: plain parameters (InternViT's
    `ls1` / `ls2`, class and position embeddings), and modules named by
    index or position (the `internvl_mlp` bridge's "0" / "1" / "3",
    InternImage's `stage{s}_block{b}`).

It raises on any flax leaf that maps to no parameter and on any
parameter that no leaf fills. A model already sharded by
`parallel.mesh.apply_shardings` loads too: each DTensor parameter takes
its shard of the array (every rank passes the whole tree).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor, distribute_tensor

from visionllm_tpu_torch.ops.quant import Int8Linear


def flax_leaf(mod: nn.Module, name: str
              ) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """The flax leaf of `mod`'s parameter `name`: its flax name and
    `axes`, where `axes[j]` is the port's dim of flax dim j (None: the
    same order)."""
    if name == "weight":
        if isinstance(mod, nn.Linear):
            return "kernel", (1, 0)               # [in, out] <- [out, in]
        if isinstance(mod, nn.Conv2d):
            return "kernel", (2, 3, 1, 0)         # HWIO <- OIHW
        if isinstance(mod, nn.Embedding):
            return "embedding", None
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            return "scale", None
    return name, None


def _leaf(mod: nn.Module, name: str, arr: np.ndarray):
    """The port's name and array of `mod`'s flax leaf `name`."""
    if name == "kernel_q" and isinstance(mod, Int8Linear):
        return name, np.swapaxes(arr, -1, -2)
    leaf, axes = flax_leaf(mod, "weight")
    if name == leaf != "weight":
        return "weight", arr if axes is None else arr.transpose(
            np.argsort(axes))
    return name, arr


def _emit(mod: nn.Module, prefix: str, tree: Mapping, out: Dict[str, np.ndarray]):
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            name, arr = _leaf(mod, key, np.asarray(val))
            out[prefix + name] = arr
            continue
        child = mod._modules.get(key)
        if child is None:
            raise KeyError(f"flax subtree {prefix}{key} has no module in the "
                           f"port")
        if isinstance(child, nn.ModuleList):
            if set(val) != {"layer"}:
                raise KeyError(f"{prefix}{key}: expected a scanned "
                               f"'layer' subtree, got {sorted(val)}")
            for i, sub in enumerate(child):
                sliced = _slice(val["layer"], i, len(child), f"{prefix}{key}")
                _emit(sub, f"{prefix}{key}.{i}.", sliced, out)
        else:
            _emit(child, f"{prefix}{key}.", val, out)


def _slice(tree: Mapping, i: int, n: int, where: str) -> Dict:
    res = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            res[k] = _slice(v, i, n, where)
        else:
            v = np.asarray(v)
            if v.shape[0] != n:
                raise ValueError(f"{where}/{k}: stacked axis {v.shape[0]} "
                                 f"!= {n} layers")
            res[k] = v[i]
    return res


@torch.no_grad()
def load_jax_params(module: nn.Module, params: Mapping) -> None:
    """Copy a flax param tree into `module`'s parameters and buffers (cast
    to each one's dtype and device; integer leaves copy exactly). Raises
    on unused or missing keys and on shape mismatches."""
    arrays: Dict[str, np.ndarray] = {}
    _emit(module, "", params, arrays)
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    unused = sorted(set(arrays) - set(own))
    missing = sorted(set(own) - set(arrays))
    if unused or missing:
        raise KeyError(f"flax params do not match the module: unused "
                       f"{unused[:10]}, missing {missing[:10]}")
    for name, arr in arrays.items():
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {arr.shape} vs port "
                             f"{tuple(p.shape)}")
        src = torch.from_numpy(np.array(arr, dtype=np.int64 if np.issubdtype(
            np.asarray(arr).dtype, np.integer) else np.float32))
        if isinstance(p, DTensor):
            src = distribute_tensor(src.to(p.dtype), p.device_mesh,
                                    p.placements)
        p.copy_(src)
