"""Training checkpoints and the npz parameter interchange (counterpart of
`visionllm_tpu/utils/checkpoint.py`).

A checkpoint is one directory a step under `ckpt_dir`, named by the step
as orbax names them (`ckpt_dir/<step>/`), the last `max_to_keep` kept. It
holds `state.pt`: a `torch.save` of a dict of tensors and plain values
(the Trainer's fp32 masters of the trainable parameters, LoRA factors
included, AdamW moments, step, the gradient accumulation's micro-step,
applied steps and fp32 running mean, generator state and sampler
position), read back with `weights_only=True`. It is written to a
temporary directory and renamed into place, so a reader never sees half
a checkpoint. This is not orbax's format: a JAX checkpoint does not load
here (the npz files below are the interchange).

`save_params_npz` / `load_params_npz` keep the JAX package's flat
"a/b/c" key layout, so an npz saved by the JAX package loads into the
port through `utils/convert.py:load_jax_params`, and one saved here loads
in the JAX package.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if re.match(r"^\d+$", d)
                  and os.path.exists(os.path.join(ckpt_dir, d, STATE_FILE)))


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    max_to_keep: int = 3) -> str:
    """Write `state` (tensors moved to the CPU) as `ckpt_dir/<step>/`
    and drop all but the newest `max_to_keep` steps. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None
                       ) -> Dict[str, Any]:
    """The state dict of `step` (the latest when None), on the CPU, its
    tensors mapped from the file (read as they are copied, not first
    loaded whole: a checkpoint of the 7B flagship's tools is 12.7 GB)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                      map_location="cpu", weights_only=True, mmap=True)


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Mapping):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _flatten(v, name, out)
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[name] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[name] = np.asarray(v)


def save_params_npz(path: str, params: Mapping) -> None:
    """A nested dict of arrays (numpy or tensors; bf16 tensors are
    widened to fp32, numpy has no bf16) as one npz keyed "a/b/c"."""
    out: Dict[str, np.ndarray] = {}
    _flatten(params, "", out)
    np.savez(path, **out)


def load_params_npz(path: str) -> Dict[str, Any]:
    """Inverse of `save_params_npz`: the nested dict of numpy arrays."""
    flat = np.load(path)
    root: Dict[str, Any] = {}
    for name in flat.files:
        parts = name.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = flat[name]
    return root


def merge_param_trees(a: Mapping, b: Mapping) -> Dict[str, Any]:
    """Recursive union of two param dicts (e.g. a tree initialized for
    det and one for pose of the same composite): shared leaves from `a`,
    the rest from whichever has them."""
    out = dict(a)
    for k, v in b.items():
        out[k] = merge_param_trees(out[k], v) if (
            k in out and isinstance(v, Mapping)) else out.get(k, v)
    return out
