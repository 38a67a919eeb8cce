"""Sequence constraints over the "context" mesh axis (counterpart of
`visionllm_tpu/parallel/sequence.py`).

`set_mesh(mesh)` makes a mesh ambient for the code under it, as
`jax.sharding.set_mesh` does. `constrain_seq(x)` then redistributes a
DTensor `x` to split its sequence dim over "context" (and its batch dim
over "data" where that divides), the placement JAX pins with
`with_sharding_constraint`. A plain tensor is returned unchanged, and so
is `x` itself in JAX's no-op cases: no ambient mesh, no "context" axis,
a context size of 1, or a length the axis does not divide. The LLaMA
prefill calls it where JAX does; it runs on plain tensors, so its values
are JAX's whichever mesh is ambient (a prefill with activations split
over context ranks is `ROADMAP.md` A.8.3).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

_SEQ_AXIS = "context"
_BATCH_AXIS = "data"
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[None]:
    """Make `mesh` (a `DeviceMesh`) ambient inside the block."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The mesh `set_mesh` made current, or None."""
    return _MESH.get()


def constrain_seq(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
    """`x` with its sequence dim split over "context" (batch dim 0 over
    "data" when it divides); `x` itself in the no-op cases."""
    mesh = ambient_mesh()
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    if _SEQ_AXIS not in names:
        return x
    size = mesh[_SEQ_AXIS].size()
    if size == 1 or x.shape[seq_dim] % size or x.shape[seq_dim] < size:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    placements = []
    for name in x.device_mesh.mesh_dim_names:
        if name == _SEQ_AXIS:
            placements.append(Shard(seq_dim))
        elif (name == _BATCH_AXIS and seq_dim != 0
              and x.shape[0] % x.device_mesh[name].size() == 0):
            placements.append(Shard(0))
        else:
            placements.append(Replicate())
    return x.redistribute(x.device_mesh, placements)
