"""A train step's loss over a global batch split on the "data" mesh axis.

XLA computes the JAX step over the whole global batch, so every count the
loss divides by (boxes, target tokens) counts the global batch. The port
runs a loss on each rank's rows, under `split_over(mesh)`: the loss
functions then take each such count over the data ranks (`global_sum`,
an all-reduce of a value that carries no gradient) and divide a mean of
their own equal share by the number of shares (`data_shards`). Each
rank's loss is so its part of the global batch's loss, the parts sum to
it, and the data ranks' gradients are summed (not averaged) into the
global batch's gradient. Outside `split_over`, or on a data axis of 1,
both are the identity and the loss is the one-process loss bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
import torch.distributed as dist

_DATA: contextvars.ContextVar = contextvars.ContextVar("data_split",
                                                       default=None)


@contextlib.contextmanager
def split_over(mesh) -> Iterator[None]:
    """Inside the block the batch is this rank's part of a global batch
    split over `mesh["data"]` (a `DeviceMesh`; None splits nothing)."""
    group = None
    if mesh is not None and mesh["data"].size() > 1:
        group = mesh["data"].get_group()
    token = _DATA.set(group)
    try:
        yield
    finally:
        _DATA.reset(token)


def data_group() -> Optional[dist.ProcessGroup]:
    """The data ranks' group of the split in force, None when none is."""
    return _DATA.get()


def data_shards() -> int:
    """How many equal shares the global batch is split into (1 when no
    split is in force)."""
    group = _DATA.get()
    return 1 if group is None else dist.get_world_size(group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (a count over this rank's rows) summed over the data ranks,
    detached; `x` itself when no split is in force."""
    group = _DATA.get()
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
