"""Multi-process evaluation sharding and result gathering (counterpart
of `visionllm_tpu/parallel/multihost.py`): a contiguous split of the
dataset by rank (the reference's InferenceSampler) and a gather of
picklable per-rank results to every rank (mmdet's
`collect_results_cpu`). Without a process group, or at world 1, both
pass through."""

from __future__ import annotations

from typing import Any, List, Sequence

import torch.distributed as dist


def _world() -> tuple:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_indices(n: int) -> List[int]:
    """This rank's contiguous part of range(n); the first n % world
    ranks take one more."""
    rank, world = _world()
    per = [n // world + (1 if i < n % world else 0) for i in range(world)]
    start = sum(per[:rank])
    return list(range(start, start + per[rank]))


def all_gather_objects(local: Sequence[Any]) -> List[Any]:
    """Every rank's `local` list, concatenated in rank order, on every
    rank."""
    if _world()[1] == 1:
        return list(local)
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, list(local))
    return [x for part in parts for x in part]
