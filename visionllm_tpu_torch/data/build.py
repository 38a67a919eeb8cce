"""Dataset registry (counterpart of the registry half of
`visionllm_tpu/data/build.py`): config dicts of the shipped eval configs
(`{"type": ..., **kwargs}`) to dataset objects, with ratio subsampling
and concatenation. The task-grouped samplers are not ported."""

from __future__ import annotations

import bisect
import random
from typing import Any, Callable, Dict, List, Sequence

DATASET_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def build_dataset(cfg: Dict, tokenizer, **common) -> Any:
    """The registered class of `cfg["type"]` built from the rest of `cfg`
    and `common`; a `ratio` below 1 keeps a seeded subset. A type the port
    has not registered raises `KeyError` naming it."""
    cfg = dict(cfg)
    type_name = cfg.pop("type")
    ratio = cfg.pop("ratio", None)
    if type_name not in DATASET_REGISTRY:
        raise KeyError(f"dataset type {type_name!r} is not registered in "
                       f"the port (registered: {sorted(DATASET_REGISTRY)})")
    ds = DATASET_REGISTRY[type_name](tokenizer=tokenizer, **cfg, **common)
    if ratio is not None and ratio < 1.0:
        ds = SubsetDataset(ds, ratio)
    return ds


def build_multi_datasets(cfgs: Sequence[Dict], tokenizer, **common):
    return ConcatDataset([build_dataset(c, tokenizer, **common)
                          for c in cfgs])


class SubsetDataset:
    def __init__(self, base, ratio: float, seed: int = 0):
        self.base = base
        n = max(1, int(len(base) * ratio))
        rng = random.Random(seed)
        self.indices = rng.sample(range(len(base)), n)
        self.task = getattr(base, "task", "chat")

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[i]]


class ConcatDataset:
    def __init__(self, datasets: List[Any]):
        self.datasets = datasets
        self.cum = []
        total = 0
        for d in datasets:
            total += len(d)
            self.cum.append(total)

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, idx):
        di = bisect.bisect_right(self.cum, idx)
        prev = self.cum[di - 1] if di else 0
        return self.datasets[di][idx - prev]

    def task_of(self, idx: int) -> str:
        di = bisect.bisect_right(self.cum, idx)
        return getattr(self.datasets[di], "task", "chat")
