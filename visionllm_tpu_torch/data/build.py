"""Dataset registry and samplers (counterpart of
`visionllm_tpu/data/build.py`): config dicts of the shipped configs
(`{"type": ..., **kwargs}`) to dataset objects, with ratio subsampling
and concatenation; the task-grouped batch sampler of the Trainer, whose
batches never mix tool groups (reference visionllmv2_trainer.py:210-295);
and the length-grouped and source-grouped samplers of the reference's HF
Trainer (visionllmv2_trainer.py:64-205). For one seed every sampler gives
the JAX package's indices."""

from __future__ import annotations

import bisect
import copy
import random
from typing import Any, Callable, Dict, Iterator, List, Sequence, Union

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


def seeded_sample(dataset: Any, idx: int, seed: Union[int, str]) -> Any:
    """`dataset[idx]` with the dataset's random draws (augmentations,
    templates, class sampling: its `rng`) taken from
    `random.Random(seed)` on a shallow copy, and those of its
    `ShapeSampler` (the interactive prompt shapes: `sampler.rng`) from
    `random.Random(f"{seed}/sampler")` on a copy of the sampler, so a
    sample depends on (idx, seed) alone, whichever thread builds it and
    in whatever order."""
    if isinstance(dataset, ConcatDataset):
        di = bisect.bisect_right(dataset.cum, idx)
        prev = dataset.cum[di - 1] if di else 0
        return seeded_sample(dataset.datasets[di], idx - prev, seed)
    if isinstance(dataset, SubsetDataset):
        return seeded_sample(dataset.base, dataset.indices[idx], seed)
    if hasattr(dataset, "rng"):
        dataset = copy.copy(dataset)
        dataset.rng = random.Random(seed)
        if hasattr(getattr(dataset, "sampler", None), "rng"):
            dataset.sampler = copy.copy(dataset.sampler)
            dataset.sampler.rng = random.Random(f"{seed}/sampler")
    return dataset[idx]


# tool groups (visionllmv2_trainer.py:216-231): batches never mix tools
TASK_GROUPS = {
    "gdino": {"det", "grd", "seg", "interactive", "ic_mask", "semseg",
              "sod", "cod"},
    "unipose": {"pose"},
    "sd": {"t2i"},
    "ip2p": {"edit"},
    "vlm": {"chat", "region_refer", "region_recognition", "region_vqa",
            "ic_text"},
}


def group_of_task(task: str) -> str:
    for g, tasks in TASK_GROUPS.items():
        if task in tasks:
            return g
    return "vlm"


class TaskGroupedBatchSampler:
    """Index lists, each from a single tool group (the reference's
    RandomTaskSourcedBatchSampler): per group the indices shuffled and
    cut into batches, then the batches of all groups shuffled."""

    def __init__(self, dataset: ConcatDataset, batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        rng = random.Random(self.seed)
        by_group: Dict[str, List[int]] = {}
        start = 0
        for d, end in zip(self.dataset.datasets, self.dataset.cum):
            g = group_of_task(getattr(d, "task", "chat"))
            by_group.setdefault(g, []).extend(range(start, end))
            start = end
        batches = []
        for idxs in by_group.values():
            rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                b = idxs[i:i + self.batch_size]
                if len(b) == self.batch_size or not self.drop_last:
                    batches.append(b)
        rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        return sum(len(d) // self.batch_size
                   for d in self.dataset.datasets)


def split_to_even_chunks(indices: List[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """`num_chunks` chunks of about equal total length (reference
    :64-84): each index goes to the chunk now shortest; a chunk that has
    its share of indices takes no more."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lens = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lens.index(min(chunk_lens))
        chunks[shortest].append(index)
        chunk_lens[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lens[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: random.Random) -> List[int]:
    """Random megabatches of world_size * batch_size, each sorted by
    length, longest first, and split into per-device chunks of about even
    total length (reference :117-126)."""
    indices = list(range(len(lengths)))
    rng.shuffle(indices)
    mb = world_size * batch_size
    megabatches = [indices[i:i + mb] for i in range(0, len(indices), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(lengths: Sequence[int],
                                        batch_size: int, world_size: int,
                                        rng: random.Random) -> List[int]:
    """Multimodal (length > 0) and language-only (length < 0) samples in
    separate megabatches (reference :86-115)."""
    assert all(n != 0 for n in lengths), "Should not have zero length."
    mm = [(i, n) for i, n in enumerate(lengths) if n > 0]
    lang = [(i, -n) for i, n in enumerate(lengths) if n < 0]
    assert mm, "Should have at least one multimodal sample."
    assert lang, "Should have at least one language sample."
    mm_idx = [mm[i][0] for i in get_length_grouped_indices(
        [n for _, n in mm], batch_size, world_size, rng)]
    lang_idx = [lang[i][0] for i in get_length_grouped_indices(
        [n for _, n in lang], batch_size, world_size, rng)]
    mb = world_size * batch_size
    mm_mb = [mm_idx[i:i + mb] for i in range(0, len(mm_idx), mb)]
    lang_mb = [lang_idx[i:i + mb] for i in range(0, len(lang_idx), mb)]
    additional = mm_mb[-1] + lang_mb[-1]
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    rng.shuffle(megabatches)
    if len(additional) >= mb:
        megabatches = [additional[:mb]] + megabatches
        additional = additional[mb:]
    if additional:
        megabatches.append(additional)
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Length-bucketing index sampler (reference :128-159): near-uniform
    sequence lengths within a step, so little padding."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int], seed: int = 0,
                 group_by_modality: bool = False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.seed = seed
        self.group_by_modality = group_by_modality
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed * 100003 + self._epoch)
        if self.group_by_modality:
            return iter(get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng))
        return iter(get_length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, rng))


class RandomSourcedBatchSampler:
    """Every consecutive `batch_size` indices come from one source dataset
    (reference :162-205): each dataset's samples shuffled and trimmed to a
    multiple of the batch, then the batches shuffled across datasets. A
    flat index iterator, as the reference's (batch it downstream)."""

    def __init__(self, dataset_sizes: Sequence[int], batch_size: int,
                 seed: int = 0):
        self.dataset_sizes = list(dataset_sizes)
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return sum(self.dataset_sizes)

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed * 100003 + self._epoch)
        batches: List[List[int]] = []
        start = 0
        for size in self.dataset_sizes:
            idxs = list(range(start, start + size))
            rng.shuffle(idxs)
            idxs = idxs[:size - size % self.batch_size]
            batches.extend(idxs[i:i + self.batch_size]
                           for i in range(0, len(idxs), self.batch_size))
            start += size
        rng.shuffle(batches)
        return iter(i for b in batches for i in b)
