"""Shape-bucketed batching for the evaluation loops (counterpart of
`visionllm_tpu/eval/batching.py`): samples collect in buckets keyed by
the shapes of the arrays the model takes, and leave as fixed-size
batches; a bucket's tail is padded by repeating its last sample (the
extra rows are dropped on the host).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def batched_samples(
    dataset,
    n: int,
    batch_size: int,
    keys: Sequence[str],
) -> Iterator[Tuple[List[int], List[dict], Dict[str, np.ndarray], int]]:
    """Yields (indices, samples, stacked_arrays, num_valid).

    `stacked_arrays[key]` is [batch_size, ...] (tail batches padded);
    only the first `num_valid` rows correspond to real samples.
    """
    if batch_size <= 1:
        for i in range(n):
            s = dataset[i]
            yield [i], [s], {k: np.asarray(s[k])[None] for k in keys}, 1
        return

    buckets: Dict[tuple, List[Tuple[int, dict]]] = {}
    for i in range(n):
        s = dataset[i]
        key = tuple(tuple(np.shape(s[k])) for k in keys)
        buckets.setdefault(key, []).append((i, s))
        if len(buckets[key]) == batch_size:
            yield _stack(buckets.pop(key), keys, batch_size)
    for key in list(buckets):
        yield _stack(buckets.pop(key), keys, batch_size)


def _stack(items, keys, batch_size):
    idxs = [i for i, _ in items]
    samples = [s for _, s in items]
    num_valid = len(samples)
    padded = samples + [samples[-1]] * (batch_size - num_valid)
    arrays = {k: np.stack([np.asarray(s[k]) for s in padded])
              for k in keys}
    return idxs, samples, arrays, num_valid
