"""Batch collation to fixed-shape numpy batches (counterpart of
`visionllm_tpu/data/collator.py`, after the reference's
DataCollatorForHybridDetSegPoseGenDataset, collator.py:319-412):
input_ids / labels right-padded to a small ladder of sequence buckets,
images stacked (padded to the batch's largest where samples come from
different resolution buckets), targets stacked, img_metas kept as a list.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from visionllm_tpu_torch.constants import IGNORE_INDEX

SEQ_BUCKETS = (512, 1024, 2048, 4096)


def _seq_bucket(n: int, buckets: Sequence[int] = SEQ_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pad_stack(arrays) -> np.ndarray:
    """Stack arrays, zero-padding each trailing dimension to the batch's
    largest."""
    arrays = [np.asarray(a) for a in arrays]
    if len({a.shape for a in arrays}) == 1:
        return np.stack(arrays)
    maxes = [max(a.shape[d] for a in arrays) for d in range(arrays[0].ndim)]
    out = np.zeros((len(arrays), *maxes), arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


# sample key -> batch key of the stacked image arrays
_IMAGE_KEYS = {"image": "images", "image_aug": "images_aug",
               "pixel_mask": "pixel_mask", "input_images": "input_images",
               "output_images": "output_images"}


def collate(samples: List[Dict], pad_token_id: int = 0) -> Dict[str, Any]:
    """Dataset dicts -> one batch dict of stacked numpy arrays:
    input_ids / labels / attn_mask [B, L] int32 at the sequence bucket of
    the longest sample, the image arrays stacked, `targets` stacked key by
    key, `img_metas` and `captions` kept as lists."""
    L = _seq_bucket(max(len(s["input_ids"]) for s in samples))
    B = len(samples)
    input_ids = np.full((B, L), pad_token_id, np.int32)
    labels = np.full((B, L), IGNORE_INDEX, np.int32)
    attn = np.zeros((B, L), np.int32)
    for i, s in enumerate(samples):
        ids = np.asarray(s["input_ids"], np.int32)[:L]
        lab = np.asarray(s["labels"], np.int32)[:L]
        input_ids[i, :len(ids)] = ids
        labels[i, :len(lab)] = lab
        attn[i, :len(ids)] = 1
    batch: Dict[str, Any] = {"input_ids": input_ids, "labels": labels,
                             "attn_mask": attn}
    for key, batch_key in _IMAGE_KEYS.items():
        if samples[0].get(key) is not None:
            batch[batch_key] = _pad_stack([s[key] for s in samples])
    if "targets" in samples[0]:
        batch["targets"] = {k: _pad_stack([s["targets"][k] for s in samples])
                            for k in samples[0]["targets"]}
    for key in ("img_metas", "captions"):
        if key in samples[0]:
            batch[key] = [s[key] for s in samples]
    return batch
