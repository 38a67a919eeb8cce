"""LLaVA-style chat / VQA dataset (counterpart of
`visionllm_tpu/data/llava_dataset.py`, after the reference's
LazySupervisedDataset, llava_data.py:60-182): json or jsonl rows of
conversations with an optional image, each turned into the
`preprocess_v1` / `preprocess_internlm` ids and masked labels, and the
CLIP pixels of the image: one `image_size` square ("pad": expand to a
square with the CLIP mean, then resize; "resize"), or with "anyres" the
`dynamic_preprocess` tiles and their thumbnail, each resized.

Files are read by `data/image_io.py` (no Pillow). The prompt carries
`image_token_len` <im_patch> ids an image (a tile): the model's image
feature rows, `VisionLLMConfig.image_token_len`, from the caller as in
the port's other datasets (the JAX dataset counts `(image_size // 14)
** 2`, a quarter under pixel shuffle).

A sample that fails to load (a missing or unreadable file) is replaced
by another row drawn from the dataset's `rng`, up to 10 times, then the
failure is raised, as in JAX. The port's Trainer builds every sample
through `data.build.seeded_sample`, which gives each sample its own
`rng`: the substitute depends on the sample's position in the run, not
on what other threads drew before (`ROADMAP.md` §C.3).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               dynamic_preprocess)
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)

RETRIES = 10
# what a sample's load raises for a missing, unreadable or unread file
LOAD_ERRORS = (OSError, ValueError, NotImplementedError)


@register_dataset("llava")
class LlavaChatDataset:
    task = "chat"

    def __init__(
        self,
        ann_file: str,
        image_folder: str,
        tokenizer,
        *,
        image_token_len: int,
        image_size: int = 336,
        image_aspect_ratio: str = "pad",
        image_max_tile: int = 6,
        conv_version: str = "vicuna_v1",
        model_max_length: int = 4096,
        seed: int = 0,
    ):
        with open(ann_file) as f:
            if ann_file.endswith(".jsonl"):
                self.rows = [json.loads(line) for line in f]
            else:
                self.rows = json.load(f)
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.image_max_tile = image_max_tile
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        for _ in range(RETRIES):
            try:
                return self._get(idx)
            except LOAD_ERRORS:
                idx = self.rng.randrange(len(self.rows))
        return self._get(idx)

    def _get(self, idx: int) -> Dict:
        row = self.rows[idx]
        has_image = "image" in row
        image = None
        image_token_len = 0
        if has_image:
            img = load_image(os.path.join(self.image_folder, row["image"]))
            if self.image_aspect_ratio == "anyres":
                tiles = dynamic_preprocess(img, image_size=self.image_size,
                                           max_num=self.image_max_tile)
                image = np.stack([clip_preprocess(t, self.image_size,
                                                  mode="resize")
                                  for t in tiles])
            else:
                image = clip_preprocess(img, self.image_size,
                                        self.image_aspect_ratio)[None]
            image_token_len = self.image_token_len * len(image)
        tok = preprocess(
            preprocess_multimodal([list(row["conversations"])]),
            self.tokenizer, version=self.conv_version, has_image=has_image,
            image_token_len=image_token_len,
            model_max_length=self.model_max_length)
        out = {"input_ids": tok["input_ids"][0], "labels": tok["labels"][0],
               "img_metas": {"task": self.task, "dataset_name": "llava"}}
        if image is not None:
            out["image"] = image.astype(np.float32)
        return out
