"""Region-level understanding dataset: caption and recognition
(counterpart of `visionllm_tpu/data/region_dataset.py`, after the
reference's vg.py, refcoco.py, osprey.py, v3det.py and lvis.py). A
sample carries one <region> visual prompt (the mask of a box or a
segmentation) for the region encoder; the conversation asks about it and
the answer is free text.

The prompt carries `image_token_len` <im_patch> ids where the JAX dataset
counts `(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.coco import decode_segmentation
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               clip_region_masks)
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.semseg_dataset import read_rows

REGION_CAPTION_QUESTIONS = [
    "Please describe the region <reg>region1<region></reg> in the image.",
    "What can you see in <reg>region1<region></reg>?",
    "Give a short description of <reg>region1<region></reg>.",
]
REGION_RECOGNITION_QUESTIONS = [
    "What category best describes the region <reg>region1<region></reg>?",
    "Identify the object in <reg>region1<region></reg>.",
]


def region_mask_from_ann(ann: Dict, h: int, w: int) -> np.ndarray:
    """[h, w] uint8: the annotation's segmentation when it has one, else
    its xywh box (rows y..y+h, columns x..x+w, both ends in)."""
    if ann.get("segmentation"):
        return decode_segmentation(ann["segmentation"], h, w)
    x, y, bw, bh = ann["bbox"]
    m = np.zeros((h, w), np.uint8)
    m[int(y):int(y + bh) + 1, int(x):int(x + bw) + 1] = 1
    return m


@register_dataset("region_caption")
class RegionCaptionDataset:
    """json rows {"image", "bbox" or "segmentation", "caption"} (VG-style
    region descriptions); `mode="recognition"` asks for the category."""

    task = "region_refer"
    dataset_name = "region_caption"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 image_token_len: int, mode: str = "caption",
                 image_size: int = 336, image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_mode: bool = False, **_):
        self.rows = read_rows(ann_file)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.mode = mode
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_mode = test_mode
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        img = load_image(os.path.join(self.img_prefix, row["image"]))
        h, w = img.shape[:2]
        mask = region_mask_from_ann(row, h, w)

        bank = (REGION_CAPTION_QUESTIONS if self.mode == "caption"
                else REGION_RECOGNITION_QUESTIONS)
        q_t = bank[0] if self.test_mode else self.rng.choice(bank)
        answer = row.get("caption") or row.get("category", "")
        conversations = [
            {"from": "human", "value": "<image>\n" + q_t},
            {"from": "gpt", "value": answer},
        ]
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_preprocess(img, self.image_size,
                                     self.image_aspect_ratio
                                     ).astype(np.float32),
            "regions": clip_region_masks(mask[None], self.image_size),
            "num_regions": 1,
            "answer": answer,
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name},
        }
