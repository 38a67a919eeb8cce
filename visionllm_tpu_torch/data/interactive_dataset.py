"""Interactive (visual-prompt) detection dataset (counterpart of
`visionllm_tpu/data/interactive_dataset.py`, after the reference's
coco_interactive.py): the question names regions as
"<reg>region1<region></reg>, ..." drawn by the `ShapeSampler` from each
object's mask; the answer gives one "[DET][EMB]..[EMB4]" block a region;
the region encoder reads the (image, prompt mask) pairs at the <region>
tokens.

The dataset draws from two generators, `rng` (transforms, templates) and
`sampler.rng` (the prompt shapes), as JAX's does. `data.build.
seeded_sample` reseeds both from the sample's place in a run. The prompt
carries `image_token_len` <im_patch> ids where the JAX dataset counts
`(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.coco import CocoIndex
from visionllm_tpu_torch.data.det_dataset import box_xyxy_to_cxcywh_np
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               clip_region_masks)
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE,
                                                 det_test_transform,
                                                 det_train_transform)
from visionllm_tpu_torch.data.visual_sampler import ShapeSampler

INTERACTIVE_QUESTIONS = [
    "Please detect the objects indicated by the given regions: <regions>.",
    "Find the objects marked by <regions> in the image.",
    "Locate the objects corresponding to the visual prompts <regions>.",
]
INTERACTIVE_YES = [
    "Sure, here are the results: <regions>.",
    "Certainly, the results for <regions> are shown.",
]


@register_dataset("coco_interactive")
class CocoInteractiveDataset:
    task = "interactive"
    dataset_name = "coco_interactive"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 image_token_len: int, test_mode: bool = False,
                 max_regions: int = 8, num_embs: int = 4,
                 image_size: int = 336, image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_scale=None, buckets=None):
        self.coco = CocoIndex(ann_file, filter_empty=True)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.test_mode = test_mode
        self.max_regions = max_regions
        self.num_embs = num_embs
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_scale = test_scale or TEST_SCALE
        self.buckets = buckets or DEFAULT_BUCKETS
        self.rng = random.Random(seed)
        self.sampler = ShapeSampler(seed=seed)

    def __len__(self):
        return len(self.coco)

    def __getitem__(self, idx: int) -> Dict:
        ann = self.coco.load_anns(idx, with_mask=True)
        img = load_image(os.path.join(self.img_prefix, ann["file_name"]))
        n = min(len(ann["labels"]), self.max_regions)
        regions = np.stack([self.sampler(m) for m in ann["masks"][:n]]) \
            if n else np.zeros((0, *img.shape[:2]), np.uint8)

        sample = {"image": img, "boxes": ann["boxes"][:n],
                  "labels": np.arange(n, dtype=np.int32)}
        if self.test_mode:
            sample = det_test_transform(sample, self.test_scale,
                                        self.buckets)
        else:
            sample = det_train_transform(sample, self.rng)

        reg_strs = [f"<reg>region{i + 1}<region></reg>" for i in range(n)]
        q_t = (INTERACTIVE_QUESTIONS[0] if self.test_mode
               else self.rng.choice(INTERACTIVE_QUESTIONS))
        a_t = (INTERACTIVE_YES[0] if self.test_mode
               else self.rng.choice(INTERACTIVE_YES))
        blk = T.det_answer_tokens(self.num_embs)
        question = "<image>\n" + q_t.replace("<regions>",
                                             ", ".join(reg_strs))
        answer = a_t.replace(
            "<regions>", ", ".join(f"region{i + 1}{blk}"
                                   for i in range(n)))
        tok = preprocess(
            preprocess_multimodal([[
                {"from": "human", "value": question},
                {"from": "gpt", "value": answer}]]),
            self.tokenizer, version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)

        # the prompt masks at the CLIP input's geometry, zero-padded to
        # max_regions
        clip_regions = np.zeros(
            (self.max_regions, self.image_size, self.image_size),
            np.float32)
        clip_regions[:n] = clip_region_masks(regions, self.image_size)

        out = {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_preprocess(img, self.image_size,
                                     self.image_aspect_ratio
                                     ).astype(np.float32),
            "image_aug": sample["image"].astype(np.float32),
            "pixel_mask": sample["pixel_mask"],
            "regions": clip_regions,
            "num_regions": n,
            "img_metas": {
                "task": self.task, "dataset_name": self.dataset_name,
                "id2index": {i: i for i in range(n)},
                "image_id": ann["image_id"],
                "ori_shape": (ann["height"], ann["width"]),
                "img_shape": sample["img_shape"],
            },
        }
        if not self.test_mode:
            hh, ww = sample["img_shape"]
            boxes = sample["boxes"].reshape(-1, 4)
            m = min(len(boxes), self.max_regions)
            tgt_boxes = np.zeros((self.max_regions, 4), np.float32)
            tgt_boxes[:m] = (box_xyxy_to_cxcywh_np(boxes[:m])
                             / np.asarray([ww, hh, ww, hh], np.float32))
            tgt_labels = np.zeros((self.max_regions,), np.int32)
            tgt_labels[:m] = sample["labels"][:m]
            valid = np.zeros((self.max_regions,), bool)
            valid[:m] = True
            out["targets"] = {"labels": tgt_labels, "boxes": tgt_boxes,
                              "valid": valid}
        return out
