"""Semantic segmentation dataset, ADE20K-style (counterpart of
`visionllm_tpu/data/semseg_dataset.py`, after the reference's
ade20k_llava.py): segmentation as one mask query a class. The
conversation lists the prompted classes with one "[SEG][EMB]..[EMB4]"
block each; the targets are one binary mask a prompted class.

Annotations are json (or jsonl) rows {"image": path, "label": path}; the
label is a PNG of class ids (255 is ignore), read as stored
(`image_io.load_label`: a gray PNG's values or a palette PNG's indices),
as the JAX dataset reads it with `np.asarray(Image.open(label))`.

Differences from the JAX dataset:

- `class_names` is required, and a config without it raises a
  `ValueError` naming it (the JAX class raises a `TypeError`; its
  shipped `semseg/ade20k_val` config gives none: `ROADMAP.md` §C.2,
  §C.3);
- the prompt carries `image_token_len` <im_patch> ids where the JAX
  dataset counts `(image_size // 14) ** 2` (§C.2);
- in train mode, a crop that drops a class's box and mask leaves the
  other classes' targets in their slots; the JAX dataset raises
  (`IndexError` or a broadcast `ValueError`) on such a sample (§C.2).

As in JAX, a test-mode prompt names only the first
`max_classes_per_sample` classes (32), so a class at a later index is
never predicted (§C.2).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.det_dataset import box_xyxy_to_cxcywh_np
from visionllm_tpu_torch.data.image_io import load_image, load_label
from visionllm_tpu_torch.data.mm_utils import clip_preprocess, resize_image
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE, TRAIN_SCALES,
                                                 det_test_transform,
                                                 det_train_transform)


def seg_answer_tokens(num_embs: int) -> str:
    if num_embs == 1:
        return "[SEG][EMB]"
    return "[SEG][EMB]" + "".join(f"[EMB{i}]" for i in range(2, num_embs + 1))


def read_rows(ann_file: str) -> List[Dict]:
    """A json list, or one json object a line for a `.jsonl` file."""
    with open(ann_file) as f:
        return ([json.loads(line) for line in f]
                if ann_file.endswith(".jsonl") else json.load(f))


@register_dataset("semseg")
class SemSegDataset:
    task = "semseg"
    dataset_name = "ade20k"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 class_names: Optional[List[str]] = None,
                 image_token_len: int, test_mode: bool = False,
                 max_classes_per_sample: int = 32, num_embs: int = 4,
                 image_size: int = 336, image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_scale=None, train_scales=None, buckets=None, **_):
        if not class_names:
            raise ValueError(
                "SemSegDataset needs class_names: the label maps hold "
                "class ids, and the prompt names the classes (the shipped "
                "semseg/ade20k_val config gives none; pass a config file "
                "whose dataset sets class_names)")
        self.rows = read_rows(ann_file)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.class_names = list(class_names)
        self.test_mode = test_mode
        self.max_classes = max_classes_per_sample
        self.num_embs = num_embs
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_scale = test_scale or TEST_SCALE
        self.train_scales = train_scales or TRAIN_SCALES
        self.buckets = buckets or DEFAULT_BUCKETS
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.rows)

    def label(self, idx: int) -> np.ndarray:
        """Row `idx`'s label map as stored."""
        return load_label(os.path.join(self.img_prefix,
                                       self.rows[idx]["label"]))

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        img = load_image(os.path.join(self.img_prefix, row["image"]))
        label = self.label(idx)

        present = sorted(int(c) for c in np.unique(label)
                         if c != 255 and c < len(self.class_names))
        if self.test_mode:
            class_ids = list(range(len(self.class_names)))[:self.max_classes]
        else:
            neg = [c for c in range(len(self.class_names))
                   if c not in present]
            self.rng.shuffle(neg)
            class_ids = (present + neg)[:self.max_classes]
            self.rng.shuffle(class_ids)

        masks = np.stack([(label == c).astype(np.uint8)
                          for c in class_ids]) if class_ids else \
            np.zeros((0, *label.shape), np.uint8)
        # the tight box of each class mask; an empty mask keeps a unit box
        # and is marked invalid
        boxes, valid_cls = [], []
        for m in masks:
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes.append([xs.min(), ys.min(), xs.max() + 1,
                              ys.max() + 1])
                valid_cls.append(True)
            else:
                boxes.append([0, 0, 1, 1])
                valid_cls.append(False)
        sample = {"image": img,
                  "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                  "labels": np.arange(len(class_ids), dtype=np.int32),
                  "masks": masks}
        if self.test_mode:
            sample = det_test_transform(sample, self.test_scale,
                                        self.buckets)
            q_t, a_t = T.DET_QUESTIONS[0], T.DET_YES[0]
        else:
            sample = det_train_transform(sample, self.rng,
                                         self.train_scales, self.buckets)
            q_t = self.rng.choice(T.DET_QUESTIONS)
            a_t = self.rng.choice(T.DET_YES)

        names = [self.class_names[c] for c in class_ids]
        blk = seg_answer_tokens(self.num_embs)
        question = "<image>\n" + q_t.replace("<class>", ", ".join(names))
        answer = a_t.replace("<class>", (blk + ", ").join(names) + blk)
        tok = preprocess(
            preprocess_multimodal([[
                {"from": "human", "value": question},
                {"from": "gpt", "value": answer}]]),
            self.tokenizer, version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)

        out = {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_preprocess(img, self.image_size,
                                     self.image_aspect_ratio
                                     ).astype(np.float32),
            "image_aug": sample["image"].astype(np.float32),
            "pixel_mask": sample["pixel_mask"],
            "img_metas": {
                "task": self.task, "dataset_name": self.dataset_name,
                "id2index": {c: i for i, c in enumerate(class_ids)},
                "class_ids": class_ids,
                "ori_shape": label.shape[:2],
                "img_shape": sample["img_shape"],
            },
        }
        if not self.test_mode:
            K = self.max_classes
            hh, ww = sample["img_shape"]
            mh, mw = sample["image"].shape[:2]
            # each class's box and mask go to its answer slot, its label:
            # a crop that drops some leaves the others in place (JAX
            # indexes them by position and raises then: ROADMAP.md §C.2)
            slots = np.asarray(sample["labels"], np.int64)
            tgt_boxes = np.zeros((K, 4), np.float32)
            tgt_masks = np.zeros((K, mh // 4, mw // 4), np.float32)
            v = np.zeros((K,), bool)
            if len(slots):
                tgt_boxes[slots] = (
                    box_xyxy_to_cxcywh_np(sample["boxes"])
                    / np.asarray([ww, hh, ww, hh], np.float32))
                for j, slot in enumerate(slots):
                    tgt_masks[slot] = (resize_image(
                        sample["masks"][j] * 255,
                        (mh // 4, mw // 4), "bilinear") > 127)
                v[slots] = np.asarray(valid_cls)[slots]
            out["targets"] = {
                "labels": np.arange(K, dtype=np.int32),
                "boxes": tgt_boxes,
                "masks": tgt_masks,
                "valid": v,
            }
        return out
