"""COCO detection / instance-segmentation dataset -> model-ready samples
(counterpart of `visionllm_tpu/data/det_dataset.py`, after the
reference's CocoLlavaDataset, coco_llava.py:68-326): the det transforms
-> the templated conversation with one "[DET][EMB]..[EMB4]" block per
class -> the CLIP image -> id2index (contiguous category -> answer slot)
-> targets padded to `max_gt_per_img`, normalized cxcywh.

The prompt carries `image_token_len` <im_patch> ids, the model's image
feature rows: `VisionLLMConfig.image_token_len` (576 for CLIP-L/336, a
quarter of the patches under pixel shuffle). The JAX dataset counts
`(image_size // 14) ** 2`, which under pixel shuffle is four times the
rows the model gives (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.coco import CocoIndex
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import clip_preprocess, resize_image
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE, TRAIN_SCALES,
                                                 det_test_transform,
                                                 det_train_transform)


def box_xyxy_to_cxcywh_np(b) -> np.ndarray:
    x0, y0, x1, y1 = np.split(np.asarray(b, np.float32), 4, axis=-1)
    return np.concatenate(
        [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1)


@register_dataset("coco_det")
class CocoDetDataset:
    task = "det"
    dataset_name = "coco"

    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        tokenizer,
        *,
        test_mode: bool = False,
        with_mask: bool = False,
        max_gt_per_img: int = 100,
        num_embs: int = 4,
        image_token_len: int,
        image_size: int = 336,
        image_aspect_ratio: str = "pad",
        conv_version: str = "vicuna_v1",
        model_max_length: int = 4096,
        seed: int = 0,
        test_scale=None,
        train_scales=None,
        buckets=None,
    ):
        self.coco = CocoIndex(ann_file, filter_empty=not test_mode)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.test_mode = test_mode
        self.with_mask = with_mask
        self.max_gt = max_gt_per_img
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

    # subclasses (det variants) may pin an explicit class list; None ->
    # the annotation file's categories
    _classes: Optional[List[str]] = None
    # normalize names the way det_llava.py:229 does (strip + lowercase)
    _normalize_names: bool = False

    def __len__(self) -> int:
        return len(self.coco)

    @property
    def class_names(self) -> List[str]:
        names = (list(self._classes) if self._classes is not None
                 else self.coco.class_names)
        if self._normalize_names:
            names = [n.strip().lower() for n in names]
        return names

    def _load_image(self, file_name: str) -> np.ndarray:
        return load_image(os.path.join(self.img_prefix, file_name))

    def _build_class_list(self, gt_labels: np.ndarray) -> List[str]:
        """Train-time class sampling (coco_llava.py:200-215): either all
        classes shuffled, or positives + a random number of negatives."""
        names = list(self.class_names)
        if self.test_mode:
            return names
        if self.rng.random() < 0.5:
            self.rng.shuffle(names)
            return names
        present = {self.class_names[l] for l in set(gt_labels.tolist())}
        pos = [n for n in names if n in present]
        neg = [n for n in names if n not in present]
        min_neg = 1 if len(gt_labels) == 0 else 0
        num_neg = self.rng.randint(min_neg, len(names))
        self.rng.shuffle(neg)
        out = pos + neg[:num_neg]
        self.rng.shuffle(out)
        return out

    def _id2index(self, class_list: List[str]) -> Dict[int, int]:
        """contiguous category id -> answer slot (coco_llava.py:285-295)."""
        name2index = {n: i for i, n in enumerate(class_list)}
        return {i: name2index[n]
                for i, n in enumerate(self.class_names)
                if n in name2index}

    def __getitem__(self, idx: int) -> Dict:
        ann = self.coco.load_anns(idx, with_mask=self.with_mask)
        img = self._load_image(ann["file_name"])

        sample = {"image": img, "boxes": ann["boxes"],
                  "labels": ann["labels"]}
        if self.with_mask:
            sample["masks"] = ann["masks"]
        if self.test_mode:
            sample = det_test_transform(sample, self.test_scale,
                                         self.buckets)
            q_t, a_t = T.DET_QUESTIONS[0], T.DET_YES[0]
        else:
            sample = det_train_transform(sample, self.rng,
                                         self.train_scales, self.buckets)
            q_t = self.rng.choice(T.DET_QUESTIONS)
            a_t = self.rng.choice(T.DET_YES)

        class_list = self._build_class_list(sample.get(
            "labels", np.zeros(0, np.int32)))
        question = "<image>\n" + q_t.replace(
            "<class>", ", ".join(class_list))
        blk = T.det_answer_tokens(self.num_embs)
        answer = a_t.replace("<class>", (blk + ", ").join(class_list) + blk)

        conversations = [{"from": "human", "value": question},
                         {"from": "gpt", "value": answer}]
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)

        # id2index: contiguous category id -> answer slot (class_list pos)
        id2index = self._id2index(class_list)

        clip_img = clip_preprocess(img, self.image_size,
                                   self.image_aspect_ratio)

        out = {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_img.astype(np.float32),
            "image_aug": sample["image"].astype(np.float32),
            "pixel_mask": sample["pixel_mask"],
            "img_metas": {
                "task": self.task,
                "dataset_name": self.dataset_name,
                "id2index": id2index,
                "image_id": ann["image_id"],
                "ori_shape": (ann["height"], ann["width"]),
                "img_shape": sample["img_shape"],
            },
        }
        if not self.test_mode:
            h, w = sample["img_shape"]
            boxes = sample["boxes"].reshape(-1, 4)
            cxcywh = box_xyxy_to_cxcywh_np(boxes) / np.asarray(
                [w, h, w, h], np.float32)
            n = min(len(boxes), self.max_gt)
            # class labels remapped to answer slots via id2index
            slots = np.asarray(
                [id2index[int(l)] for l in sample["labels"][:n]], np.int32)
            tgt_boxes = np.zeros((self.max_gt, 4), np.float32)
            tgt_boxes[:n] = cxcywh[:n]
            tgt_labels = np.zeros((self.max_gt,), np.int32)
            tgt_labels[:n] = slots
            valid = np.zeros((self.max_gt,), bool)
            valid[:n] = True
            out["targets"] = {"labels": tgt_labels, "boxes": tgt_boxes,
                              "valid": valid}
            if self.with_mask:
                mh, mw = sample["image"].shape[:2]
                stride4 = (mh // 4, mw // 4)
                masks = np.zeros((self.max_gt, *stride4), np.float32)
                if n:
                    for i in range(n):
                        masks[i] = (resize_image(
                            sample["masks"][i] * 255, stride4,
                            "bilinear") > 127)
                out["targets"]["masks"] = masks
        return out
