"""Referring-expression grounding datasets (counterpart of
`visionllm_tpu/data/grd_dataset.py`, after the reference's
refcoco_llava.py and reasonseg_llava.py): one item per (annotation,
expression) of a COCO-style json whose annotations carry "expressions";
the answer is one "[GRD][EMB]..[EMB4]" block and the target one box (and
mask). Test mode uses the templates at index 0.

The prompt carries `image_token_len` <im_patch> ids (the model's image
feature rows, `VisionLLMConfig.image_token_len`) where the JAX datasets
count `(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.coco import decode_segmentation
from visionllm_tpu_torch.data.det_dataset import box_xyxy_to_cxcywh_np
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import clip_preprocess, resize_image
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE,
                                                 det_test_transform,
                                                 det_train_transform)


@register_dataset("refcoco_grd")
class RefCocoGrdDataset:
    task = "grd"
    dataset_name = "refcoco"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 test_mode: bool = False, with_mask: bool = False,
                 image_token_len: int, num_embs: int = 4,
                 image_size: int = 336,
                 image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_scale=None, buckets=None):
        with open(ann_file) as f:
            raw = json.load(f)
        self.images = {im["id"]: im for im in raw["images"]}
        self.items = []          # (image_id, ann, expression)
        for ann in raw["annotations"]:
            for expr in ann.get("expressions", []):
                self.items.append((ann["image_id"], ann, expr))
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.test_mode = test_mode
        self.with_mask = with_mask
        self.num_embs = num_embs
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_scale = test_scale or TEST_SCALE
        self.buckets = buckets or DEFAULT_BUCKETS
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        image_id, ann, expr = self.items[idx]
        info = self.images[image_id]
        img = load_image(os.path.join(self.img_prefix, info["file_name"]))
        x, y, w, h = ann["bbox"]
        sample = {"image": img,
                  "boxes": np.asarray([[x, y, x + w, y + h]], np.float32),
                  "labels": np.zeros(1, np.int32)}
        if self.with_mask:
            sample["masks"] = decode_segmentation(
                ann.get("segmentation"), info["height"],
                info["width"])[None]
        if self.test_mode:
            sample = det_test_transform(sample, self.test_scale,
                                        self.buckets)
            q_t, a_t = T.GRD_QUESTIONS[0], T.GRD_YES[0]
        else:
            sample = det_train_transform(sample, self.rng)
            q_t = self.rng.choice(T.GRD_QUESTIONS)
            a_t = self.rng.choice(T.GRD_YES)

        question = "<image>\n" + q_t.replace("<expression>", expr)
        answer = a_t.replace("<expression>",
                             T.grd_answer_tokens(self.num_embs))
        conversations = [{"from": "human", "value": question},
                         {"from": "gpt", "value": answer}]
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
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
                "id2index": {0: 0}, "image_id": image_id,
                "expression": expr,
                "ori_shape": (info["height"], info["width"]),
                "img_shape": sample["img_shape"],
            },
        }
        if not self.test_mode:
            hh, ww = sample["img_shape"]
            boxes = sample["boxes"].reshape(-1, 4)
            n = len(boxes)
            tgt_boxes = np.zeros((1, 4), np.float32)
            if n:
                tgt_boxes[0] = (box_xyxy_to_cxcywh_np(boxes)[0]
                                / np.asarray([ww, hh, ww, hh], np.float32))
            out["targets"] = {
                "labels": np.zeros((1,), np.int32),
                "boxes": tgt_boxes,
                "valid": np.asarray([n > 0]),
            }
            if self.with_mask and "masks" in sample:
                mh, mw = sample["image"].shape[:2]
                m = np.zeros((1, mh // 4, mw // 4), np.float32)
                if n and len(sample["masks"]):
                    m[0] = (resize_image(
                        sample["masks"][0].astype(np.uint8) * 255,
                        (mh // 4, mw // 4), "bilinear") > 127)
                out["targets"]["masks"] = m
        return out


@register_dataset("reasonseg")
class ReasonSegDataset(RefCocoGrdDataset):
    """Reasoning segmentation (behavioral reference:
    datasets/reasonseg_llava.py:214-252): the question IS the full
    reasoning sentence ('<image>\\n' + expression, no template
    substitution), the answer is a YES template whose <expression> slot
    becomes the "[GRD][EMB]..[EMB4]" block, and at train time the
    dataset's explanation sentence is appended after the block so the
    LLM also learns to justify. Single box/mask target like refcoco.

    Annotation format: COCO-style json where each annotation carries
    "expressions" (full sentences) and optionally "answer"
    (explanation text).
    """

    task = "grd"
    dataset_name = "reasonseg"

    def __init__(self, *args, with_mask: bool = True, **kw):
        super().__init__(*args, with_mask=with_mask, **kw)
        # (image_id, ann, expr) items built by the parent; keep the
        # per-annotation explanation alongside
        self.answers = {}
        for image_id, ann, expr in self.items:
            self.answers[id(ann)] = ann.get("answer", "")

    def __getitem__(self, idx: int) -> Dict:
        image_id, ann, expr = self.items[idx]
        out = super().__getitem__(idx)
        # rebuild the conversation with reasonseg semantics
        if self.test_mode:
            a_t = T.GRD_YES[0]
        else:
            a_t = self.rng.choice(T.GRD_YES)
        question = "<image>\n" + expr
        answer = a_t.replace("<expression>",
                             T.grd_answer_tokens(self.num_embs))
        if not self.test_mode and ann.get("answer"):
            answer = answer + " " + ann["answer"]
        conversations = [{"from": "human", "value": question},
                         {"from": "gpt", "value": answer}]
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)
        out["input_ids"] = tok["input_ids"][0]
        out["labels"] = tok["labels"][0]
        out["img_metas"]["dataset_name"] = self.dataset_name
        return out
