"""In-context (multi-image) datasets, `mmic_text` and `mmic_mask`
(counterpart of `visionllm_tpu/data/mmic_dataset.py`, after the
reference's mmic_text.py and mmic_mask.py).

`mmic_text` interleaves several <image> placeholders in a conversation;
`mmic_mask` shows a support image with one region and asks for the
objects of its kind in a query image ("[DET][EMB..]").

The reference threads `num_splits` through its collator and model
(collator.py:327-356, modeling_visionllmv2.py:625-663). The JAX package,
and so the port, pads each sample's images instead to a fixed number of
tiles T, the extra tiles zeroed: their <im_patch> ids are absent from the
prompt, so the scatter into the prompt reads only the real tiles, in
(sample, tile) order. Each image carries `image_token_len` <im_patch>
ids where the JAX datasets count `(image_size // 14) ** 2`
(`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.det_dataset import box_xyxy_to_cxcywh_np
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               clip_region_masks)
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.region_dataset import region_mask_from_ann
from visionllm_tpu_torch.data.semseg_dataset import read_rows
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TRAIN_SCALES,
                                                 det_test_transform,
                                                 det_train_transform)


@register_dataset("mmic_text")
class MMICTextDataset:
    """json rows {"images": [paths], "conversations": [...]}, one <image>
    an image in the human turns; at most `max_images` tiles."""

    task = "ic_text"
    dataset_name = "mmic_text"

    def __init__(self, ann_file: str, image_folder: str, tokenizer, *,
                 image_token_len: int, max_images: int = 4,
                 image_size: int = 336, conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0, **_):
        self.rows = read_rows(ann_file)
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.image_token_len = image_token_len
        self.max_images = max_images
        self.image_size = image_size
        self.conv_version = conv_version
        self.model_max_length = model_max_length

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        paths = row["images"][:self.max_images]
        imgs = [load_image(os.path.join(self.image_folder, p))
                for p in paths]
        tok = preprocess(
            preprocess_multimodal([list(row["conversations"])]),
            self.tokenizer, version=self.conv_version, has_image=True,
            image_token_len=[self.image_token_len] * len(imgs),
            model_max_length=self.model_max_length)
        tiles = np.zeros((self.max_images, self.image_size,
                          self.image_size, 3), np.float32)
        for i, im in enumerate(imgs):
            tiles[i] = clip_preprocess(im, self.image_size, "pad")
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": tiles,                    # [T, H, W, 3]
            "num_images": len(imgs),
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name},
        }


IC_MASK_QUESTIONS = [
    "Given the example region <reg>region1<region></reg> in the first "
    "image, find the corresponding objects in the second image.",
    "The first image marks <reg>region1<region></reg>. Detect the same "
    "kind of object in the second image.",
]
IC_MASK_YES = [
    "Sure, here are the corresponding objects: <blk>.",
    "Certainly, the matching objects are <blk>.",
]


@register_dataset("mmic_mask")
class MMICMaskDataset:
    """json rows {"support_image", "support_bbox" /
    "support_segmentation", "query_image", "query_boxes": [[x, y, w, h],
    ...]}: in-context det on the query image."""

    task = "ic_mask"
    dataset_name = "mmic_mask"

    def __init__(self, ann_file: str, image_folder: str, tokenizer, *,
                 image_token_len: int, num_embs: int = 4,
                 max_gt_per_img: int = 8, image_size: int = 336,
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_mode: bool = False, train_scales=None, buckets=None,
                 **_):
        self.rows = read_rows(ann_file)
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.image_token_len = image_token_len
        self.num_embs = num_embs
        self.max_gt = max_gt_per_img
        self.image_size = image_size
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_mode = test_mode
        self.train_scales = train_scales or TRAIN_SCALES
        self.buckets = buckets or DEFAULT_BUCKETS
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        sup = load_image(os.path.join(self.image_folder,
                                      row["support_image"]))
        qry = load_image(os.path.join(self.image_folder, row["query_image"]))
        sup_mask = region_mask_from_ann(
            {"bbox": row.get("support_bbox"),
             "segmentation": row.get("support_segmentation")},
            sup.shape[0], sup.shape[1])

        boxes = np.asarray([[x, y, x + w, y + h]
                            for x, y, w, h in row["query_boxes"]],
                           np.float32)
        sample = {"image": qry, "boxes": boxes,
                  "labels": np.zeros(len(boxes), np.int32)}
        if self.test_mode:
            # the JAX dataset's test transform runs at its defaults
            sample = det_test_transform(sample)
            q_t, a_t = IC_MASK_QUESTIONS[0], IC_MASK_YES[0]
        else:
            sample = det_train_transform(sample, self.rng,
                                         self.train_scales, self.buckets)
            q_t = self.rng.choice(IC_MASK_QUESTIONS)
            a_t = self.rng.choice(IC_MASK_YES)

        blk = T.det_answer_tokens(self.num_embs)
        conversations = [
            {"from": "human", "value": "<image>\n<image>\n" + q_t},
            {"from": "gpt", "value": a_t.replace("<blk>", blk)},
        ]
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)

        tiles = np.stack([
            clip_preprocess(sup, self.image_size, "pad"),
            clip_preprocess(qry, self.image_size, "pad")]).astype(np.float32)

        hh, ww = sample["img_shape"]
        n = min(len(sample["boxes"]), self.max_gt)
        tgt_boxes = np.zeros((self.max_gt, 4), np.float32)
        if n:
            tgt_boxes[:n] = (box_xyxy_to_cxcywh_np(sample["boxes"][:n])
                             / np.asarray([ww, hh, ww, hh], np.float32))
        valid = np.zeros((self.max_gt,), bool)
        valid[:n] = True
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": tiles,                  # [2, H, W, 3]
            "image_aug": sample["image"].astype(np.float32),
            "pixel_mask": sample["pixel_mask"],
            "regions": clip_region_masks(sup_mask[None], self.image_size),
            "num_regions": 1,
            "targets": {"labels": np.zeros((self.max_gt,), np.int32),
                        "boxes": tgt_boxes, "valid": valid},
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name,
                          "id2index": {0: 0},
                          "img_shape": sample["img_shape"]},
        }
