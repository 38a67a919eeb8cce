"""Keypoint datasets (counterpart of `visionllm_tpu/data/pose_dataset.py`,
after the reference's coco_pose_llava.py, crowdpose_llava.py and
unikpt_llava.py): a two-part answer, "[DET][EMB]..[EMB4]" for the object
class and one "[POSE][EMB]..[EMB4]" block per keypoint class; targets
`labels`, `boxes` (normalized cxcywh), `keypoints` ("xyxy..vv",
normalized, padded to 3 * `num_body_points`), `area` and `valid`, padded
to `max_gt_per_img`; `img_metas["kpt_id2index"]` maps each keypoint class
to its answer slot (the train-time order is shuffled; the pose
evaluation unshuffles by it).

Where the port differs from the JAX datasets:
* the prompt carries `image_token_len` <im_patch> ids, the model's image
  feature rows, from the caller (`VisionLLMConfig.image_token_len`),
  where JAX counts `(image_size // 14) ** 2`, four times the rows under
  pixel shuffle (`ROADMAP.md` §C.2);
* images are read by `data/image_io.py` (no Pillow);
* train mode resizes to `train_scales` and pads to `buckets` as the det
  dataset does; JAX takes the default ladder and buckets there (the
  defaults give JAX's samples).

As in JAX, the train-mode targets scale the annotation's boxes and
keypoints by the resize alone: a flipped or cropped sample keeps its
unflipped, uncropped targets (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.coco import CocoIndex
from visionllm_tpu_torch.data.det_dataset import box_xyxy_to_cxcywh_np
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import clip_preprocess
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE, TRAIN_SCALES,
                                                 det_test_transform,
                                                 det_train_transform)

COCO_KEYPOINT_NAMES = [
    "nose", "left eye", "right eye", "left ear", "right ear",
    "left shoulder", "right shoulder", "left elbow", "right elbow",
    "left wrist", "right wrist", "left hip", "right hip", "left knee",
    "right knee", "left ankle", "right ankle"]

CROWDPOSE_KEYPOINT_NAMES = [
    "left shoulder", "right shoulder", "left elbow", "right elbow",
    "left wrist", "right wrist", "left hip", "right hip",
    "left knee", "right knee", "left ankle", "right ankle",
    "head", "neck"]


@register_dataset("coco_pose")
class CocoPoseDataset:
    task = "pose"
    dataset_name = "coco_pose"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 image_token_len: int, test_mode: bool = False,
                 num_embs: int = 4, num_body_points: int = 68,
                 max_gt_per_img: int = 20, image_size: int = 336,
                 image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_scale=None, train_scales=None, buckets=None,
                 keypoint_names: Optional[List[str]] = None):
        self.coco = CocoIndex(ann_file, filter_empty=not test_mode)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.image_token_len = image_token_len
        self.test_mode = test_mode
        self.num_embs = num_embs
        self.nb = num_body_points
        self.max_gt = max_gt_per_img
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.kpt_names = keypoint_names or COCO_KEYPOINT_NAMES
        self.test_scale = test_scale or TEST_SCALE
        self.train_scales = train_scales or TRAIN_SCALES
        self.buckets = buckets or DEFAULT_BUCKETS
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.coco)

    def _keypoints(self, idx: int):
        """The image's annotated instances (not crowd, with keypoints):
        keypoints [N, K, 3] pixel (x, y, v) and boxes xyxy [N, 4]."""
        anns = [a for a in self.coco.anns_by_image[self.coco.img_ids[idx]]
                if not a.get("iscrowd", 0) and a.get("num_keypoints", 0) > 0]
        K = len(self.kpt_names)
        if not anns:
            return (np.zeros((0, K, 3), np.float32),
                    np.zeros((0, 4), np.float32))
        kps = np.stack([np.asarray(a["keypoints"], np.float32).reshape(K, 3)
                        for a in anns])
        boxes = np.asarray([[x, y, x + w, y + h]
                            for x, y, w, h in (a["bbox"] for a in anns)],
                           np.float32)
        return kps, boxes

    def _sample_kpt_classes(self, K: int) -> List[int]:
        """The train-time keypoint-class order of the answer slots: every
        class, shuffled."""
        order = list(range(K))
        self.rng.shuffle(order)
        return order

    def __getitem__(self, idx: int) -> Dict:
        info = self.coco.image_info(idx)
        img = load_image(os.path.join(self.img_prefix, info["file_name"]))
        kps, boxes = self._keypoints(idx)
        N, K = kps.shape[:2]

        sample = {"image": img, "boxes": boxes,
                  "labels": np.zeros(N, np.int32)}
        if self.test_mode:
            sample0 = det_test_transform(sample, self.test_scale,
                                         self.buckets)
            q_det, a_det = T.DET_QUESTIONS[0], T.DET_YES[0]
            q_pose, a_pose = T.POSE_QUESTIONS[0], T.POSE_ANS[0]
            kpt_order = list(range(K))
        else:
            sample0 = det_train_transform(sample, self.rng,
                                          self.train_scales, self.buckets)
            q_det = self.rng.choice(T.DET_QUESTIONS)
            a_det = self.rng.choice(T.DET_YES)
            q_pose = self.rng.choice(T.POSE_QUESTIONS)
            a_pose = self.rng.choice(T.POSE_ANS)
            kpt_order = self._sample_kpt_classes(K)

        obj_cls = "person"
        det_blk = T.det_answer_tokens(self.num_embs)
        pose_blk = T.pose_answer_tokens(self.num_embs)
        kpt_list = [self.kpt_names[i] for i in kpt_order]
        q = ("<image>\n" + q_det.replace("<class>", obj_cls) + " "
             + q_pose.replace("<class>", ", ".join(kpt_list)))
        a = (a_det.replace("<class>", obj_cls + det_blk) + " "
             + a_pose.replace("<class>",
                              (pose_blk + ", ").join(kpt_list) + pose_blk))
        conversations = [{"from": "human", "value": q},
                         {"from": "gpt", "value": a}]
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
            "image_aug": sample0["image"].astype(np.float32),
            "pixel_mask": sample0["pixel_mask"],
            "img_metas": {
                "task": self.task, "dataset_name": self.dataset_name,
                "id2index": {0: 0},
                # answer slot s holds keypoint class kpt_order[s]
                "kpt_id2index": {int(c): s for s, c in enumerate(kpt_order)},
                "image_id": self.coco.img_ids[idx],
                "ori_shape": (info["height"], info["width"]),
                "img_shape": sample0["img_shape"],
            },
        }
        if not self.test_mode:
            out["targets"] = self._targets(img, kps, boxes, kpt_order,
                                           sample0["img_shape"])
        return out

    def _targets(self, img, kps, boxes, kpt_order, img_shape) -> Dict:
        """The padded targets: the annotation scaled by the resize, the
        keypoints in answer-slot order (slots past the sampled classes
        zero)."""
        hh, ww = img_shape
        fh, fw = hh / img.shape[0], ww / img.shape[1]
        n = min(len(kps), self.max_gt)
        nb = self.nb
        tgt_boxes = np.zeros((self.max_gt, 4), np.float32)
        tgt_kpts = np.zeros((self.max_gt, 3 * nb), np.float32)
        area = np.full((self.max_gt,), 1e-3, np.float32)
        valid = np.zeros((self.max_gt,), bool)
        if n:
            b = boxes[:n] * np.asarray([fw, fh, fw, fh], np.float32)
            tgt_boxes[:n] = (box_xyxy_to_cxcywh_np(b)
                             / np.asarray([ww, hh, ww, hh], np.float32))
            xy = kps[:n, :, :2] * np.asarray([[[fw / ww, fh / hh]]])
            v = (kps[:n, :, 2] > 0).astype(np.float32)
            S = len(kpt_order)
            tgt_kpts[:n, :2 * S] = xy[:, kpt_order].reshape(n, 2 * S)
            tgt_kpts[:n, 2 * nb:2 * nb + S] = v[:, kpt_order]
            wh = tgt_boxes[:n, 2:4]
            area[:n] = np.maximum(wh[:, 0] * wh[:, 1], 1e-4)
            valid[:n] = True
        return {"labels": np.zeros((self.max_gt,), np.int32),
                "boxes": tgt_boxes, "keypoints": tgt_kpts, "area": area,
                "valid": valid}


@register_dataset("crowdpose")
class CrowdPoseDataset(CocoPoseDataset):
    """CrowdPose keypoints: 14 keypoint classes, person objects."""

    dataset_name = "crowdpose"

    def __init__(self, *args, **kw):
        kw.setdefault("keypoint_names", CROWDPOSE_KEYPOINT_NAMES)
        super().__init__(*args, **kw)


@register_dataset("unikpt")
class UniKPTDataset(CocoPoseDataset):
    """UniKPT multi-species keypoints: the keypoint class names come from
    the annotation file's categories (stripped, lower case, "_" as a
    space; every category must list the same), and a train-time answer
    covers a random non-empty prefix of the shuffled classes."""

    dataset_name = "unikpt"

    def __init__(self, ann_file, *args, **kw):
        if "keypoint_names" not in kw:
            with open(ann_file) as f:
                cats = json.load(f).get("categories", [])
            kpt_lists = [c.get("keypoints", []) for c in cats]
            if kpt_lists:
                if any(k != kpt_lists[0] for k in kpt_lists[1:]):
                    raise ValueError("unikpt requires identical keypoint "
                                     "lists per category")
                kw["keypoint_names"] = [k.strip().lower().replace("_", " ")
                                        for k in kpt_lists[0]]
        super().__init__(ann_file, *args, **kw)

    def _sample_kpt_classes(self, K: int) -> List[int]:
        order = list(range(K))
        self.rng.shuffle(order)
        return order[:self.rng.randint(1, K)]
