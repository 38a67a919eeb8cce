"""Single-image perception inference, `Predictor` (counterpart of
`visionllm_tpu/infer.py`):

    p = Predictor(cfg, model, tokenizer)                # CUDA by default
    dets = p.detect(image, ["person", "dog"])           # boxes / scores
    box = p.ground(image, "the dog on the left")        # one box
    kpts = p.pose(image)                                # COCO keypoints

Each call builds the test-mode prompt of its task exactly as the JAX
`Predictor` does (det, grounding and pose templates at index 0, one
[DET]/[GRD]/[POSE][EMB..] block per class, expression or keypoint),
tokenizes it with `preprocess`, right-pads the ids to a multiple of 32
(pads follow the answer blocks, so under causal attention they cannot
reach the [EMB] positions the tools read), resizes the image with the
det test transform (keep-ratio to 800/1333, normalize, pad to a bucket)
and the CLIP preprocess, runs the model on the device (`infer_det` with
the device-side top-k, or `infer_pose`), and returns numpy results in
original-image pixels. The inputs go to the device once per request, and
the outputs come back in one transfer.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.mm_utils import clip_preprocess
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE,
                                                 det_test_transform)
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.eval.eval_det import make_det_infer_fn
from visionllm_tpu_torch.eval.eval_grd import make_grd_infer_fn
from visionllm_tpu_torch.eval.eval_pose import post_process_pose
from visionllm_tpu_torch.eval.postprocess import (post_process_masks_np,
                                                  scale_boxes_np)
from visionllm_tpu_torch.models.composite import (VisionLLMWithTools,
                                                  build_model)
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds

COCO_KEYPOINT_NAMES = [
    "nose", "left eye", "right eye", "left ear", "right ear",
    "left shoulder", "right shoulder", "left elbow", "right elbow",
    "left wrist", "right wrist", "left hip", "right hip", "left knee",
    "right knee", "left ankle", "right ankle",
]


def det_prompt(class_names: Sequence[str], num_embs: int = 4):
    """(question, answer) of a detection request: one [DET][EMB..]
    block per class."""
    q = "<image>\n" + T.DET_QUESTIONS[0].replace(
        "<class>", ", ".join(class_names))
    blk = T.det_answer_tokens(num_embs)
    a = T.DET_YES[0].replace("<class>", (blk + ", ").join(class_names) + blk)
    return q, a


def grd_prompt(expression: str, num_embs: int = 4):
    """(question, answer) of a grounding request: one [GRD][EMB..]
    block."""
    q = "<image>\n" + T.GRD_QUESTIONS[0].replace("<expression>", expression)
    a = T.GRD_YES[0].replace("<expression>", T.grd_answer_tokens(num_embs))
    return q, a


def pose_prompt(keypoint_names: Sequence[str],
                instance_class: str = "person", num_embs: int = 4):
    """(question, answer) of a pose request: a [DET][EMB..] block for the
    instance class, then one [POSE][EMB..] block per keypoint."""
    det_blk = T.det_answer_tokens(num_embs)
    pose_blk = T.pose_answer_tokens(num_embs)
    q = ("<image>\n" + T.DET_QUESTIONS[0].replace("<class>", instance_class)
         + " " + T.POSE_QUESTIONS[0].replace(
             "<class>", ", ".join(keypoint_names)))
    a = (T.DET_YES[0].replace("<class>", instance_class + det_blk)
         + " " + T.POSE_ANS[0].replace(
             "<class>", (pose_blk + ", ").join(keypoint_names) + pose_blk))
    return q, a


def prompt_ids(tokenizer, question: str, answer: str, *,
               image_tokens: int = 576, conv_version: str = "v1",
               model_max_length: int = 4096) -> np.ndarray:
    """The test-mode conversation's ids (the <image> sentinel expanded to
    `image_tokens` <im_patch> ids: `VisionLLMConfig.image_token_len`,
    576 for CLIP-L/336), right-padded to a multiple of 32."""
    conversations = [{"from": "human", "value": question},
                     {"from": "gpt", "value": answer}]
    tok = preprocess(
        preprocess_multimodal([conversations]), tokenizer,
        version=conv_version, has_image=True,
        image_token_len=image_tokens,
        model_max_length=model_max_length)
    ids = np.asarray(tok["input_ids"][0], np.int64)
    pad = (-len(ids)) % 32
    if pad:
        pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
        ids = np.concatenate([ids, np.full(pad, pad_id, np.int64)])
    return ids


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of `out` to numpy, with one wait for the device."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    if any(v.is_cuda for v in out.values()):
        torch.cuda.synchronize()
    return {k: v.numpy() for k, v in host.items()}


class Predictor:
    """Direct perception inference on numpy images.

    Args:
      cfg: VisionLLMConfig (the gdino tool for detect and ground, the
        unipose tool for pose).
      model: a `VisionLLMWithTools` on `device`, or None to build one
        with `build_model(cfg, device=device, dtype=dtype, seed=seed)`.
      tokenizer: a tokenizer with the special tokens added.
      device: CUDA unless given; raises when there is none.
    """

    def __init__(self, cfg: VisionLLMConfig,
                 model: Optional[VisionLLMWithTools], tokenizer, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 conv_version: str = "v1", num_embs: int = 4,
                 test_scale=TEST_SCALE, buckets=DEFAULT_BUCKETS,
                 model_max_length: int = 4096):
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device, dtype=dtype,
                                seed=seed)
        dev_of_model = next(model.parameters()).device
        if dev_of_model.type != self.device.type:
            raise ValueError(f"the model lives on {dev_of_model}, the "
                             f"predictor on {self.device}")
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.tid = SpecialTokenIds.from_tokenizer(tokenizer)
        self.conv_version = conv_version
        self.num_embs = num_embs
        self.test_scale = test_scale
        self.buckets = buckets
        self.model_max_length = model_max_length
        self.image_size = cfg.vis_encoder.image_size

    # ---- shared preprocessing ---------------------------------------

    def _prepare(self, image: np.ndarray, question: str, answer: str):
        """Image transforms + test-prompt tokenization -> device tensors
        (and the original and valid input shapes)."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] image, got {image.shape}")
        ori_shape = image.shape[:2]
        sample = det_test_transform(
            {"image": image.astype(np.float32),
             "boxes": np.zeros((0, 4), np.float32),
             "labels": np.zeros((0,), np.int32)},
            self.test_scale, self.buckets)
        clip_img = clip_preprocess(image, self.image_size)
        ids = prompt_ids(self.tokenizer, question, answer,
                         image_tokens=self.cfg.image_token_len,
                         conv_version=self.conv_version,
                         model_max_length=self.model_max_length)
        dev = self.device
        return {
            "input_ids": torch.from_numpy(ids[None]).to(dev),
            "image": torch.from_numpy(
                clip_img.astype(np.float32)[None]).to(dev),
            "image_aug": torch.from_numpy(
                sample["image"].astype(np.float32)[None]).to(dev),
            "pixel_mask": torch.from_numpy(sample["pixel_mask"][None]).to(dev),
            "ori_shape": ori_shape,
            "img_shape": sample["img_shape"],
        }

    @staticmethod
    def _model_args(arr):
        return (arr["input_ids"], arr["image"], arr["image_aug"],
                arr["pixel_mask"])

    # ---- detection ---------------------------------------------------

    def detect(self, image: np.ndarray, class_names: Sequence[str], *,
               threshold: float = 0.3, topk: int = 100,
               with_mask: bool = False) -> Dict[str, np.ndarray]:
        """Open-vocabulary detection: top-k boxes over the class list.

        Returns {"boxes" [N, 4] xyxy pixels, "scores" [N], "labels" [N]
        (indices into class_names), "class_names" [N]}, plus "masks"
        (list of [H, W] bool at the original resolution) if requested.
        """
        class_names = list(class_names)
        arr = self._prepare(image, *det_prompt(class_names, self.num_embs))
        out = make_det_infer_fn(self.model, self.tid, len(class_names),
                                topk)(*self._model_args(arr))
        if not with_mask:
            del out["mask_logits"]
        out = _to_host(out)
        scores = out["scores"][0]
        keep = scores >= threshold
        labels = out["labels"][0][keep]
        res = {
            "scores": scores[keep],
            "labels": labels,
            "boxes": scale_boxes_np(out["boxes"][0][keep], arr["ori_shape"]),
            "class_names": [class_names[int(i)] for i in labels],
        }
        if with_mask:
            res["masks"] = list(post_process_masks_np(
                out["mask_logits"][0][keep], arr["img_shape"],
                arr["ori_shape"]))
        return res

    # ---- referring-expression grounding -------------------------------

    def ground(self, image: np.ndarray, expression: str, *,
               with_mask: bool = False) -> Dict[str, np.ndarray]:
        """One box (the top-scoring query) for a referring expression:
        {"box" [4] xyxy pixels, "score"}, plus "mask" if requested."""
        arr = self._prepare(image, *grd_prompt(expression, self.num_embs))
        out = make_grd_infer_fn(self.model, self.tid)(*self._model_args(arr))
        if not with_mask:
            del out["mask_logits"]
        out = _to_host(out)
        res = {
            "box": scale_boxes_np(out["box"], arr["ori_shape"])[0],
            "score": float(out["score"][0]),
        }
        if with_mask:
            res["mask"] = post_process_masks_np(
                out["mask_logits"], arr["img_shape"], arr["ori_shape"])[0]
        return res

    # ---- pose ----------------------------------------------------------

    def pose(self, image: np.ndarray, *,
             keypoint_names: Optional[Sequence[str]] = None,
             instance_class: str = "person", threshold: float = 0.3,
             topk: int = 20) -> Dict[str, np.ndarray]:
        """Keypoint detection (the UniPose tool): instances + keypoints.

        Returns {"scores" [N], "boxes" [N, 4] xyxy pixels, "keypoints"
        [N, K, 3] (x, y, score) pixels, "keypoint_names" [K]} for the
        instances above `threshold`.
        """
        kpt_names = list(keypoint_names or COCO_KEYPOINT_NAMES)
        arr = self._prepare(image, *pose_prompt(kpt_names, instance_class,
                                                self.num_embs))
        ids, images, aug, pm = self._model_args(arr)
        out = self.model.infer_pose(ids, images, aug, self.tid, 1,
                                    pixel_mask=pm)
        out = _to_host({k: out[k] for k in ("pred_logits", "pred_boxes",
                                            "pred_keypoints")})
        det = post_process_pose(out["pred_logits"][0], out["pred_boxes"][0],
                                out["pred_keypoints"][0], arr["ori_shape"],
                                topk=topk)
        keep = det["scores"] >= threshold
        return {
            "scores": det["scores"][keep],
            "boxes": det["boxes"][keep],
            "keypoints": det["keypoints"][keep][:, :len(kpt_names)],
            "keypoint_names": kpt_names,
        }
