"""Detection / instance-segmentation post-processing (counterpart of
`visionllm_tpu/eval/postprocess.py`): sigmoid, a flat top-k over
(queries x classes) and cxcywh -> xyxy on the device; box scaling and
mask finishing (x stride bilinear upsample, crop the padding, resize to
the original size, sigmoid > 0.5) in numpy on the host. No NMS: top-k
only."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from visionllm_tpu_torch.data.mm_utils import resize_float
from visionllm_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy


def post_process_det(logits: torch.Tensor, pred_boxes: torch.Tensor,
                     num_classes: int, topk: int = 100
                     ) -> Dict[str, torch.Tensor]:
    """logits [B, Q, T] over text slots, pred_boxes [B, Q, 4] cxcywh in
    [0, 1] -> scores [B, k], labels [B, k], boxes [B, k, 4] xyxy in [0, 1]
    and query_idx [B, k]."""
    logits = logits[:, :, :num_classes]
    B, Q, K = logits.shape
    prob = torch.sigmoid(logits.float()).reshape(B, Q * K)
    scores, idx = torch.topk(prob, min(topk, Q * K), dim=1)
    q_idx = idx // K
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    boxes = torch.gather(boxes, 1, q_idx[..., None].expand(-1, -1, 4))
    return {"scores": scores, "labels": idx % K, "boxes": boxes,
            "query_idx": q_idx}


def scale_boxes_np(boxes_norm: np.ndarray,
                   ori_size: Tuple[int, int]) -> np.ndarray:
    h, w = ori_size
    return boxes_norm * np.asarray([w, h, w, h], np.float32)


def post_process_masks_np(mask_logits: np.ndarray,
                          img_shape: Tuple[int, int],
                          ori_shape: Tuple[int, int],
                          mask_stride: int = 4) -> np.ndarray:
    """[k, H/4, W/4] selected mask logits -> [k, *ori_shape] bool: upsample
    x stride, crop to the valid (unpadded) input size, resize to the
    original size (both Pillow's float bilinear), sigmoid > 0.5."""
    k, H, W = mask_logits.shape
    out = np.zeros((k, ori_shape[0], ori_shape[1]), bool)
    for i in range(k):
        m = resize_float(mask_logits[i], (H * mask_stride, W * mask_stride))
        m = resize_float(m[:img_shape[0], :img_shape[1]], ori_shape)
        out[i] = _sigmoid(m) > 0.5
    return out


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float32)))
