"""Pose post-processing (counterpart of
`visionllm_tpu/eval/eval_pose.py:post_process_pose`), in numpy on the
host. The OKS evaluator is not ported."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def post_process_pose(pred_logits: np.ndarray,     # [G, P]
                      pred_boxes: np.ndarray,      # [G, 4] cxcywh norm
                      pred_keypoints: np.ndarray,  # [G, 3K] xyxy..vv norm
                      ori_size: Tuple[int, int], topk: int = 20
                      ) -> Dict[str, np.ndarray]:
    """Top-k groups by their max class probability; keypoints to absolute
    (x, y, v) triplets [n, K, 3] and boxes to xyxy pixels."""
    K = pred_keypoints.shape[-1] // 3
    prob = 1 / (1 + np.exp(-pred_logits))
    scores_all = prob.max(-1)
    labels_all = prob.argmax(-1)
    order = np.argsort(-scores_all)[:topk]
    h, w = ori_size
    xy = pred_keypoints[order, :2 * K].reshape(-1, K, 2) * [[[w, h]]]
    v = pred_keypoints[order, 2 * K:].reshape(-1, K, 1)
    kpts = np.concatenate([xy, v], -1)
    cx, cy, bw, bh = (pred_boxes[order] * [w, h, w, h]).T
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                     -1)
    return {"scores": scores_all[order], "labels": labels_all[order],
            "boxes": boxes, "keypoints": kpts}
