"""Set-prediction losses of the pose tool (counterpart of
`visionllm_tpu/train/pose_losses.py`): the Hungarian matcher with
keypoint and OKS costs, and the focal, L1, GIoU, keypoint L1 and OKS
losses of every UniPose decoder layer and the two-stage encoder.

Keypoints are laid out "xyxy..vv": the first 2 K values are the x, y
pairs, the last K the visibility flags, normalized to the image. Targets
are padded to a fixed N per image with a validity mask. The costs are
computed on the device and the assignments solved on the host by
`train.losses.linear_sum_assignment` (the JAX package solves with optax's
on-device Hungarian solver, which the host solver repeats step for step),
all layers' at once. `pose_loss_with_aux` returns its matchings, and
takes them back to repeat them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from visionllm_tpu_torch.ops.box_ops import (box_cxcywh_to_xyxy,
                                             generalized_box_iou)
from visionllm_tpu_torch.parallel.global_batch import global_sum
from visionllm_tpu_torch.train.losses import (BIG, hungarian_match,
                                              sigmoid_focal_loss)

# COCO keypoint sigmas (17), the UniKPT joints past them at 0.25; / 10
COCO_SIGMAS_17 = np.asarray(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89], np.float32)
# matcher weights of the keypoint L1 and OKS costs
KPT_COST, OKS_COST = 10.0, 4.0


def pose_sigmas(num_body_points: int) -> np.ndarray:
    if num_body_points <= 17:
        s = COCO_SIGMAS_17[:num_body_points]
    else:
        s = np.concatenate([COCO_SIGMAS_17,
                            np.full(num_body_points - 17, 0.25, np.float32)])
    return s / 10.0


def oks(pred_xy: torch.Tensor, gt_xy: torch.Tensor, vis: torch.Tensor,
        area: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """Object keypoint similarity of [..., K, 2] points against the gt's
    with visibilities [..., K] and areas [...]."""
    var = (sigmas * 2) ** 2
    d2 = ((pred_xy - gt_xy) ** 2).sum(-1)
    e = torch.exp(-d2 / (area[..., None] * var * 2))
    return (e * vis).sum(-1) / (vis.sum(-1) + 1e-6)


def _split_kpts(kp: torch.Tensor, K: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    xy = kp[..., :2 * K].reshape(*kp.shape[:-1], K, 2)
    return xy, kp[..., 2 * K:3 * K]


def _pose_cost(logits, boxes, kpts, targets, *, cfg, sigmas,
               with_keypoints: bool) -> torch.Tensor:
    """[B, Q, N] matching cost of one layer's outputs: focal class cost at
    the target's label, L1 and -GIoU box costs, and for a pose layer the
    visible keypoints' L1 and 1 - OKS; padded targets cost BIG."""
    K = cfg.num_body_points
    alpha, gamma = cfg.focal_alpha, 2.0
    prob = torch.sigmoid(logits.float())
    pos = alpha * (1 - prob) ** gamma * -torch.log(prob + 1e-8)
    neg = (1 - alpha) * prob ** gamma * -torch.log(1 - prob + 1e-8)
    lab = targets["labels"].long()
    B, Q, _ = prob.shape
    cost_class = torch.gather(pos - neg, 2,
                              lab[:, None, :].expand(B, Q, lab.shape[1]))
    tgt_boxes = targets["boxes"].float()
    cost_bbox = (boxes[:, :, None] - tgt_boxes[:, None]).abs().sum(-1)
    cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(boxes),
                                     box_cxcywh_to_xyxy(tgt_boxes))
    cost = (cfg.class_loss_coef * cost_class + cfg.bbox_loss_coef * cost_bbox
            + cfg.giou_loss_coef * cost_giou)
    if with_keypoints:
        p_xy, _ = _split_kpts(kpts, K)                         # [B, Q, K, 2]
        g_xy, g_v = _split_kpts(targets["keypoints"].float(), K)
        diff = p_xy[:, :, None] - g_xy[:, None]                # [B, Q, N, K, 2]
        e = torch.exp(-(diff ** 2).sum(-1)
                      / (targets["area"].float()[:, None, :, None]
                         * (sigmas * 2) ** 2 * 2))
        oks_qn = (e * g_v[:, None]).sum(-1) / (g_v.sum(-1)[:, None] + 1e-6)
        cost_oks = 1 - oks_qn.clamp(min=1e-6)
        cost_kpt = (diff.abs() * g_v[:, None, :, :, None]).sum((-1, -2))
        cost = cost + KPT_COST * cost_kpt + OKS_COST * cost_oks
    valid = targets["valid"].bool()[:, None, :]
    return torch.where(valid, cost, torch.full_like(cost, BIG))


def pose_loss(outputs: Dict[str, torch.Tensor],
              targets: Dict[str, torch.Tensor], *, cfg,
              match: torch.Tensor, num_boxes: torch.Tensor,
              with_keypoints: bool = True) -> Dict[str, torch.Tensor]:
    """The pose losses of one layer's outputs (pred_logits [B, Q, T],
    pred_boxes [B, Q, 4], pred_keypoints [B, Q, 3K]) for the assignment
    `match` [B, N]: focal class, L1 and GIoU box losses, and with
    keypoints the visible keypoints' L1 and 1 - OKS (both weighted by
    keypoint_loss_coef, as the JAX package and its reference weight OKS)."""
    K = cfg.num_body_points
    logits, boxes = outputs["pred_logits"], outputs["pred_boxes"]
    B, Q, T = logits.shape
    N = targets["labels"].shape[1]
    tgt_valid = targets["valid"].bool()
    zero = torch.zeros((), device=logits.device)

    onehot = torch.zeros(B, Q, T, device=logits.device)
    b_idx = torch.arange(B, device=logits.device)[:, None].expand(B, N)
    onehot.index_put_((b_idx, match, targets["labels"].long()),
                      tgt_valid.float(), accumulate=True)
    focal = sigmoid_focal_loss(logits, onehot.clamp(0.0, 1.0),
                               cfg.focal_alpha, 2.0)
    loss_class = focal.sum() / num_boxes

    tgt_boxes = targets["boxes"].float()
    m_boxes = torch.gather(boxes, 1, match[..., None].expand(-1, -1, 4))
    l1 = (m_boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = torch.where(tgt_valid, l1, zero).sum() / num_boxes
    giou = torch.diagonal(generalized_box_iou(box_cxcywh_to_xyxy(m_boxes),
                                              box_cxcywh_to_xyxy(tgt_boxes)),
                          dim1=1, dim2=2)
    loss_giou = torch.where(tgt_valid, 1 - giou, zero).sum() / num_boxes
    losses = {"loss_class": cfg.class_loss_coef * loss_class,
              "loss_bbox": cfg.bbox_loss_coef * loss_bbox,
              "loss_giou": cfg.giou_loss_coef * loss_giou}
    if with_keypoints:
        kpts = outputs["pred_keypoints"]
        m_kpts = torch.gather(kpts, 1,
                              match[..., None].expand(-1, -1, kpts.shape[-1]))
        p_xy, _ = _split_kpts(m_kpts, K)
        g_xy, g_v = _split_kpts(targets["keypoints"].float(), K)
        l1k = ((p_xy - g_xy).abs() * g_v[..., None]).sum((-1, -2))
        loss_kpt = torch.where(tgt_valid, l1k, zero).sum() / num_boxes
        sigmas = torch.from_numpy(pose_sigmas(K)).to(logits.device)
        o = oks(p_xy, g_xy, g_v, targets["area"].float(), sigmas)
        loss_oks = torch.where(tgt_valid, 1.0 - o.clamp(min=1e-6),
                               zero).sum() / num_boxes
        losses["loss_keypoints"] = cfg.keypoint_loss_coef * loss_kpt
        losses["loss_oks"] = cfg.keypoint_loss_coef * loss_oks
    return losses


def pose_loss_with_aux(outputs: Dict[str, object],
                       targets: Dict[str, torch.Tensor], *, cfg,
                       matches: Optional[List[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  List[torch.Tensor]]:
    """Every decoder layer's pose losses (box-only for the layers before
    `num_box_decoder_layers`; suffix `_aux<layer>` but for the last) and
    the two-stage encoder's box losses (`_interm`), on the outputs of
    `UniPose.forward(all_layers=True)`. The matchings [B, N] of each
    (layers, then the encoder) are solved in one host call unless
    `matches` gives them. Returns (total, detail, matches)."""
    tgt_valid = targets["valid"].bool()
    num_boxes = global_sum(tgt_valid.sum().float()).clamp(min=1.0)
    n = len(outputs["all_logits"])
    sigmas = torch.from_numpy(pose_sigmas(cfg.num_body_points)).to(
        tgt_valid.device)
    layers = []
    for lvl in range(n):
        with_kp = lvl >= cfg.num_box_decoder_layers
        layers.append(({"pred_logits": outputs["all_logits"][lvl],
                        "pred_boxes": outputs["all_boxes"][lvl],
                        "pred_keypoints": outputs["all_keypoints"][lvl]},
                       with_kp, "" if lvl == n - 1 else f"_aux{lvl}"))
    if "enc_logits" in outputs:
        layers.append(({"pred_logits": outputs["enc_logits"],
                        "pred_boxes": outputs["enc_boxes"]}, False,
                       "_interm"))
    if matches is None:
        with torch.no_grad():
            costs = [_pose_cost(o["pred_logits"], o["pred_boxes"],
                                o.get("pred_keypoints"), targets, cfg=cfg,
                                sigmas=sigmas, with_keypoints=kp)
                     for o, kp, _ in layers]
            host = [c.float().cpu() for c in costs]
        matches = [hungarian_match(c).to(tgt_valid.device) for c in host]
    total = torch.zeros((), device=tgt_valid.device)
    detail: Dict[str, torch.Tensor] = {}
    for (o, kp, suffix), match in zip(layers, matches):
        losses = pose_loss(o, targets, cfg=cfg, match=match,
                           num_boxes=num_boxes, with_keypoints=kp)
        for k, v in losses.items():
            detail[k + suffix] = v
            total = total + v
    return total, detail, matches
