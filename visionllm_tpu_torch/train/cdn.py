"""Contrastive denoising (CDN) queries and their loss (counterpart of
`visionllm_tpu/train/cdn.py`).

The gt buffer is padded to a static N per image (`targets["valid"]` marks
real rows), so the dn block is [G groups x 2 (positive, negative) x N]:
rows [g 2N, g 2N + N) of group g are positives, the next N negatives.
Invalid slots are attention-blocked and loss-masked.

The noise comes from `draw_cdn_noise` (a `torch.Generator`, one call per
step) and enters `build_cdn_queries` as tensors, so a test can feed the
draws JAX made from its keys: `flip` and `label` are the uniforms of the
label jitter (JAX `r_lab`, `r_new`), `sign` the ±1 and `part` the uniform
of the box jitter (`r_sign`, `r_part`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from visionllm_tpu_torch.ops.box_ops import (box_cxcywh_to_xyxy,
                                             generalized_box_iou,
                                             inverse_sigmoid)
from visionllm_tpu_torch.parallel.global_batch import global_sum
from visionllm_tpu_torch.train.losses import sigmoid_focal_loss


def cdn_groups(dn_number: int, max_gt: int) -> int:
    return max(1, dn_number // max_gt)


def draw_cdn_noise(generator: torch.Generator, batch: int, max_gt: int,
                   dn_number: int, device) -> Dict[str, torch.Tensor]:
    """The draws of one `build_cdn_queries` call: flip, label [B, G, 2, N]
    uniforms; sign [B, G, 2, N, 4] ±1; part [B, G, 2, N, 4] uniform."""
    shape = (batch, cdn_groups(dn_number, max_gt), 2, max_gt)
    kw = dict(generator=generator, device=device)
    return {
        "flip": torch.rand(shape, **kw),
        "label": torch.rand(shape, **kw),
        "sign": torch.randint(0, 2, shape + (4,), **kw).float() * 2.0 - 1.0,
        "part": torch.rand(shape + (4,), **kw),
    }


def build_cdn_queries(
    noise: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],    # labels [B,N], boxes [B,N,4], valid
    text_query: torch.Tensor,            # [B, P, C] projected text queries
    text_query_masks: torch.Tensor,      # [B, P]
    *,
    dn_number: int = 100,
    label_noise_ratio: float = 0.5,
    box_noise_scale: float = 1.0,
    num_queries: int = 900,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (dn dict for the decoder, dn_targets for the loss)."""
    labels, boxes = targets["labels"], targets["boxes"].float()
    valid = targets["valid"].bool()
    B, N = labels.shape
    P = text_query.shape[1]
    G = cdn_groups(dn_number, N)
    pad = G * 2 * N
    dev = labels.device

    lab_r = labels[:, None, None].expand(B, G, 2, N)
    box_r = boxes[:, None, None].expand(B, G, 2, N, 4)
    val_r = valid[:, None, None].expand(B, G, 2, N)

    # label jitter (prob ratio/2): replacements are drawn from the
    # sample's valid text-query slots only (they form a prefix)
    flip = noise["flip"] < label_noise_ratio * 0.5
    n_valid = text_query_masks.int().sum(1).clamp(min=1)
    new_lab = torch.floor(noise["label"] * n_valid[:, None, None, None]
                          .float()).to(lab_r.dtype)
    noisy_labels = torch.where(flip, new_lab, lab_r)

    # box jitter in xyxy, half-extent scaled; negatives get [1, 2)
    xyxy = box_cxcywh_to_xyxy(box_r)
    half = torch.cat([box_r[..., 2:] / 2, box_r[..., 2:] / 2], -1)
    is_neg = (torch.arange(2, device=dev) == 1)[None, None, :, None, None]
    part = noise["part"] + is_neg.float()
    noisy_xyxy = (xyxy + noise["sign"] * part * half
                  * box_noise_scale).clamp(0.0, 1.0)
    cxcy = (noisy_xyxy[..., :2] + noisy_xyxy[..., 2:]) / 2
    wh = noisy_xyxy[..., 2:] - noisy_xyxy[..., :2]
    noisy_boxes = torch.cat([cxcy, wh], -1)

    # embeddings: the projected text query at the (noisy) class slot
    flat_lab = noisy_labels.reshape(B, pad).clamp(0, P - 1)
    query_label = torch.gather(
        text_query, 1,
        flat_lab[..., None].expand(-1, -1, text_query.shape[-1]))
    query_bbox = inverse_sigmoid(noisy_boxes.reshape(B, pad, 4))

    # attention mask [B, pad + Q, pad + Q], True = blocked
    total = pad + num_queries
    grp = torch.arange(pad, device=dev) // (2 * N)
    mask = torch.zeros(total, total, dtype=torch.bool, device=dev)
    mask[:pad, :pad] = grp[:, None] != grp[None, :]
    mask[pad:, :pad] = True                  # matching queries can't see dn
    invalid_col = torch.cat(
        [~val_r.reshape(B, pad),
         torch.zeros(B, num_queries, dtype=torch.bool, device=dev)], 1)
    mask = mask[None] | invalid_col[:, None, :]

    dn = {"query_label": query_label, "query_bbox": query_bbox,
          "attn_mask": mask, "pad_size": pad}
    is_pos = (torch.arange(2, device=dev) == 0)[None, None, :, None]
    dn_targets = {
        "labels": lab_r.reshape(B, pad),
        "boxes": box_r.reshape(B, pad, 4),
        "valid": val_r.reshape(B, pad),
        "is_positive": is_pos.expand(B, G, 2, N).reshape(B, pad),
    }
    return dn, dn_targets


def _diag_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched diagonal of the pairwise GIoU of cxcywh boxes [B, n, 4]."""
    g = generalized_box_iou(box_cxcywh_to_xyxy(a), box_cxcywh_to_xyxy(b))
    return torch.diagonal(g, dim1=-2, dim2=-1)


def dn_loss(
    dn_logits: torch.Tensor,        # [B, pad, T]
    dn_boxes: torch.Tensor,         # [B, pad, 4]
    dn_targets: Dict[str, torch.Tensor],
    *,
    cfg,                            # GDinoConfig
    text_mask: Optional[torch.Tensor] = None,    # [B, T]
    num_boxes: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Denoising loss with known correspondence: positives classify and
    regress to their own gt, negatives are background."""
    B, pad, T = dn_logits.shape
    valid = dn_targets["valid"].bool()
    pos = dn_targets["is_positive"].bool() & valid
    if num_boxes is None:
        num_boxes = global_sum(pos.sum().float()).clamp(min=1.0)

    onehot = F.one_hot(dn_targets["labels"].long().clamp(0, T - 1),
                       T).float() * pos[..., None].float()
    focal = sigmoid_focal_loss(dn_logits, onehot, cfg.focal_alpha, 2.0)
    if text_mask is not None:
        focal = torch.where(text_mask[:, None, :], focal,
                            torch.zeros_like(focal))
    focal = torch.where(valid[..., None], focal, torch.zeros_like(focal))
    loss_class = focal.sum() / num_boxes

    zero = torch.zeros((), device=dn_boxes.device)
    l1 = (dn_boxes - dn_targets["boxes"]).abs().sum(-1)
    loss_bbox = torch.where(pos, l1, zero).sum() / num_boxes
    giou = 1 - _diag_giou(dn_boxes, dn_targets["boxes"])
    loss_giou = torch.where(pos, giou, zero).sum() / num_boxes
    return {
        "dn_loss_class": cfg.class_loss_coef * loss_class,
        "dn_loss_bbox": cfg.bbox_loss_coef * loss_bbox,
        "dn_loss_giou": cfg.giou_loss_coef * loss_giou,
    }
