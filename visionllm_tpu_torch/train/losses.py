"""Set-prediction losses of the det tool (counterpart of
`visionllm_tpu/train/losses.py`): focal and dice losses, the LM cross
entropy, point sampling of masks, the Hungarian matcher and the
Hungarian-matched detection loss over every decoder layer and the
two-stage encoder.

* Targets arrive padded to a fixed N per image with a validity mask.
* The matcher's cost is computed on the device; the assignment is solved
  on the host by `linear_sum_assignment`, a numpy port of the solver the
  JAX package calls (`optax.assignment.hungarian_algorithm`), step for
  step in float32, so ties (the `BIG` cost of padded targets) break the
  same way. The reference solves on the host too (scipy).
* Mask losses read `num_mask_points` points per matched mask, chosen by
  uncertainty from uniform draws. The draws come from `draw_mask_points`
  (a `torch.Generator`) and enter as tensors, so a test can feed the
  draws JAX made from its keys.
* `point_sample` is the dense hat-basis product of the JAX package, in
  float32: on a card it relies on PyTorch's default of full-precision
  float32 matrix products (no TF32).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from visionllm_tpu_torch.ops.box_ops import (box_cxcywh_to_xyxy,
                                             generalized_box_iou)
from visionllm_tpu_torch.parallel.global_batch import global_sum

BIG = 1e5
PointDraws = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# elementwise losses
# ---------------------------------------------------------------------------

def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Elementwise focal loss, no reduction (gamma 0 and alpha < 0 give
    plain binary cross entropy)."""
    p = torch.sigmoid(logits)
    ce = (-targets * F.logsigmoid(logits)
          - (1 - targets) * F.logsigmoid(-logits))
    loss = ce
    if gamma != 0:
        p_t = p * targets + (1 - p) * (1 - targets)
        loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss_points(pred_logits: torch.Tensor, targets: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Dice loss over point-sampled masks [B, N, P]; masked SUM over the
    valid [B, N] instances (the caller divides by num_boxes)."""
    probs = torch.sigmoid(pred_logits)
    numer = 2 * (probs * targets).sum(-1)
    denom = probs.sum(-1) + targets.sum(-1)
    loss = 1 - (numer + 1) / (denom + 1)
    return torch.where(valid, loss, torch.zeros_like(loss)).sum()


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = -100) -> torch.Tensor:
    """Next-token cross entropy with an ignore mask (HF causal-LM shift),
    a mean over the global batch's target tokens (`global_sum`)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    ce = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                         safe.reshape(-1).long(), reduction="none")
    ce = torch.where(valid.reshape(-1), ce, torch.zeros_like(ce))
    return ce.sum() / global_sum(valid.sum()).clamp(min=1)


# ---------------------------------------------------------------------------
# point sampling
# ---------------------------------------------------------------------------

def _point_sample_chunk(masks: torch.Tensor, points: torch.Tensor
                        ) -> torch.Tensor:
    """Separable bilinear sampling as two dense products with the hat
    bases max(0, 1 - |coord - i|), zero outside the grid (grid_sample's
    zero padding exactly)."""
    H, W = masks.shape[-2:]
    x = points[..., 0].float() * W - 0.5
    y = points[..., 1].float() * H - 0.5
    bx = (1.0 - (x[..., None] - torch.arange(
        W, dtype=torch.float32, device=x.device)).abs()).clamp(min=0.0)
    by = (1.0 - (y[..., None] - torch.arange(
        H, dtype=torch.float32, device=y.device)).abs()).clamp(min=0.0)
    t = torch.matmul(bx, masks.float().transpose(-1, -2))    # [..., P, H]
    return (by * t).sum(-1)


def point_sample(masks: torch.Tensor, points: torch.Tensor, *,
                 chunk: int = 8192) -> torch.Tensor:
    """Bilinear samples of [.., H, W] masks at normalized [.., P, 2] (x, y)
    points (grid_sample, align_corners=False), chunked over points."""
    P = points.shape[-2]
    if P <= chunk:
        return _point_sample_chunk(masks, points)
    return torch.cat([_point_sample_chunk(masks, points[..., s:s + chunk, :])
                      for s in range(0, P, chunk)], dim=-1)


def draw_mask_points(generator: torch.Generator, batch: int, max_gt: int,
                     cfg, device) -> PointDraws:
    """The uniform draws of one `uncertainty_points` call: the
    oversampled candidates [B, N, num_points * oversample, 2] and the
    random rest [B, N, num_points - importance share, 2]."""
    n_sampled = int(cfg.num_mask_points * cfg.oversample_ratio)
    n_rand = cfg.num_mask_points - int(cfg.importance_sample_ratio
                                       * cfg.num_mask_points)
    kw = dict(generator=generator, device=device)
    return (torch.rand(batch, max_gt, n_sampled, 2, **kw),
            torch.rand(batch, max_gt, n_rand, 2, **kw))


def uncertainty_points(draws: PointDraws, coarse_logits: torch.Tensor,
                       num_points: int, importance_ratio: float
                       ) -> torch.Tensor:
    """The most uncertain candidates (|logit| smallest) plus the random
    rest: coarse_logits [B, N, H, W] -> points [B, N, num_points, 2]."""
    pts, rand = draws
    uncertainty = -point_sample(coarse_logits, pts).abs()
    n_unc = int(importance_ratio * num_points)
    idx = torch.topk(uncertainty, n_unc, dim=-1).indices
    top = torch.gather(pts, 2, idx[..., None].expand(-1, -1, -1, 2))
    return torch.cat([top, rand], dim=2)


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------

def matching_cost(logits: torch.Tensor, boxes: torch.Tensor,
                  targets: Dict[str, torch.Tensor], *, cfg) -> torch.Tensor:
    """[B, Q, N] Hungarian cost of one layer's outputs (reference matcher:
    focal class cost at the target's label, L1 and -GIoU box costs);
    padded target slots cost BIG."""
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
    cost = (cfg.bbox_cost * cost_bbox + cfg.class_cost * cost_class
            + cfg.giou_cost * cost_giou)
    valid = targets["valid"].bool()[:, None, :]
    return torch.where(valid, cost, torch.full_like(cost, BIG))


def linear_sum_assignment(cost: np.ndarray) -> np.ndarray:
    """Column of each row of a [rows, cols] cost (rows <= cols), minimum
    total cost. A float32 numpy port of the shortest-augmenting-path
    solver of `optax.assignment.hungarian_algorithm` (1-based potentials
    u, v, `parent` maps columns to rows), so it breaks ties as that one
    does."""
    cost = np.asarray(cost, np.float32)
    rows, cols = cost.shape
    if rows > cols:
        raise ValueError(f"linear_sum_assignment: {rows} rows > {cols} "
                         "columns")
    u = np.zeros(rows + 2, np.float32)
    v = np.zeros(cols + 1, np.float32)
    parent = np.zeros(cols + 1, np.int64)
    inf = np.float32(np.inf)
    for row in range(rows):
        parent[0] = row + 1
        path = np.zeros(cols, np.int64)
        used = np.zeros(cols + 1, bool)
        minv = np.full(cols, inf, np.float32)
        col = 0
        while parent[col] != 0:
            used[col] = True
            unused = ~used[1:]
            r = parent[col]
            cur = np.where(unused, cost[r - 1] - u[r] - v[1:], inf)
            better = cur < minv
            path = np.where(better, col, path)
            minv = np.where(better, cur, minv)
            masked = np.where(unused, minv, inf)
            col = int(np.argmin(masked)) + 1
            delta = masked.min()
            np.add.at(u, np.where(used, parent, rows + 1), delta)
            v = np.where(used, v - delta, v)
            minv = np.where(unused, minv - delta, minv)
        while col != 0:                     # back along the path
            prev = path[col - 1]
            parent[col] = parent[prev]
            col = prev
    match = np.zeros(rows, np.int64)
    assigned = np.nonzero(parent[1:])[0]
    match[parent[1:][assigned] - 1] = assigned
    return match


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """cost [B, Q, N] (N <= Q) -> matched query of each target [B, N], on
    the cost's device. Solved on the host."""
    c = cost.detach().float().cpu().numpy()
    out = np.stack([linear_sum_assignment(ci.T) for ci in c])
    return torch.from_numpy(out).to(cost.device)


# ---------------------------------------------------------------------------
# criterion
# ---------------------------------------------------------------------------

def detection_loss(outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], *, cfg,
                   match: torch.Tensor, num_boxes: torch.Tensor,
                   points=None
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """Hungarian-matched det/seg loss of one layer's outputs (logits
    [B, Q, T], pred_boxes [B, Q, 4], pred_masks [B, Q, h, w]?, text_mask
    [B, T]?) for the assignment `match` [B, N]; weighted by the cfg
    coefficients. The mask losses need `points`: the draws of
    `draw_mask_points`, from which the uncertain points are chosen, or
    the chosen points [B, N, num_points, 2] themselves. Returns (losses,
    the chosen points or None)."""
    logits, boxes = outputs["logits"], outputs["pred_boxes"]
    B, Q, T = logits.shape
    N = targets["labels"].shape[1]
    tgt_valid = targets["valid"].bool()
    vf = tgt_valid.float()
    zero = torch.zeros((), device=logits.device)

    # class: binary focal over [B, Q, T], positives at (matched query, label)
    onehot = torch.zeros(B, Q, T, device=logits.device)
    b_idx = torch.arange(B, device=logits.device)[:, None].expand(B, N)
    onehot.index_put_((b_idx, match, targets["labels"].long()), vf,
                      accumulate=True)
    onehot = onehot.clamp(0.0, 1.0)
    focal = sigmoid_focal_loss(logits, onehot, cfg.focal_alpha, 2.0)
    text_mask = outputs.get("text_mask")
    if text_mask is not None:
        focal = torch.where(text_mask[:, None, :], focal,
                            torch.zeros_like(focal))
    loss_class = focal.sum() / num_boxes

    # boxes on the matched pairs
    tgt_boxes = targets["boxes"].float()
    matched = torch.gather(boxes, 1, match[..., None].expand(-1, -1, 4))
    l1 = (matched - tgt_boxes).abs().sum(-1)
    loss_bbox = torch.where(tgt_valid, l1, zero).sum() / num_boxes
    giou = generalized_box_iou(box_cxcywh_to_xyxy(matched),
                               box_cxcywh_to_xyxy(tgt_boxes))
    giou_diag = torch.diagonal(giou, dim1=1, dim2=2)
    loss_giou = torch.where(tgt_valid, 1 - giou_diag, zero).sum() / num_boxes

    losses = {"loss_class": cfg.class_loss_coef * loss_class,
              "loss_bbox": cfg.bbox_loss_coef * loss_bbox,
              "loss_giou": cfg.giou_loss_coef * loss_giou}

    pred_masks = outputs.get("pred_masks")
    if pred_masks is not None and "masks" in targets:
        if points is None:
            raise ValueError("detection_loss: the mask losses need point "
                             "draws")
        h, w = pred_masks.shape[-2:]
        matched_masks = torch.gather(
            pred_masks, 1, match[..., None, None].expand(-1, -1, h, w))
        pts = points if torch.is_tensor(points) else uncertainty_points(
            points, matched_masks.detach(), cfg.num_mask_points,
            cfg.importance_sample_ratio)
        pred_pts = point_sample(matched_masks, pts)
        with torch.no_grad():
            tgt_pts = point_sample(targets["masks"].float(), pts)
        bce = sigmoid_focal_loss(pred_pts, tgt_pts, alpha=-1.0, gamma=0.0)
        loss_mask = (torch.where(tgt_valid, bce.mean(-1), zero).sum()
                     / num_boxes)
        loss_dice = dice_loss_points(pred_pts, tgt_pts, tgt_valid) / num_boxes
        losses["loss_mask"] = cfg.mask_loss_coef * loss_mask
        losses["loss_dice"] = cfg.dice_loss_coef * loss_dice
        return losses, pts
    return losses, None


def detection_loss_with_aux(outputs: Dict[str, torch.Tensor],
                            targets: Dict[str, torch.Tensor], *, cfg,
                            points: Optional[Sequence] = None,
                            matches: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                       Dict[str, object]]:
    """Main + per-decoder-layer aux + two-stage encoder losses. `points`
    holds one entry per decoder layer (draws or chosen points, see
    `detection_loss`; the encoder output has no masks). All matchings are
    solved in one host call unless `matches` [K, B, N] is given. Returns
    (total, detail dict, the step's choices: matches and the chosen
    points of each layer), so a second run can repeat the same choices."""
    tgt_valid = targets["valid"].bool()
    num_boxes = global_sum(tgt_valid.sum().float()).clamp(min=1.0)
    n_layers = outputs["all_logits"].shape[0]
    text_mask = outputs.get("text_mask")

    layer_outs: List[Dict[str, torch.Tensor]] = []
    for lvl in range(n_layers):
        o = {"logits": outputs["all_logits"][lvl],
             "pred_boxes": outputs["all_boxes"][lvl], "text_mask": text_mask}
        if "all_masks" in outputs:
            o["pred_masks"] = outputs["all_masks"][lvl]
        layer_outs.append(o)
    all_outs = list(layer_outs)
    if cfg.two_stage and "enc_logits" in outputs:
        all_outs.append({"logits": outputs["enc_logits"],
                         "pred_boxes": outputs["enc_boxes"],
                         "text_mask": text_mask})

    if matches is None:
        with torch.no_grad():
            costs = torch.stack([matching_cost(o["logits"], o["pred_boxes"],
                                               targets, cfg=cfg)
                                 for o in all_outs])
        K, B, Q, N = costs.shape
        matches = hungarian_match(costs.reshape(K * B, Q, N)).reshape(K, B, N)

    detail: Dict[str, torch.Tensor] = {}
    chosen = []
    total = torch.zeros((), device=outputs["all_logits"].device)
    for k, o in enumerate(all_outs):
        pts = points[k] if points is not None and k < n_layers else None
        losses, pts = detection_loss(o, targets, cfg=cfg, match=matches[k],
                                     num_boxes=num_boxes, points=pts)
        if k < n_layers:
            chosen.append(pts)
        if k == n_layers:
            suffix = "_enc"
        else:
            suffix = "" if k == n_layers - 1 else f"_aux{k}"
        for name, val in losses.items():
            detail[name + suffix] = val
            total = total + val
    return total, detail, {"matches": matches, "points": chosen}
