"""Referring-expression grounding evaluation (counterpart of
`visionllm_tpu/eval/eval_grd.py`, after the reference's RefCOCO eval):
the device half (`make_grd_infer_fn`: the top-scoring query of the single
grounding slot, its box, score and mask logits) and the loop
(`evaluate_grd`: Prec@0.5 of the predicted box against the expression's
gt box and, with masks, the cumulative IoU of the masks)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from visionllm_tpu_torch.data.coco import decode_segmentation
from visionllm_tpu_torch.eval.coco_eval import box_iou_xyxy
from visionllm_tpu_torch.eval.eval_det import MODEL_KEYS, model_inputs
from visionllm_tpu_torch.eval.postprocess import (post_process_masks_np,
                                                  scale_boxes_np, to_host)
from visionllm_tpu_torch.models.composite import VisionLLMWithTools
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy


def make_grd_infer_fn(model: VisionLLMWithTools, tid: SpecialTokenIds
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
    """(input_ids, images, images_aug, pixel_mask) -> box [B, 4] xyxy in
    [0, 1], score [B], mask_logits [B, H/4, W/4] of the argmax query of
    text slot 0."""

    @torch.no_grad()
    def fn(input_ids, images, images_aug,
           pixel_mask: Optional[torch.Tensor] = None):
        out = model.infer_det(input_ids, images, images_aug, tid,
                              pixel_mask=pixel_mask)
        logits = out["logits"][:, :, 0].float()         # [B, Q] slot 0
        best = logits.argmax(dim=1)
        rows = torch.arange(logits.shape[0], device=logits.device)
        box = box_cxcywh_to_xyxy(out["pred_boxes"].float())[rows, best]
        return {"box": box, "score": torch.sigmoid(logits[rows, best]),
                "mask_logits": out["pred_masks"][rows, best]}

    return fn


def evaluate_grd(model: VisionLLMWithTools, dataset, tid: SpecialTokenIds,
                 *, iou_thr: float = 0.5, limit: Optional[int] = None,
                 with_mask: bool = False) -> Dict[str, float]:
    """{"prec@0.5": share of expressions whose box has IoU >= `iou_thr`
    with the gt box} over a test-mode `RefCocoGrdDataset`, one expression
    a forward on the model's device; `with_mask` adds "cIoU", the summed
    intersection over the summed union of the predicted and gt masks."""
    infer = make_grd_infer_fn(model, tid)
    device = next(model.parameters()).device
    n = min(len(dataset), limit) if limit else len(dataset)
    hits = 0
    inter_sum, union_sum = 0.0, 0.0
    for i in range(n):
        s = dataset[i]
        arrays = {k: np.asarray(s[k])[None] for k in MODEL_KEYS}
        out = to_host(infer(*model_inputs(arrays, device)))
        meta = s["img_metas"]
        box = scale_boxes_np(out["box"][0][None], meta["ori_shape"])
        image_id, ann, _ = dataset.items[i]
        x, y, w, h = ann["bbox"]
        gt = np.asarray([[x, y, x + w, y + h]], np.float32)
        hits += int(box_iou_xyxy(box, gt)[0, 0] >= iou_thr)
        if with_mask:
            pm = post_process_masks_np(
                out["mask_logits"][0][None],
                meta["img_shape"], meta["ori_shape"])[0]
            info = dataset.images[image_id]
            gm = decode_segmentation(ann.get("segmentation"),
                                     info["height"], info["width"]) > 0
            inter_sum += float(np.logical_and(pm, gm).sum())
            union_sum += float(np.logical_or(pm, gm).sum())
    res = {"prec@0.5": hits / max(n, 1)}
    if with_mask:
        res["cIoU"] = inter_sum / max(union_sum, 1.0)
    return res
