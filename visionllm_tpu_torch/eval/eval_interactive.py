"""Interactive (visual-prompt) detection evaluation (counterpart of
`visionllm_tpu/eval/eval_interactive.py`, after the reference's
eval_visual_prompt.py): each region prompt should ground its own object.
The model's box for region slot r is the query with the largest slot-r
logit; the metric is the share of regions whose box has IoU >= 0.5 with
the region's ground-truth box.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from visionllm_tpu_torch.eval.coco_eval import box_iou_xyxy
from visionllm_tpu_torch.eval.eval_det import model_inputs
from visionllm_tpu_torch.eval.postprocess import scale_boxes_np, to_host
from visionllm_tpu_torch.models.composite import VisionLLMWithTools
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy

# the dataset arrays the model takes, in `make_interactive_infer_fn`'s
# order
MODEL_KEYS = ("input_ids", "image", "image_aug", "pixel_mask", "regions")


def make_interactive_infer_fn(model: VisionLLMWithTools,
                              tid: SpecialTokenIds, max_regions: int
                              ) -> Callable[..., Dict[str, torch.Tensor]]:
    """(input_ids, images, images_aug, pixel_mask, regions) -> the best
    box of each region slot: "boxes" [B, R, 4] xyxy in [0, 1] and
    "scores" [B, R], the argmax over queries of slot r's logit."""

    @torch.no_grad()
    def fn(input_ids, images, images_aug, pixel_mask, regions):
        out = model.infer_det(input_ids, images, images_aug, tid,
                              pixel_mask=pixel_mask, regions=regions)
        logits = out["logits"][:, :, :max_regions].float()   # [B, Q, R]
        best = logits.argmax(dim=1)                           # [B, R]
        boxes = box_cxcywh_to_xyxy(out["pred_boxes"].float())
        picked = torch.gather(boxes, 1, best[..., None].expand(-1, -1, 4))
        scores = torch.sigmoid(torch.gather(logits, 1, best[:, None, :]))
        return {"boxes": picked, "scores": scores[:, 0]}

    return fn


def evaluate_interactive(model: VisionLLMWithTools, dataset,
                         tid: SpecialTokenIds, *, iou_thr: float = 0.5,
                         limit: Optional[int] = None) -> Dict[str, float]:
    """`region_acc@0.5` of `model` (on its device) over a test-mode
    `CocoInteractiveDataset`, one image a forward."""
    infer = make_interactive_infer_fn(model, tid, dataset.max_regions)
    device = next(model.parameters()).device
    n = min(len(dataset), limit) if limit else len(dataset)
    hits, total = 0, 0
    for i in range(n):
        s = dataset[i]
        out = to_host(infer(*model_inputs(
            {k: np.asarray(s[k])[None] for k in MODEL_KEYS}, device,
            MODEL_KEYS)))
        meta = s["img_metas"]
        gt = dataset.coco.load_anns(i)["boxes"][:s["num_regions"]]
        pred = scale_boxes_np(out["boxes"][0],
                              meta["ori_shape"])[:s["num_regions"]]
        for r in range(s["num_regions"]):
            iou = box_iou_xyxy(pred[r:r + 1], gt[r:r + 1])[0, 0]
            hits += int(iou >= iou_thr)
            total += 1
    return {"region_acc@0.5": hits / max(total, 1)}
