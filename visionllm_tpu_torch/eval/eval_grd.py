"""The device half of referring-expression grounding (counterpart of
`visionllm_tpu/eval/eval_grd.py:make_grd_infer_fn`): the top-scoring
query of the single grounding slot, its box, score and mask logits. The
Prec@0.5 evaluation loop is not ported."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

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
