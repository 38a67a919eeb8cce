"""The device half of detection inference (counterpart of
`visionllm_tpu/eval/eval_det.py:make_det_infer_fn`): one prefill forward
through `infer_det`, the flat top-k, and the selected mask logits. The
COCO evaluation loop is not ported."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from visionllm_tpu_torch.eval.postprocess import post_process_det
from visionllm_tpu_torch.models.composite import VisionLLMWithTools
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds


def make_det_infer_fn(model: VisionLLMWithTools, tid: SpecialTokenIds,
                      num_classes: int, topk: int = 100
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
    """(input_ids, images, images_aug, pixel_mask) -> device-side
    detections (`post_process_det`) + their mask logits [B, k, H/4, W/4]."""

    @torch.no_grad()
    def fn(input_ids, images, images_aug,
           pixel_mask: Optional[torch.Tensor] = None):
        out = model.infer_det(input_ids, images, images_aug, tid,
                              pixel_mask=pixel_mask)
        post = post_process_det(out["logits"], out["pred_boxes"],
                                num_classes, topk)
        masks = out["pred_masks"]
        sel = post["query_idx"][..., None, None].expand(
            -1, -1, *masks.shape[2:])
        return {**post, "mask_logits": torch.gather(masks, 1, sel)}

    return fn
