"""Detection / instance-segmentation evaluation (counterpart of
`visionllm_tpu/eval/eval_det.py`, after the reference's eval_det.py:
107-158): the device half (`make_det_infer_fn`: one prefill forward
through `infer_det`, the flat top-k and the selected mask logits) and the
COCO loop (`evaluate_det`: shape-bucketed batches, the answer slots
mapped back to categories, boxes and masks finished on the host, box and
mask mAP).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from visionllm_tpu_torch.eval.batching import batched_samples
from visionllm_tpu_torch.eval.coco_eval import CocoMAPEvaluator
from visionllm_tpu_torch.eval.postprocess import (post_process_det,
                                                  post_process_masks_np,
                                                  scale_boxes_np, to_host)
from visionllm_tpu_torch.models.composite import VisionLLMWithTools
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops.rle import rle_encode

# the dataset arrays the model takes, in `make_det_infer_fn`'s order
MODEL_KEYS = ("input_ids", "image", "image_aug", "pixel_mask")


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


def model_inputs(arrays: Dict[str, np.ndarray], device) -> list:
    """A batch of `batched_samples` as `MODEL_KEYS` tensors on `device`
    (ids as int64)."""
    out = [torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
           for k in MODEL_KEYS]
    out[0] = out[0].long()
    return out


def evaluate_det(model: VisionLLMWithTools, dataset, tid: SpecialTokenIds,
                 *, with_mask: bool = False, topk: int = 100,
                 limit: Optional[int] = None, progress: bool = True,
                 batch_size: int = 8) -> Dict[str, float]:
    """Box (and, `with_mask`, mask) mAP of `model` (on its device) over a
    test-mode `CocoDetDataset`: `bbox_mAP`, `bbox_mAP_50`, ... and
    `segm_*`. Samples of one shape bucket share a batch of `batch_size`;
    the answer slot of each detection maps back to its contiguous category
    through the sample's `id2index`."""
    num_classes = len(dataset.class_names)
    infer = make_det_infer_fn(model, tid, num_classes, topk)
    device = next(model.parameters()).device
    evaluator = CocoMAPEvaluator(num_classes, "bbox")
    seg_eval = CocoMAPEvaluator(num_classes, "segm") if with_mask else None
    n = min(len(dataset), limit) if limit else len(dataset)
    done = 0
    for idxs, samples, arrays, num_valid in batched_samples(
            dataset, n, batch_size, MODEL_KEYS):
        out = to_host(infer(*model_inputs(arrays, device)))
        for bi in range(num_valid):
            i, meta = idxs[bi], samples[bi]["img_metas"]
            ori = meta["ori_shape"]
            # answer slot -> contiguous category id (id2index inverted)
            index2id = {v: k for k, v in meta["id2index"].items()}
            labels = np.asarray([index2id.get(int(v), -1)
                                 for v in out["labels"][bi]])
            keep = labels >= 0
            det = {"scores": out["scores"][bi][keep], "labels": labels[keep],
                   "boxes": scale_boxes_np(out["boxes"][bi], ori)[keep]}
            ann = dataset.coco.load_anns(i, with_mask=with_mask)
            gt = {"labels": ann["labels"], "boxes": ann["boxes"]}
            evaluator.update(det, gt)
            if with_mask:
                masks = post_process_masks_np(
                    out["mask_logits"][bi, keep],
                    meta["img_shape"], ori)
                det["masks"] = [rle_encode(m) for m in masks]
                gt["masks"] = [rle_encode(m) for m in ann["masks"]]
                seg_eval.update(det, gt)
            done += 1
            if progress and done % 50 == 0:
                print(f"eval_det: {done}/{n}")
    results = {f"bbox_{k}": v for k, v in evaluator.summarize().items()}
    if seg_eval is not None:
        results.update(
            {f"segm_{k}": v for k, v in seg_eval.summarize().items()})
    return results
