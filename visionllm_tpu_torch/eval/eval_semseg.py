"""Semantic segmentation (ADE20K-style) and salient-object evaluation
(counterpart of `visionllm_tpu/eval/eval_semseg.py`, after the
reference's eval_semseg.py and eval_sod.py): each prompted class is one
[SEG][EMB..] text slot; the top-k detections' mask logits, each raised by
its log score, make a per-class map whose argmax is the semantic map,
scored by a streaming confusion matrix (mIoU, aAcc).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from visionllm_tpu_torch.data.mm_utils import resize_image
from visionllm_tpu_torch.eval.eval_det import make_det_infer_fn, model_inputs
from visionllm_tpu_torch.eval.postprocess import to_host
from visionllm_tpu_torch.models.composite import VisionLLMWithTools
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds


def semantic_map_from_queries(
    logits: np.ndarray,          # [Q, K] class logits
    masks: np.ndarray,           # [Q, h, w] mask logits
    num_classes: int,
) -> np.ndarray:
    """Mask2Former-style semantic inference: sem[k] = sum_q p(q, k)
    sigmoid(mask_q), then the argmax over classes: [h, w] labels."""
    p = 1 / (1 + np.exp(-logits[:, :num_classes]))
    m = 1 / (1 + np.exp(-masks))
    sem = np.einsum("qk,qhw->khw", p, m)
    return sem.argmax(0)


class MIoUEvaluator:
    """Streaming confusion-matrix mIoU / aAcc (mmseg's metric)."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.K = num_classes
        self.ignore = ignore_index
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        valid = gt != self.ignore
        p = pred[valid].astype(np.int64)
        g = gt[valid].astype(np.int64)
        self.conf += np.bincount(g * self.K + p,
                                 minlength=self.K * self.K).reshape(
            self.K, self.K)

    def summarize(self) -> Dict[str, float]:
        inter = np.diag(self.conf).astype(np.float64)
        union = self.conf.sum(0) + self.conf.sum(1) - inter
        iou = inter / np.maximum(union, 1)
        present = self.conf.sum(1) > 0
        return {
            "mIoU": float(iou[present].mean()) if present.any() else 0.0,
            "aAcc": float(inter.sum() / max(self.conf.sum(), 1)),
        }


def sod_metrics(pred: Sequence[np.ndarray],
                gt: Sequence[np.ndarray]) -> Dict[str, float]:
    """Salient-object metrics: MAE and the max F-measure (beta^2 = 0.3)
    over 19 thresholds, eval_sod.py's two headline numbers."""
    maes, fbetas = [], []
    for p, g in zip(pred, gt):
        p = p.astype(np.float64)
        if p.max() > 1:
            p = p / 255.0
        g = (g > 0.5).astype(np.float64)
        maes.append(np.abs(p - g).mean())
        best = 0.0
        for t in np.linspace(0.05, 0.95, 19):
            b = p >= t
            tp = float((b * g).sum())
            prec = tp / max(b.sum(), 1)
            rec = tp / max(g.sum(), 1)
            f = (1.3 * prec * rec) / max(0.3 * prec + rec, 1e-9)
            best = max(best, f)
        fbetas.append(best)
    return {"MAE": float(np.mean(maes)),
            "maxF": float(np.mean(fbetas))}


def semantic_map_from_detections(out: Dict[str, np.ndarray], bi: int,
                                 id2index: Dict[int, int],
                                 num_classes: int) -> np.ndarray:
    """uint8 [H/4, W/4] class map of image `bi` of a `make_det_infer_fn`
    result on the host: per class, the max over its detections of (mask
    logit + log score), -1e4 where it has none; then the argmax."""
    h4 = out["mask_logits"].shape[-2:]
    sem_logits = np.full((num_classes, *h4), -1e4, np.float32)
    index2id = {v: k for k, v in id2index.items()}
    for q in range(out["scores"].shape[1]):
        cid = index2id.get(int(out["labels"][bi, q]))
        if cid is None:
            continue
        score = float(out["scores"][bi, q])
        m = np.asarray(out["mask_logits"][bi, q], np.float32)
        sem_logits[cid] = np.maximum(sem_logits[cid],
                                     m + np.log(max(score, 1e-6)))
    return sem_logits.argmax(0).astype(np.uint8)


def evaluate_semseg(model: VisionLLMWithTools, dataset,
                    tid: SpecialTokenIds, *, limit: Optional[int] = None,
                    progress: bool = False) -> Dict[str, float]:
    """mIoU and aAcc of `model` (on its device) over a test-mode
    `SemSegDataset`: one forward an image, the top-min(100, 4K)
    detections' masks to a class map, upsampled to the label's size by
    Pillow's nearest neighbour (`resize_image`), against the label as
    stored."""
    K = len(dataset.class_names)
    infer = make_det_infer_fn(model, tid, num_classes=K,
                              topk=min(100, K * 4))
    device = next(model.parameters()).device
    ev = MIoUEvaluator(K)
    n = min(len(dataset), limit) if limit else len(dataset)
    for i in range(n):
        s = dataset[i]
        arrays = {k: np.asarray(s[k])[None] for k in
                  ("input_ids", "image", "image_aug", "pixel_mask")}
        with torch.no_grad():
            out = to_host(infer(*model_inputs(arrays, device)))
        meta = s["img_metas"]
        pred4 = semantic_map_from_detections(out, 0, meta["id2index"], K)
        pred = resize_image(pred4, tuple(meta["ori_shape"]), "nearest")
        ev.update(pred, dataset.label(i))
        if progress and (i + 1) % 20 == 0:
            print(f"eval_semseg: {i + 1}/{n}")
    return ev.summarize()
