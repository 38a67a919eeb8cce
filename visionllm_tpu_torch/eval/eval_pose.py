"""Keypoint evaluation (counterpart of `visionllm_tpu/eval/eval_pose.py`,
after the reference's eval_pose.py): pose post-processing, the OKS
matrix, keypoint mAP at OKS .50:.05:.95 on the port's COCO matcher
(`OksMAPEvaluator`), PCK, and the `evaluate_pose` loop. Host side in
numpy, but the model's forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from visionllm_tpu_torch.eval.batching import batched_samples
from visionllm_tpu_torch.eval.coco_eval import CocoMAPEvaluator, _match_image
from visionllm_tpu_torch.eval.eval_det import model_inputs
from visionllm_tpu_torch.eval.postprocess import to_host
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train.pose_losses import pose_sigmas


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


def oks_matrix(dt_kpts: np.ndarray, gt_kpts: np.ndarray,
               gt_areas: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """[Nd, Ng] OKS of detections [Nd, K, 3] against gts [Ng, K, 3]
    (pycocotools' computeOks: a visibility-masked gaussian per joint,
    normalized by the gt's area; 0 for a gt with no visible joint)."""
    out = np.zeros((len(dt_kpts), len(gt_kpts)))
    var = (sigmas * 2) ** 2
    for j in range(len(gt_kpts)):
        vis = gt_kpts[j, :, 2] > 0
        if vis.sum() == 0:
            continue
        d2 = ((dt_kpts[:, :, 0] - gt_kpts[j, :, 0]) ** 2
              + (dt_kpts[:, :, 1] - gt_kpts[j, :, 1]) ** 2)
        e = d2 / (2 * var[None, :] * max(gt_areas[j], 1e-6))
        out[:, j] = np.exp(-e)[:, vis].mean(-1)
    return out


class OksMAPEvaluator(CocoMAPEvaluator):
    """Keypoint mAP at OKS .50:.05:.95 (the COCO keypoints protocol, one
    class, the area range "all"): `update(det, gt)` per image, then
    `summarize()` -> AP, AP_50, AP_75."""

    def __init__(self, num_keypoints: int = 17, max_dets: int = 20):
        super().__init__(num_classes=1, iou_type="keypoints",
                         max_dets=max_dets)
        self.sigmas = pose_sigmas(num_keypoints)

    def update(self, det: Dict, gt: Dict) -> None:   # type: ignore[override]
        """det: scores [Nd], keypoints [Nd, K, 3]; gt: keypoints
        [Ng, K, 3], areas [Ng]?, iscrowd [Ng]?. A gt with no visible
        joint (or crowd) is ignored."""
        d_order = np.argsort(-det["scores"], kind="mergesort")[:self.max_dets]
        d_scores = det["scores"][d_order]
        d_kpts = det["keypoints"][d_order]
        g_kpts = gt["keypoints"]
        g_areas = np.asarray(gt.get("areas", np.ones(len(g_kpts))))
        g_crowd = np.asarray(gt.get("iscrowd", np.zeros(len(g_kpts))), bool)
        no_joint = (np.asarray([k[:, 2].sum() for k in g_kpts]) == 0
                    if len(g_kpts) else np.zeros(0, bool))
        g_ignore = g_crowd | no_joint
        ious = oks_matrix(d_kpts, g_kpts, g_areas, self.sigmas)
        g_order = np.argsort(g_ignore, kind="mergesort")
        rec = _match_image(d_scores, ious[:, g_order], g_ignore[g_order],
                           g_crowd[g_order])
        self._records.setdefault((0, "all"), []).append({
            "scores": d_scores, "dtm": rec["dtm"], "dt_ig": rec["dt_ig"],
            "num_gt": int(np.sum(~g_ignore))})

    def summarize(self) -> Dict[str, float]:        # type: ignore[override]
        ap = self._pr_for(0, "all")
        if ap is None:
            nan = float("nan")
            return {"AP": nan, "AP_50": nan, "AP_75": nan}
        return {"AP": float(ap.mean()), "AP_50": float(ap[0]),
                "AP_75": float(ap[5])}


def pck(dt_kpts: Sequence[np.ndarray], gt_kpts: Sequence[np.ndarray],
        bboxes: Sequence[np.ndarray], thr: float = 0.2) -> float:
    """Percentage of correct keypoints: a visible gt joint is correct when
    its prediction lies within thr x max(box w, h); one prediction per
    gt."""
    correct, total = 0, 0
    for d, g, b in zip(dt_kpts, gt_kpts, bboxes):
        scale = max(b[2] - b[0], b[3] - b[1])
        vis = g[:, 2] > 0
        if vis.sum() == 0:
            continue
        dist = np.linalg.norm(d[:, :2] - g[:, :2], axis=-1)
        correct += int(((dist < thr * scale) & vis).sum())
        total += int(vis.sum())
    return correct / max(total, 1)


def evaluate_pose(model, dataset, tid: SpecialTokenIds, *,
                  num_obj_patches: int = 1, topk: int = 20,
                  limit: Optional[int] = None, progress: bool = False,
                  batch_size: int = 8) -> Dict[str, float]:
    """OKS keypoint mAP of `model` (on its device) over a test-mode
    `CocoPoseDataset`: `infer_pose` on shape-bucketed batches, the top-k
    groups of each image with their keypoint slots unshuffled to the
    dataset's keypoint classes by `kpt_id2index`, against the image's
    annotated instances (area from their boxes)."""
    device = next(model.parameters()).device
    K = len(dataset.kpt_names)
    ev = OksMAPEvaluator(num_keypoints=K, max_dets=topk)
    n = min(len(dataset), limit) if limit else len(dataset)
    done = 0
    for idxs, samples, arrays, num_valid in batched_samples(
            dataset, n, batch_size,
            ("input_ids", "image", "image_aug", "pixel_mask")):
        ids, images, aug, mask = model_inputs(arrays, device)
        raw = model.infer_pose(ids, images, aug, tid, num_obj_patches,
                               pixel_mask=mask)
        out = to_host({k: raw[k] for k in ("pred_logits", "pred_boxes",
                                           "pred_keypoints")})
        for bi in range(num_valid):
            meta = samples[bi]["img_metas"]
            det = post_process_pose(
                out["pred_logits"][bi], out["pred_boxes"][bi],
                out["pred_keypoints"][bi], meta["ori_shape"], topk=topk)
            kpt_id2index = meta["kpt_id2index"]
            order = np.asarray([kpt_id2index[c] for c in range(K)])
            gt_k, gt_boxes = dataset._keypoints(idxs[bi])
            areas = ((gt_boxes[:, 2] - gt_boxes[:, 0])
                     * (gt_boxes[:, 3] - gt_boxes[:, 1])) \
                if len(gt_boxes) else np.zeros(0)
            ev.update({"scores": det["scores"],
                       "keypoints": det["keypoints"][:, order]},
                      {"keypoints": gt_k, "areas": areas})
            done += 1
            if progress and done % 50 == 0:
                print(f"eval_pose: {done}/{n}")
    return ev.summarize()
