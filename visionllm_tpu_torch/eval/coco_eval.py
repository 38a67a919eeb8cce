"""COCO-style mAP in numpy (counterpart of `visionllm_tpu/eval/coco_eval.py`,
which replaces pycocotools' COCOeval): greedy score-ordered matching at
IoU thresholds .50:.05:.95 over the area ranges all / small / medium /
large, at most 100 detections an image, 101-point interpolated AP, crowd
and ignore handling. Box IoU is vectorized numpy; mask IoU decodes the
RLE masks (`ops/rle.py:rle_iou`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from visionllm_tpu_torch.ops.rle import rle_iou

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def box_iou_xyxy(d: np.ndarray, g: np.ndarray,
                 iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """Pairwise IoU [Nd, Ng]; crowd gt uses intersection/det-area."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = area_d[:, None] + area_g[None] - inter
    if iscrowd is not None:
        for j, c in enumerate(iscrowd):
            if c:
                union[:, j] = area_d
    return inter / np.maximum(union, 1e-10)


def _match_image(
    det_scores: np.ndarray,       # [Nd] sorted desc by caller
    ious: np.ndarray,             # [Nd, Ng]
    gt_ignore: np.ndarray,        # [Ng] bool
    iscrowd: np.ndarray,          # [Ng] bool
) -> Dict[str, np.ndarray]:
    """Greedy COCO matching for one (image, category) over all IoU thrs.
    Returns dtm [T, Nd] (gt index + 1 or 0) and dt_ig [T, Nd]."""
    T = len(IOU_THRS)
    Nd, Ng = ious.shape
    gtm = np.zeros((T, Ng), np.int64)
    dtm = np.zeros((T, Nd), np.int64)
    dt_ig = np.zeros((T, Nd), bool)
    # gts sorted: unignored first (caller must order)
    for t, thr in enumerate(IOU_THRS):
        for di in range(Nd):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi in range(Ng):
                if gtm[t, gi] and not iscrowd[gi]:
                    continue
                # stop at ignored gt if a real match was already found
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            dtm[t, di] = best + 1
            gtm[t, best] = di + 1
            dt_ig[t, di] = gt_ignore[best]
    return {"dtm": dtm, "dt_ig": dt_ig}


class CocoMAPEvaluator:
    """update(det, gt) per image, then summarize() -> mAP dict.

    det_results: per image, dict(scores [N], labels [N], boxes [N,4] xyxy
    abs, optional masks list of RLE dicts).
    gts: per image, dict(labels, boxes xyxy abs, iscrowd [N], areas [N],
    optional masks list of RLE dicts).
    """

    def __init__(self, num_classes: int, iou_type: str = "bbox",
                 max_dets: int = 100):
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.max_dets = max_dets
        # eval_imgs[(cat, area)] = list of per-image match records
        self._records: Dict = {}

    def update(self, det: Dict, gt: Dict) -> None:
        for cat in range(self.num_classes):
            d_sel = np.where(det["labels"] == cat)[0]
            g_sel = np.where(gt["labels"] == cat)[0]
            if len(d_sel) == 0 and len(g_sel) == 0:
                continue
            order = np.argsort(-det["scores"][d_sel], kind="mergesort")
            d_sel = d_sel[order][:self.max_dets]
            d_scores = det["scores"][d_sel]
            d_boxes = det["boxes"][d_sel]
            g_boxes = gt["boxes"][g_sel]
            g_crowd = np.asarray(gt.get("iscrowd",
                                        np.zeros(len(gt["labels"]))),
                                 bool)[g_sel]
            g_areas = np.asarray(gt.get("areas", _box_areas(gt["boxes"])))[
                g_sel]
            d_areas = _box_areas(det["boxes"])[d_sel]

            if self.iou_type == "segm":
                d_rles = [det["masks"][i] for i in d_sel]
                g_rles = [gt["masks"][i] for i in g_sel]
                ious_all = rle_iou(d_rles, g_rles, g_crowd.tolist())
            else:
                ious_all = box_iou_xyxy(d_boxes, g_boxes, g_crowd)

            for area_name, (lo, hi) in AREA_RNGS.items():
                g_ignore = g_crowd | (g_areas < lo) | (g_areas > hi)
                # order gts: unignored first (COCO sorts by ignore flag)
                g_order = np.argsort(g_ignore, kind="mergesort")
                ious = ious_all[:, g_order]
                rec = _match_image(d_scores, ious, g_ignore[g_order],
                                   g_crowd[g_order])
                # dets outside the range that matched nothing -> ignore
                out_rng = (d_areas < lo) | (d_areas > hi)
                dt_ig = rec["dt_ig"] | ((rec["dtm"] == 0) & out_rng[None])
                self._records.setdefault((cat, area_name), []).append({
                    "scores": d_scores, "dtm": rec["dtm"], "dt_ig": dt_ig,
                    "num_gt": int(np.sum(~g_ignore)),
                })

    def _pr_for(self, cat: int, area: str) -> Optional[np.ndarray]:
        recs = self._records.get((cat, area))
        if not recs:
            return None
        num_gt = sum(r["num_gt"] for r in recs)
        if num_gt == 0:
            return None
        scores = np.concatenate([r["scores"] for r in recs])
        dtm = np.concatenate([r["dtm"] for r in recs], axis=1)
        dt_ig = np.concatenate([r["dt_ig"] for r in recs], axis=1)
        order = np.argsort(-scores, kind="mergesort")
        dtm, dt_ig = dtm[:, order], dt_ig[:, order]

        T = len(IOU_THRS)
        ap = np.zeros(T)
        for t in range(T):
            keep = ~dt_ig[t]
            tp = np.cumsum((dtm[t] > 0) & keep)
            fp = np.cumsum((dtm[t] == 0) & keep)
            rc = tp / num_gt
            pr = tp / np.maximum(tp + fp, 1e-10)
            # monotone precision envelope
            pr = np.maximum.accumulate(pr[::-1])[::-1]
            # 101-point interpolation
            idx = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            valid = idx < len(pr)
            q[valid] = pr[idx[valid]]
            ap[t] = q.mean()
        return ap

    def summarize(self) -> Dict[str, float]:
        per_cat = {a: [] for a in AREA_RNGS}
        ap50, ap75 = [], []
        for cat in range(self.num_classes):
            for area in AREA_RNGS:
                ap = self._pr_for(cat, area)
                if ap is None:
                    continue
                per_cat[area].append(ap.mean())
                if area == "all":
                    ap50.append(ap[0])
                    ap75.append(ap[5])

        def m(vals):
            return float(np.mean(vals)) if vals else float("nan")

        return {
            "mAP": m(per_cat["all"]),
            "mAP_50": m(ap50),
            "mAP_75": m(ap75),
            "mAP_s": m(per_cat["small"]),
            "mAP_m": m(per_cat["medium"]),
            "mAP_l": m(per_cat["large"]),
        }


def _box_areas(b: np.ndarray) -> np.ndarray:
    if len(b) == 0:
        return np.zeros(0)
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
