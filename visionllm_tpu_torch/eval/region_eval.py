"""Region-prompted generation evals (counterpart of
`visionllm_tpu/eval/region_eval.py`): region caption (VG / RefCOCOg /
VCR), region recognition (COCO / LVIS vocabularies) and region
classification (Osprey LVIS / PACO), after the reference's
eval_region_caption_*.py, eval_region_recognition.py and
eval_region_classification.py.

The prompt's region strings (`region_str`) and the masks' trip to the
CLIP input geometry (`boxes_to_masks`, `clip_region_masks`) live in
`data/mm_utils.py`, which serving shares; `run_region_generate` decodes
each row greedily with its regions conditioning the prefill through the
region encoder. The `load_*` functions read each task's annotation
format into rows, `materialize` reads their images (`load_image`, no
Pillow) and masks, the `score_*` functions give each task's metrics,
and `run_region_eval` runs one task end to end (`TASKS`: its loader,
scorer and the reference's `max_new_tokens`).

The reference scores region classification with SBERT sentence
similarity; with no downloaded weights, `bow_cosine` (a bag-of-words
cosine on the same 0-100 scale) stands in for it, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import Counter, defaultdict
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.constants import DEFAULT_TOKENS
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (boxes_to_masks,
                                               clip_preprocess,
                                               clip_region_masks,
                                               expand_image_tokens,
                                               find_stop, region_str,
                                               tokenizer_image_token)
from visionllm_tpu_torch.data.region_dataset import region_mask_from_ann
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.eval.caption import CiderD, bleu4

# the reference's region-eval prompts (first templates of each dataset)
REFG_QUESTION = ("Can you provide me with a brief description of "
                 "<spi_descript> in the picture?")
COCO_RECOG_QUESTION = (
    "Whis is the object category of <regions>? Answer with the category "
    "name from COCO-80, and use single word or phrase.")
LVIS_RECOG_QUESTION = (
    "Whis is the object category of <regions>? Answer with the category "
    "name from LVIS-1203, and use single word or phrase.")
OSPREY_CLS_QUESTION = ("What is the category of <regions>? Using only "
                       "one word or phrase.")


def _prompt_ids(question: str, tokenizer, image_tokens: int,
                conv_version: str) -> np.ndarray:
    """One user turn '<image>\\n' + question and an open answer, the image
    placeholder expanded to `image_tokens` <im_patch> ids
    (`VisionLLMConfig.image_token_len`)."""
    conv = get_conv_template(conv_version)
    conv.append_message(conv.roles[0], "<image>\n" + question)
    conv.append_message(conv.roles[1], None)
    ids = tokenizer_image_token(conv.get_prompt(), tokenizer)
    imp_id = tokenizer.convert_tokens_to_ids(DEFAULT_TOKENS["imp"])
    return expand_image_tokens(ids, image_tokens, imp_id)


def run_region_generate(
    generate_fn: Callable,
    cfg: VisionLLMConfig,
    tokenizer,
    rows: Sequence[Dict],
    *,
    conv_version: str = "vicuna_v1",
    device: Optional[Union[str, torch.device]] = None,
) -> List[Dict]:
    """Greedy-decode each region-prompted row ({"image": HWC uint8,
    "masks": [R, H, W], "question": str with the region strings inlined,
    ...}) through `generate_fn` (`generation.build_generate_fn` of a core
    of `cfg`, on `device`: CUDA unless given). Returns the rows without
    image and masks, each with "prediction": the answer up to the stop
    string, lowercased, a trailing '.' dropped (the reference's
    normalization)."""
    dev = resolve_device(device)
    size = cfg.vis_encoder.image_size
    conv = get_conv_template(conv_version)
    stop_strs = [conv.sep2 or conv.sep]
    out_rows = []
    for r in rows:
        ids = _prompt_ids(r["question"], tokenizer, cfg.image_token_len,
                          conv_version)
        image = clip_preprocess(r["image"], size, "pad")[None]
        regions = clip_region_masks(np.asarray(r["masks"]), size)
        out = generate_fn(
            torch.from_numpy(np.asarray(ids, np.int64))[None].to(dev),
            torch.from_numpy(image.astype(np.float32)).to(dev),
            regions=torch.from_numpy(regions)[None].to(dev))
        n = int(out["num_generated"])
        text = tokenizer.decode(out["out_tokens"][0, :n].cpu().numpy(),
                                skip_special_tokens=True)
        cut = find_stop(text, stop_strs)
        if cut is not None:
            text = text[:cut]
        text = text.strip().lower()
        if text.endswith("."):
            text = text[:-1]
        out_rows.append({**{k: v for k, v in r.items()
                            if k not in ("image", "masks")},
                         "prediction": text})
    return out_rows


# ---------------------------------------------------------------- loaders

def load_region_caption(ann_file: str, img_prefix: str, *,
                        test_format: str = "bbox",
                        limit: Optional[int] = None) -> List[Dict]:
    """COCO-caption-format json (the reference's
    refcocog_val_coco_format.json / VG equivalent): images + annotations
    carrying bbox/segmentation AND the gt caption(s). One row per
    annotated region; references grouped per region."""
    with open(ann_file) as f:
        data = json.load(f)
    imgs = {im["id"]: im for im in data["images"]}
    by_region: Dict[Tuple, Dict] = {}
    for ann in data["annotations"]:
        key = (ann["image_id"], tuple(ann.get("bbox", ())))
        row = by_region.setdefault(key, {
            "image_id": ann["image_id"],
            "file_name": imgs[ann["image_id"]]["file_name"],
            "height": imgs[ann["image_id"]]["height"],
            "width": imgs[ann["image_id"]]["width"],
            "ann": {k: ann.get(k) for k in ("bbox", "segmentation")},
            "captions": [],
        })
        if ann.get("caption"):
            row["captions"].append(ann["caption"])
    rows = []
    for row in by_region.values():
        h, w = row["height"], row["width"]
        if test_format == "mask" and row["ann"].get("segmentation"):
            mask = region_mask_from_ann(row["ann"], h, w)
        else:
            mask = region_mask_from_ann(
                {"bbox": row["ann"]["bbox"]}, h, w)
        rows.append({
            "image_path": os.path.join(img_prefix, row["file_name"]),
            "mask": mask.astype(np.float32),
            "question": REFG_QUESTION.replace(
                "<spi_descript>", region_str(1, named=False)),
            "captions": row["captions"],
            "image_id": row["image_id"],
        })
        if limit and len(rows) >= limit:
            break
    return rows


def load_region_recognition(ann_file: str, img_prefix: str, *,
                            vocab: str = "coco",
                            test_format: str = "bbox",
                            limit: Optional[int] = None) -> List[Dict]:
    """COCO-instances-format json; one row per annotation with the gt
    category name (reference eval_region_recognition.py:58-110)."""
    with open(ann_file) as f:
        data = json.load(f)
    imgs = {im["id"]: im for im in data["images"]}
    cats = {c["id"]: c["name"].lower().replace("_", " ")
            for c in data["categories"]}
    label_names = sorted(set(cats.values()))
    str2idx = {}
    for c in data["categories"]:
        str2idx[c["name"].lower().replace("_", " ")] = c["id"]
    q = (COCO_RECOG_QUESTION if vocab == "coco"
         else LVIS_RECOG_QUESTION).replace("<regions>", region_str(1))
    rows = []
    for ann in data["annotations"]:
        im = imgs[ann["image_id"]]
        h, w = im["height"], im["width"]
        ann_for_mask = (ann if test_format == "mask"
                        else {"bbox": ann["bbox"]})
        rows.append({
            "image_path": os.path.join(img_prefix, im["file_name"]),
            "mask": region_mask_from_ann(ann_for_mask, h, w
                                         ).astype(np.float32),
            "question": q,
            "label": cats[ann["category_id"]],
            "bbox": list(ann["bbox"]),
            "image_id": ann["image_id"],
            "label_names": label_names,
            "str2idx": str2idx,
        })
        if limit and len(rows) >= limit:
            break
    return rows


def load_region_classification(ann_file: str, img_prefix: str, *,
                               test_format: str = "bbox",
                               limit: Optional[int] = None) -> List[Dict]:
    """Osprey category-val format: list of image dicts with aligned
    'categories' and 'annotations' (eval_region_classification.py:68-88)."""
    with open(ann_file) as f:
        images = json.load(f)
    q = OSPREY_CLS_QUESTION.replace("<regions>", region_str(1))
    rows = []
    for image in images:
        for cat, ann in zip(image["categories"], image["annotations"]):
            category = cat.replace("_", " ").replace(":", " ")
            ann_for_mask = (ann if test_format == "mask"
                            else {"bbox": ann["bbox"]})
            rows.append({
                "image_path": os.path.join(img_prefix,
                                           image["file_name"]),
                "mask": region_mask_from_ann(
                    ann_for_mask, image["height"], image["width"]
                ).astype(np.float32),
                "question": q,
                "category": category,
                "image_id": image["id"],
            })
            if limit and len(rows) >= limit:
                return rows
    return rows


def load_vcr(ann_file: str, img_prefix: str, *,
             limit: Optional[int] = None) -> List[Dict]:
    """VCR jsonl rows {image, boxes (normalized xyxy), conversations,
    correct_option, category} — multi-region multiple choice
    (eval_region_caption_vcr.py:45-110)."""
    rows = []
    with open(ann_file) as f:
        for line in f:
            d = json.loads(line)
            q = d["conversations"][0]["value"].replace(
                "<regions>", region_str(len(d["boxes"])))
            q = q.replace("<image>\n", "").replace("<image>", "")
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "boxes": np.asarray(d["boxes"], np.float32),
                "question": q,
                "answer": str(d["correct_option"]).strip(),
                "category": d.get("category", "Q->A"),
            })
            if limit and len(rows) >= limit:
                break
    return rows


def materialize(rows: Sequence[Dict], image_size: int = 336) -> List[Dict]:
    """Image paths to arrays (`load_image`) and masks or boxes to the
    [R, H, W] masks `run_region_generate` takes."""
    out = []
    for r in rows:
        r = dict(r)
        r["image"] = load_image(r.pop("image_path"))
        if "boxes" in r:   # VCR: normalized boxes → masks at CLIP size
            boxes = r.pop("boxes") * image_size
            r["masks"] = boxes_to_masks(boxes, image_size, image_size)
        else:
            r["masks"] = r.pop("mask")[None]
        out.append(r)
    return out


# ---------------------------------------------------------------- scoring

def _words(s: str) -> List[str]:
    s = re.sub(r"([.,'!?\"()*#:;])", "", s.lower()
               ).replace("-", " ").replace("/", " ").replace("_", " ")
    return s.split()


def semantic_iou(pred: str, target: str) -> float:
    """Word-set IoU (eval_region_classification.py:61-64)."""
    p, t = set(_words(pred)), set(_words(target))
    return len(p & t) / max(len(p | t), 1)


def bow_cosine(pred: str, target: str) -> float:
    """Bag-of-words cosine similarity — offline stand-in for the
    reference's SBERT sentence similarity (SentenceTransformer is
    unavailable without downloaded weights; same 0-100 scale)."""
    p, t = Counter(_words(pred)), Counter(_words(target))
    num = sum(p[w] * t[w] for w in p)
    den = (math.sqrt(sum(v * v for v in p.values()))
           * math.sqrt(sum(v * v for v in t.values())))
    return num / den if den else 0.0


def score_region_caption(rows: Sequence[Dict]) -> Dict[str, float]:
    cands = [r["prediction"] for r in rows]
    refs = [[c.lower() for c in r["captions"]] or [""] for r in rows]
    return {"CIDEr": CiderD().compute(cands, refs),
            "Bleu_4": bleu4(cands, refs)}


def score_region_recognition(rows: Sequence[Dict]) -> Dict[str, Any]:
    """Accuracy; out-of-vocabulary predictions count as wrong (reference
    :339-342). Also returns COCO-format detections under "predictions"
    (score 1.0) so callers can run box mAP like the reference does."""
    hits, preds = [], []
    for r in rows:
        p = r["prediction"]
        if p not in r["label_names"]:
            hits.append(False)
            continue
        hits.append(p == r["label"])
        preds.append({"image_id": r["image_id"],
                      "category_id": r["str2idx"][p],
                      "bbox": r["bbox"], "score": 1.0})
    return {"accuracy": float(np.mean(hits)) if hits else 0.0,
            "predictions": preds}


def score_region_classification(rows: Sequence[Dict]) -> Dict[str, float]:
    sims, ious = [], []
    for r in rows:
        p = r["prediction"]
        if ":" in p:
            p = p.split(":")[1]
        p = p.replace(".", " ").replace(":", " ").replace(",", " ")
        sims.append(bow_cosine(p, r["category"]) * 100)
        ious.append(semantic_iou(p.lower(), r["category"].lower()) * 100)
    return {"semantic_similarity": float(np.mean(sims)) if sims else 0.0,
            "semantic_iou": float(np.mean(ious)) if ious else 0.0}


def score_vcr(rows: Sequence[Dict]) -> Dict[str, float]:
    """Per-category accuracy (Q->A, QA->R) + overall
    (eval_region_caption_vcr.py:282-292)."""
    by_cat: Dict[str, List[bool]] = defaultdict(list)
    for r in rows:
        pred = r["prediction"].strip().upper()[:1]
        by_cat[r["category"]].append(pred == r["answer"].upper())
    out = {f"accuracy/{k}": float(np.mean(v)) for k, v in by_cat.items()}
    out["accuracy"] = float(np.mean([h for v in by_cat.values()
                                     for h in v])) if by_cat else 0.0
    return out


# ---------------------------------------------------------------- runner

TASKS = {
    # name → (loader, scorer, max_new_tokens per the reference scripts)
    "region-caption": (load_region_caption, score_region_caption, 64),
    "region-recognition": (load_region_recognition,
                           score_region_recognition, 5),
    "region-classification": (load_region_classification,
                              score_region_classification, 5),
    "vcr": (load_vcr, score_vcr, 1),
}


def run_region_eval(
    task: str,
    generate_fn: Callable,
    cfg: VisionLLMConfig,
    tokenizer,
    rows: Sequence[Dict],
    *,
    conv_version: str = "vicuna_v1",
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """One task's metrics over `rows` from its `load_*` function (image
    paths not yet read), decoded by `generate_fn` (a generate closure of
    a core of `cfg`, on `device`: CUDA unless given)."""
    _, scorer, _ = TASKS[task]
    rows = materialize(rows, cfg.vis_encoder.image_size)
    preds = run_region_generate(generate_fn, cfg, tokenizer, rows,
                                conv_version=conv_version, device=device)
    return scorer(preds)
