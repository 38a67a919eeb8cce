"""Per-benchmark loaders and the runner (counterpart of
`visionllm_tpu/eval/runners.py`): read the benchmark file formats of the
reference's eval scripts and produce the tracked numbers.

* VQA-style jsonl suites - eval/vqa/evaluate_vqa.py:37-150, :218-260
  (rows {"image", "question", "question_id", "answer"}).
* MME - eval/mme/eval.py:55-80 (<category>.txt lines "img\tquestion\t
  answer", images under images/<category>/) + mme/calculation.py.
* POPE - eval/pope/evaluate_pope.py:47-70 (jsonl {"image", "text",
  "label"}).
* MMBench - eval/mmbench/evaluate_mmbench.py (tsv: index, question,
  hint, A..D, answer, image as base64).
* SEED - eval/seed/evaluate_seed.py:45-70; ScienceQA -
  eval/scienceqa/evaluate_scienceqa.py; MM-Vet - eval/mmvet/
  evaluate_mmvet.py (its GPT grader replaced by an offline keyword
  score); captions - eval/eval_image_caption.py.

Images are read by `data/image_io.py` (PNG and .npy; a JPEG raises).
The device work happens inside `generate_fn`.
"""

from __future__ import annotations

import base64
import csv
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from visionllm_tpu_torch.data.image_io import decode_image_bytes, load_image
from visionllm_tpu_torch.eval import benchmarks as B
from visionllm_tpu_torch.eval.caption import CiderD, bleu4
from visionllm_tpu_torch.eval.vqa import containment_accuracy, run_vqa

# mirror of ds_collections (evaluate_vqa.py:37-150): metric +
# max_new_tokens per suite; file paths are supplied by the caller
VQA_SUITES: Dict[str, Dict] = {
    "vqav2_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "vqav2_testdev": {"metric": None, "max_new_tokens": 10},
    "okvqa_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "textvqa_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "vizwiz_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "vizwiz_test": {"metric": None, "max_new_tokens": 10},
    "docvqa_val": {"metric": "anls", "max_new_tokens": 100},
    "chartqa_test_human": {"metric": "relaxed_accuracy",
                           "max_new_tokens": 100},
    "chartqa_test_augmented": {"metric": "relaxed_accuracy",
                               "max_new_tokens": 100},
    "gqa_testdev": {"metric": "accuracy", "max_new_tokens": 10},
    "ocrvqa_val": {"metric": "accuracy", "max_new_tokens": 100},
    "ai2diagram_test": {"metric": "accuracy", "max_new_tokens": 10},
}


# ---------------------------------------------------------------- loaders

def load_vqa_jsonl(test_file: str, img_prefix: str = "",
                   limit: Optional[int] = None) -> List[Dict]:
    """rows: {"image","question","question_id","answer"|"answers"}."""
    rows = []
    with open(test_file) as f:
        for line in f:
            d = json.loads(line)
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "question": d["question"],
                "question_id": d.get("question_id"),
                **({"answers": d["answer"]}
                   if isinstance(d.get("answer"), list)
                   else {"answer": d.get("answer", "")}),
            })
            if limit and len(rows) >= limit:
                break
    return rows


def load_mme(root: str, images_root: Optional[str] = None,
             limit: Optional[int] = None) -> List[Dict]:
    """MME layout: <root>/<category>.txt + images under
    <images_root>/<category>/ (eval/mme/eval.py:60-72)."""
    images_root = images_root or os.path.join(root, "images")
    rows = []
    for filename in sorted(os.listdir(root)):
        if not filename.endswith(".txt"):
            continue
        category = filename[:-4]
        with open(os.path.join(root, filename), encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 3:
                    continue
                img, question, gt = parts
                rows.append({
                    "image_path": os.path.join(images_root, category, img),
                    "question": question,
                    "answer": gt,
                    "category": category,
                    "image_id": img,
                })
                if limit and len(rows) >= limit:
                    return rows
    return rows


def load_pope(question_file: str, img_prefix: str = "",
              limit: Optional[int] = None) -> List[Dict]:
    rows = []
    with open(question_file) as f:
        for line in f:
            d = json.loads(line)
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "question": d.get("text") or d.get("question"),
                "answer": d.get("label", d.get("answer", "")),
            })
            if limit and len(rows) >= limit:
                break
    return rows


# csv's field limit while an MMBench tsv is read: its default (131072
# characters) refuses a base64 image over about 96 KB, and the JAX loader
# stops there (ROADMAP.md §C.2)
MMBENCH_FIELD_LIMIT = 2 ** 31 - 1


def load_mmbench(tsv_file: str, limit: Optional[int] = None) -> List[Dict]:
    """tsv columns: index, question, hint, A..D, answer, image (base64).
    The option letters become the expected answers."""
    rows = []
    old_limit = csv.field_size_limit(MMBENCH_FIELD_LIMIT)
    try:
        _read_mmbench(tsv_file, limit, rows)
    finally:
        csv.field_size_limit(old_limit)
    return rows


def _read_mmbench(tsv_file: str, limit: Optional[int],
                  rows: List[Dict]) -> None:
    with open(tsv_file, encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for d in reader:
            options = {k: d[k] for k in ("A", "B", "C", "D")
                       if d.get(k) not in (None, "", "nan")}
            opts_txt = "\n".join(f"{k}. {v}" for k, v in options.items())
            hint = d.get("hint") or ""
            q = (hint + "\n" if hint and hint != "nan" else "")
            q += d["question"] + "\n" + opts_txt
            q += ("\nAnswer with the option's letter from the given "
                  "choices directly.")
            rows.append({
                "image_b64": d["image"],
                "question": q,
                "answer": d.get("answer", ""),
                "options": options,
                "index": d.get("index"),
            })
            if limit and len(rows) >= limit:
                break


def load_seed(annotation: str, img_prefix: str = "",
              limit: Optional[int] = None) -> List[Dict]:
    rows = []
    with open(annotation, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "question": d["text"]
                + "\nAnswer with the option's letter from the given "
                  "choices directly.",
                "answer": d.get("answer", ""),
            })
            if limit and len(rows) >= limit:
                break
    return rows


def load_scienceqa(annotation: str, img_prefix: str = "",
                   limit: Optional[int] = None) -> List[Dict]:
    letters = ["A", "B", "C", "D", "E"]
    rows = []
    with open(annotation, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            choices = d.get("choices", [])
            opts = "\n".join(f"{letters[i]}. {c}"
                             for i, c in enumerate(choices))
            hint = d.get("hint") or ""
            q = (hint + "\n" if hint else "") + d["question"] + "\n" + opts
            q += ("\nAnswer with the option's letter from the given "
                  "choices directly.")
            ans = d.get("answer", "")
            if isinstance(ans, int) and ans < len(letters):
                ans = letters[ans]
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "question": q,
                "answer": ans,
                "options": {letters[i]: c for i, c in enumerate(choices)},
            })
            if limit and len(rows) >= limit:
                break
    return rows


# eval/eval_image_caption.py:70: the fixed caption prompt; generation
# budget per suite :33-53 (flickr30k/coco_karpathy/nocaps all 30)
CAPTION_PROMPT = "Provide a one-sentence caption for the provided image."


def load_caption(ann_file: str, img_prefix: str = "",
                 limit: Optional[int] = None) -> List[Dict]:
    """Caption benchmarks (eval/eval_image_caption.py). Accepts either
    COCO-caption format ({"images","annotations"} with per-image caption
    annotations) or karpathy-style lists ([{"image", "caption": [...]}]).
    Every row asks the same CAPTION_PROMPT; references are the gt
    captions for that image."""
    with open(ann_file, encoding="utf-8") as f:
        data = json.load(f)
    rows = []
    if isinstance(data, dict) and "annotations" in data:
        imgs = {im["id"]: im for im in data["images"]}
        caps: Dict[object, List[str]] = {}
        for ann in data["annotations"]:
            caps.setdefault(ann["image_id"], []).append(ann["caption"])
        for image_id, refs in caps.items():
            im = imgs[image_id]
            rows.append({
                "image_path": os.path.join(
                    img_prefix, im.get("file_name") or im.get("image")),
                "question": CAPTION_PROMPT,
                "captions": refs,
                "image_id": image_id,
            })
            if limit and len(rows) >= limit:
                break
    else:
        for i, d in enumerate(data):
            refs = d.get("caption") or d.get("captions") or []
            if isinstance(refs, str):
                refs = [refs]
            rows.append({
                "image_path": os.path.join(img_prefix, d["image"]),
                "question": CAPTION_PROMPT,
                "captions": refs,
                "image_id": d.get("image_id", i),
            })
            if limit and len(rows) >= limit:
                break
    return rows


def load_mmvet(json_file: str, img_prefix: str = "",
               limit: Optional[int] = None) -> List[Dict]:
    with open(json_file, encoding="utf-8") as f:
        data = json.load(f)
    rows = []
    for key, d in data.items():
        rows.append({
            "image_path": os.path.join(img_prefix, d["imagename"]),
            "question": d["question"],
            "answer": d.get("answer", ""),
            "id": key,
        })
        if limit and len(rows) >= limit:
            break
    return rows


# ---------------------------------------------------------------- runner

BENCHMARKS = {
    # name -> its loader
    "mme": load_mme,
    "pope": load_pope,
    "mmbench": load_mmbench,
    "seed": load_seed,
    "scienceqa": load_scienceqa,
    "mmvet": load_mmvet,
    "caption": load_caption,
}


def _materialize_images(rows: Sequence[Dict]) -> List[Dict]:
    out = []
    for r in rows:
        r = dict(r)
        if "image_b64" in r:
            r["image"] = decode_image_bytes(
                base64.b64decode(r.pop("image_b64")),
                name=f"image_b64 of row {r.get('index')}")
        elif "image_path" in r:
            r["image"] = load_image(r.pop("image_path"))
        out.append(r)
    return out


def score_rows(benchmark: str, rows: Sequence[Dict]) -> Dict[str, float]:
    """Apply the benchmark's metric to predicted rows."""
    if benchmark == "mme":
        return B.mme_scores(rows)
    if benchmark == "pope":
        return B.pope_scores(rows)
    if benchmark in ("mmbench", "seed", "scienceqa"):
        hits = []
        for r in rows:
            opts = list((r.get("options") or {}).values())
            pred = B.extract_choice(r["prediction"], opts or [""] * 4)
            hits.append(pred == str(r.get("answer", "")).strip().upper())
        return {"accuracy": float(sum(hits) / max(len(hits), 1))}
    if benchmark == "mmvet":
        return {"keyword_score": B.mmvet_keyword_score(rows)}
    if benchmark == "caption":
        cands = [r["prediction"] for r in rows]
        refs = [r.get("captions") or [""] for r in rows]
        return {"CIDEr": CiderD().compute(cands, refs),
                "Bleu_4": bleu4(cands, refs)}
    if benchmark in VQA_SUITES:
        metric = VQA_SUITES[benchmark]["metric"]
        if metric == "vqa_score":
            return {"vqa_accuracy": B.vqa_accuracy(rows)}
        if metric == "anls":
            return {"anls": B.anls(rows)}
        if metric == "relaxed_accuracy":
            return {"relaxed_accuracy": B.relaxed_accuracy(rows)}
        if metric == "accuracy":
            return {"accuracy": containment_accuracy(rows)}
        return {}
    raise ValueError(f"unknown benchmark {benchmark}")


def run_benchmark(
    benchmark: str,
    generate_fn: Callable,
    tokenizer,
    rows: Sequence[Dict],
    *,
    image_token_len: int,
    image_size: int = 336,
    conv_version: str = "vicuna_v1",
    batch_size: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """rows from a load_* function (images still as paths or base64);
    returns the benchmark's metric dict. `image_token_len` is the model's
    image feature rows (`VisionLLMConfig.image_token_len`); `batch_size >
    1` rides the left-padded batched decode (`run_vqa`), on `device`
    (CUDA unless given)."""
    rows = _materialize_images(rows)
    single_word = benchmark in VQA_SUITES or benchmark in ("mme", "pope")
    preds = run_vqa(generate_fn, tokenizer, rows,
                    image_token_len=image_token_len, image_size=image_size,
                    conv_version=conv_version, single_word=single_word,
                    batch_size=batch_size, device=device)
    return score_rows(benchmark, preds)
