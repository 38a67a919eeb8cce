"""Per-benchmark answer extraction and metrics (counterpart of
`visionllm_tpu/eval/benchmarks.py`, after the reference's runners under
visionllmv2/eval/: VQA accuracy, MME and POPE yes/no parsing, MMBench /
SEED / ScienceQA option matching, ChartQA relaxed accuracy, DocVQA
ANLS, an offline MM-Vet keyword proxy). Pure host-side text processing
over the rows `eval/vqa.py:run_vqa` predicts.
"""

from __future__ import annotations

import re
import string
from typing import Dict, Sequence


def normalize_answer(text: str) -> str:
    """Lowercase, strip punctuation/articles (VQA-accuracy convention)."""
    text = text.lower().strip()
    text = re.sub(rf"[{re.escape(string.punctuation)}]", "", text)
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def vqa_accuracy(rows: Sequence[Dict]) -> float:
    """VQAv2 metric: acc = min(#annotators-matching / 3, 1), averaged.
    Rows carry "answers" (list of 10) or a single "answer"."""
    scores = []
    for r in rows:
        pred = normalize_answer(r["prediction"])
        answers = r.get("answers") or [r.get("answer", "")]
        answers = [normalize_answer(a) for a in answers]
        if len(answers) == 1:
            scores.append(float(pred == answers[0]))
        else:
            n = sum(a == pred for a in answers)
            scores.append(min(n / 3.0, 1.0))
    return float(sum(scores) / max(len(scores), 1))


def parse_yes_no(text: str) -> str:
    """MME/POPE answer parsing: leading yes/no wins; 'other' otherwise."""
    t = text.lower().strip()
    if t.startswith("yes"):
        return "yes"
    if t.startswith("no"):
        return "no"
    if "yes" in t[:24] and "no" not in t[:24]:
        return "yes"
    if "no" in t[:24] and "yes" not in t[:24]:
        return "no"
    return "other"


def mme_scores(rows: Sequence[Dict]) -> Dict[str, float]:
    """MME: acc over all questions + acc+ (both questions per image
    right). Rows need image_id, answer(yes/no), prediction."""
    per_img: Dict = {}
    correct = 0
    for r in rows:
        pred = parse_yes_no(r["prediction"])
        gt = r["answer"].lower().strip()
        ok = pred == gt
        correct += int(ok)
        per_img.setdefault(r.get("image_id", id(r)), []).append(ok)
    acc = correct / max(len(rows), 1)
    acc_plus = sum(all(v) for v in per_img.values()) / max(len(per_img), 1)
    return {"acc": acc, "acc_plus": acc_plus,
            "score": 100 * (acc + acc_plus)}


def pope_scores(rows: Sequence[Dict]) -> Dict[str, float]:
    """POPE: accuracy / precision / recall / F1 / yes-ratio."""
    tp = fp = tn = fn = yes = 0
    for r in rows:
        pred = parse_yes_no(r["prediction"])
        gt = r["answer"].lower().strip()
        yes += int(pred == "yes")
        if gt == "yes":
            tp += int(pred == "yes")
            fn += int(pred != "yes")
        else:
            tn += int(pred == "no")
            fp += int(pred != "no")
    n = max(len(rows), 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {"accuracy": (tp + tn) / n, "precision": prec, "recall": rec,
            "f1": 2 * prec * rec / max(prec + rec, 1e-9),
            "yes_ratio": yes / n}


def extract_choice(text: str, options: Sequence[str]) -> str:
    """MMBench/SEED/ScienceQA multiple choice: return the option letter.
    Tries (1) a leading letter, (2) 'answer is X', (3) option-text
    containment."""
    t = text.strip()
    letters = string.ascii_uppercase[:len(options)]
    m = re.match(rf"^\(?([{letters}])\)?\b", t)
    if m:
        return m.group(1)
    m = re.search(rf"answer is:?\s*\(?([{letters}])\)?", t, re.I)
    if m:
        return m.group(1).upper()
    tn = normalize_answer(t)
    for i, opt in enumerate(options):
        if normalize_answer(opt) and normalize_answer(opt) in tn:
            return letters[i]
    return ""


def choice_accuracy(rows: Sequence[Dict]) -> float:
    """rows: prediction, options (list of str), answer (letter)."""
    hits = [extract_choice(r["prediction"], r["options"])
            == r["answer"].strip().upper() for r in rows]
    return float(sum(hits) / max(len(hits), 1))


def mmvet_keyword_score(rows: Sequence[Dict]) -> float:
    """Lightweight MM-Vet proxy (the reference uses a GPT grader):
    required-keyword containment averaged."""
    scores = []
    for r in rows:
        kws = r.get("keywords") or [r.get("answer", "")]
        pred = normalize_answer(r["prediction"])
        scores.append(sum(normalize_answer(k) in pred for k in kws)
                      / max(len(kws), 1))
    return float(sum(scores) / max(len(scores), 1))


BENCHMARK_METRICS = {
    "vqav2": vqa_accuracy,
    "gqa": vqa_accuracy,
    "textvqa": vqa_accuracy,
    "okvqa": vqa_accuracy,
    "vizwiz": vqa_accuracy,
    "mme": mme_scores,
    "pope": pope_scores,
    "mmbench": choice_accuracy,
    "seed": choice_accuracy,
    "scienceqa": choice_accuracy,
    "mmvet": mmvet_keyword_score,
}


def relaxed_correctness(target: str, prediction: str,
                        max_relative_change: float = 0.05) -> bool:
    """ChartQA relaxed accuracy (evaluate_vqa.py:150-180, after
    pix2struct): numeric answers tolerate 5% relative error; others
    need exact match (case-insensitive)."""
    def to_float(text):
        try:
            if text.endswith("%"):
                return float(text.rstrip("%")) / 100.0
            return float(text)
        except ValueError:
            return None

    p = to_float(prediction.strip())
    t = to_float(target.strip())
    if p is not None and t is not None:
        if t == 0:
            return p == 0
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.strip().lower() == target.strip().lower()


def relaxed_accuracy(rows: Sequence[Dict]) -> float:
    hits = [relaxed_correctness(str(r.get("answer", "")), r["prediction"])
            for r in rows if "answer" in r]
    return float(sum(hits) / max(len(hits), 1))


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(rows: Sequence[Dict], tau: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (DocVQA metric): per
    question, max over gt answers of 1 - NL(pred, gt), zeroed below
    the tau threshold."""
    scores = []
    for r in rows:
        pred = r["prediction"].strip().lower()
        answers = r.get("answers") or [r.get("answer", "")]
        best = 0.0
        for a in answers:
            a = str(a).strip().lower()
            if not a and not pred:
                best = max(best, 1.0)
                continue
            d = _levenshtein(pred, a)
            nl = d / max(len(pred), len(a), 1)
            s = 1.0 - nl
            best = max(best, s if s >= tau else 0.0)
        scores.append(best)
    return float(sum(scores) / max(len(scores), 1))
