"""Generate-based VQA / captioning evaluation (counterpart of
`visionllm_tpu/eval/vqa.py`, after the reference's
eval/vqa/evaluate_vqa.py): the vicuna_v1 prompt with the image's
<im_patch> ids, greedy decoding through the port's `build_generate_fn`
closure, the answer cut at the conversation's stop string, and the
simple accuracy metrics the runners apply.

The prompt carries `image_token_len` <im_patch> ids, the model's image
feature rows (`VisionLLMConfig.image_token_len`); the JAX `run_vqa`
counts `(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from visionllm_tpu_torch.constants import DEFAULT_TOKENS
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               expand_image_tokens, find_stop,
                                               tokenizer_image_token)
from visionllm_tpu_torch.device import resolve_device


def _eos_or_default(tokenizer) -> int:
    """eos token id, defaulting to 2 only when the tokenizer has NONE
    (a plain `or 2` would remap a legitimate id of 0)."""
    eos = getattr(tokenizer, "eos_token_id", None)
    return 2 if eos is None else int(eos)


def build_vqa_prompt(question: str, conv_version: str = "vicuna_v1",
                     single_word: bool = False) -> str:
    """'<image>\\nQ ...' -> the whole conversation prompt ending at
    ASSISTANT:."""
    q = "<image>\n" + question
    if single_word:
        q += "\nAnswer the question using a single word or phrase."
    conv = get_conv_template(conv_version)
    conv.append_message(conv.roles[0], q)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def prompt_to_ids(prompt: str, tokenizer, img_len: int,
                  im_patch_id: int) -> np.ndarray:
    ids = tokenizer_image_token(prompt, tokenizer)
    return expand_image_tokens(ids, img_len, im_patch_id)


def run_vqa(
    generate_fn: Callable,        # the closure of build_generate_fn
    tokenizer,
    questions: Sequence[Dict],    # {"image": uint8 HWC, "question": str,
                                  #  "answer": str (optional)}
    *,
    image_token_len: int,
    image_size: int = 336,
    conv_version: str = "vicuna_v1",
    single_word: bool = True,
    batch_size: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> List[Dict]:
    """Greedy-decodes each question on `device` (CUDA unless given; the
    core of `generate_fn` must live there); returns the rows without
    their image and with the predicted text.

    `batch_size > 1` decodes B questions a call: prompts LEFT-padded to
    the longest under `attn_mask`, images as [B, 1, S, S, 3] tile stacks,
    a short tail's empty rows dead (`live`). Rows stop at their first eos,
    so batched answers equal B1's."""
    dev = resolve_device(device)
    imp_id = tokenizer.convert_tokens_to_ids(DEFAULT_TOKENS["imp"])
    conv = get_conv_template(conv_version)
    stop_strs = [conv.sep2 or conv.sep]
    eos_id = _eos_or_default(tokenizer)

    def finish(q, tokens):
        text = tokenizer.decode(tokens, skip_special_tokens=True)
        cut = find_stop(text, stop_strs)
        if cut is not None:
            text = text[:cut]
        return {**{k: v for k, v in q.items() if k != "image"},
                "prediction": text.strip()}

    def tensor(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    encoded = [prompt_to_ids(build_vqa_prompt(q["question"], conv_version,
                                              single_word),
                             tokenizer, image_token_len, imp_id)
               for q in questions]
    rows = []
    if batch_size <= 1:
        for q, ids in zip(questions, encoded):
            image = clip_preprocess(q["image"], image_size, "pad")[None]
            out = generate_fn(tensor(ids[None], torch.long),
                              tensor(image, torch.float32))
            n = int(out["num_generated"])
            rows.append(finish(q, out["out_tokens"][0, :n].cpu().numpy()))
        return rows

    L = max(len(e) for e in encoded)
    B = batch_size
    for start in range(0, len(questions), B):
        group = list(range(start, min(start + B, len(questions))))
        ids = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), bool)
        imgs = np.zeros((B, 1, image_size, image_size, 3), np.float32)
        live = np.zeros((B,), bool)
        for j, qi in enumerate(group):
            e = encoded[qi]
            ids[j, L - len(e):] = e
            mask[j, L - len(e):] = True
            imgs[j, 0] = clip_preprocess(questions[qi]["image"],
                                         image_size, "pad")
            live[j] = True
        out = generate_fn(tensor(ids), tensor(imgs), attn_mask=tensor(mask),
                          live=tensor(live))
        n = int(out["num_generated"])
        toks = out["out_tokens"][:, :n].cpu().numpy()
        for j, qi in enumerate(group):
            row = toks[j]
            ends = np.nonzero(row == eos_id)[0]
            if ends.size:
                row = row[:ends[0] + 1]
            rows.append(finish(questions[qi], row))
    return rows


def exact_match_accuracy(rows: Sequence[Dict]) -> float:
    hits = [r["prediction"].lower() == str(r.get("answer", "")).lower()
            for r in rows if "answer" in r]
    return float(np.mean(hits)) if hits else float("nan")


def containment_accuracy(rows: Sequence[Dict]) -> float:
    """VQA-style 'answer appears in prediction' metric (used by several
    reference runners for open-ended answers)."""
    hits = [str(r.get("answer", "")).lower() in r["prediction"].lower()
            for r in rows if "answer" in r]
    return float(np.mean(hits)) if hits else float("nan")
