"""Conversation -> (input_ids, labels) with human-turn masking (own copy
of the JAX package's `data/preprocess.py`: `preprocess_multimodal`,
`preprocess_v1`, `preprocess_internlm` and the `preprocess` dispatcher).

Plain numpy; the masking offsets repeat the reference's Llama-tokenizer
arithmetic (the hardcoded -2 / legacy -1 adjustments) so labels line up
token for token.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from visionllm_tpu_torch.constants import (DEFAULT_TOKENS, IGNORE_INDEX,
                                           IMAGE_TOKEN_INDEX)
from visionllm_tpu_torch.data.conversation import (SeparatorStyle,
                                                   get_conv_template)
from visionllm_tpu_torch.data.mm_utils import tokenizer_image_token


def preprocess_multimodal(sources: List[List[Dict]]) -> List[List[Dict]]:
    """Move a stray '<image>' to the front of the first turn (reference
    llava_data.py:207-230). Multi-image turns (mmic data) are left in
    place — the reference's collapse would drop all but one sentinel."""
    for source in sources:
        for sentence in source:
            if sentence["value"].count("<image>") == 1:
                v = sentence["value"].replace("<image>", "").strip()
                if sentence is source[0]:
                    sentence["value"] = "<image>\n" + v
                else:
                    sentence["value"] = v.replace("<image>\n", "<image>")
    return sources


def _expand_image_sentinels(input_ids: np.ndarray, labels: np.ndarray,
                            tokenizer, image_token_len, use_im_start_end):
    """Replace each IMAGE_TOKEN_INDEX with <im_patch>*len (± <img></img>),
    labels IGNORE (reference llava_data.py:370-404)."""
    idxs = np.where(input_ids == IMAGE_TOKEN_INDEX)[0]
    if len(idxs) == 0:
        return input_ids, labels
    lens = (image_token_len if isinstance(image_token_len, list)
            else [image_token_len] * len(idxs))
    new_ids, new_labels = [], []
    prev = 0
    for i, idx in enumerate(idxs):
        replace = DEFAULT_TOKENS["imp"] * lens[i]
        if use_im_start_end:
            replace = DEFAULT_TOKENS["boi"] + replace + DEFAULT_TOKENS["eoi"]
        rep_ids = np.asarray(tokenizer(replace).input_ids[1:], np.int32)
        new_ids.extend([input_ids[prev:idx], rep_ids])
        new_labels.extend([labels[prev:idx],
                           np.full(len(rep_ids), IGNORE_INDEX, np.int32)])
        prev = idx + 1
    new_ids.append(input_ids[prev:])
    new_labels.append(labels[prev:])
    return (np.concatenate(new_ids).astype(np.int32),
            np.concatenate(new_labels).astype(np.int32))


def preprocess_v1(
    sources: Sequence[List[Dict]],
    tokenizer,
    version: str = "vicuna_v1",
    has_image: bool = True,
    image_token_len: Union[int, List[int]] = 576,
    use_im_start_end: bool = False,
    model_max_length: int = 4096,
) -> Dict[str, np.ndarray]:
    """vicuna_v1-style (SeparatorStyle.TWO) tokenize + mask. Returns
    {"input_ids": [N, L] list, "labels": ...} (variable length per row,
    returned as python list of arrays)."""
    conv = get_conv_template(version)
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    assert conv.sep_style == SeparatorStyle.TWO

    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    legacy = bool(getattr(tokenizer, "legacy", True))
    sep = conv.sep + conv.roles[1] + ": "

    out_ids, out_labels = [], []
    for conversation in conversations:
        if has_image:
            input_ids = tokenizer_image_token(conversation, tokenizer)
        else:
            input_ids = np.asarray(tokenizer(conversation).input_ids,
                                   np.int32)
        input_ids = input_ids[:model_max_length]
        target = input_ids.copy()
        total_len = int(np.sum(target != tokenizer.pad_token_id))

        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(rou, tokenizer))
                instruction_len = len(
                    tokenizer_image_token(parts[0], tokenizer)) - 2
            else:
                round_len = len(tokenizer(rou).input_ids)
                instruction_len = len(tokenizer(parts[0]).input_ids) - 2
            if i != 0 and not legacy:
                instruction_len -= 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
            if i != 0 and not legacy:
                cur_len -= 1
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX   # tokenization mismatch → drop sample

        if has_image:
            input_ids, target = _expand_image_sentinels(
                input_ids, target, tokenizer, image_token_len,
                use_im_start_end)
        out_ids.append(input_ids)
        out_labels.append(target)

    return {"input_ids": out_ids, "labels": out_labels}


def preprocess_internlm(
    sources: Sequence[List[Dict]],
    tokenizer,
    version: str = "internlm2_chat",
    has_image: bool = True,
    image_token_len: Union[int, List[int]] = 576,
    use_im_start_end: bool = False,
    model_max_length: int = 4096,
) -> Dict[str, np.ndarray]:
    """internlm2_chat (MPT-style separators) tokenize + mask (reference
    llava_data.py:preprocess_internlm)."""
    conv = get_conv_template(version)
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    # Masking repeats the reference arithmetic verbatim: targets start as
    # a copy of input_ids, instruction segments are masked by walking
    # `parts` split on roles[1], every segment length is
    # `len(tokenize(segment)) - 1` (dropping the <s> each separate call
    # adds), and the answer part (`part1`) is measured with the PLAIN
    # tokenizer even when has_image (answers contain no <image>); another
    # structure agrees on a word-level tokenizer but is off by one at
    # subword boundaries of a real vocab.
    def tok_img(s):
        return tokenizer_image_token(s, tokenizer)

    def tok_plain(s):
        return np.asarray(tokenizer(s).input_ids, np.int32)

    tok_main = tok_img if has_image else tok_plain

    out_ids, out_labels = [], []
    for conversation in conversations:
        input_ids = tok_main(conversation)[:model_max_length]
        target = input_ids.copy()
        total_len = int((target != tokenizer.pad_token_id).sum())
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX                       # <s>
        parts = conversation.split(conv.roles[1])
        info = parts[0] + conv.roles[1]
        temp_len = len(tok_main(info)) - 1
        target[cur_len:cur_len + temp_len] = IGNORE_INDEX
        cur_len += temp_len
        for index in range(1, len(parts) - 1):
            info = parts[index]
            part1, part2 = info.split(conv.roles[0])
            temp_len = len(tok_plain(part1)) - 1   # answer: supervised
            cur_len += temp_len
            part = conv.roles[0] + part2 + conv.roles[1]
            temp_len = len(tok_main(part)) - 1
            target[cur_len:cur_len + temp_len] = IGNORE_INDEX
            cur_len += temp_len
        temp_len = len(tok_main(parts[-1])) - 1
        cur_len += temp_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX   # tokenization mismatch → drop
        if has_image:
            input_ids, target = _expand_image_sentinels(
                input_ids, target, tokenizer, image_token_len,
                use_im_start_end)
        out_ids.append(input_ids)
        out_labels.append(target)
    return {"input_ids": out_ids, "labels": out_labels}


def preprocess(sources, tokenizer, version="vicuna_v1", **kw):
    """Dispatcher (reference llava_data.py preprocess)."""
    if version.startswith("internlm"):
        return preprocess_internlm(sources, tokenizer, version, **kw)
    return preprocess_v1(sources, tokenizer, version, **kw)
