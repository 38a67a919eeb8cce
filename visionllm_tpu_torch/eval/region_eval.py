"""Region-prompted generation: the prompt and mask helpers of the region
evals and their greedy decode loop (counterpart of
`visionllm_tpu/eval/region_eval.py:47-150`; its dataset loaders and
scorers are not ported).

The prompt's region strings (`region_str`) and the masks' trip to the
CLIP input geometry (`boxes_to_masks`, `clip_region_masks`) live in
`data/mm_utils.py`, which serving shares; `run_region_generate` decodes
each row greedily with its regions conditioning the prefill through the
region encoder.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.constants import DEFAULT_TOKENS
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               clip_region_masks,
                                               expand_image_tokens,
                                               find_stop,
                                               tokenizer_image_token)
from visionllm_tpu_torch.device import resolve_device

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
