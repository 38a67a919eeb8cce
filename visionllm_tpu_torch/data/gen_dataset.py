"""Text-to-image ([GEN]) and editing ([EDIT]) datasets (counterpart of
`visionllm_tpu/data/gen_dataset.py`, after the reference's text2img.py
and ip2p.py): a caption -> "[GEN]" + num_embs_gen x "[EMB]" answer with
the image to make, and an instruction on an input image -> "[EDIT]" +
num_embs_gen x "[EMB]" with the input and output images. The VAE's
images are `output_size` squares in [-1, 1], resized by the port's
Pillow-exact `resize_image`; files are read by `data/image_io.py`.

Annotation files are json lists or jsonl rows: {"image", "caption"} for
text-to-image, {"input_image", "output_image", "instruction"} for
editing. The named text-to-image sources (cc3m, laion, mj, journeydb)
and the SEED-X editing pairs (seedx) read the same rows.

`IP2PDataset` takes `image_token_len` (the model's image feature rows,
`VisionLLMConfig.image_token_len`) and the CLIP `image_size` (336 by
default) from the caller; the JAX dataset writes 576 and 336, wrong
under pixel shuffle (the 26B's 256 rows a 448 px tile; `ROADMAP.md`
§C.2).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from visionllm_tpu_torch.data import templates as T
from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import clip_preprocess, resize_image
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)

GEN_QUESTIONS = [
    "Can you generate an image of <caption>?",
    "Please create an image: <caption>.",
    "Draw this for me: <caption>.",
    "I'd like a picture of <caption>.",
]
GEN_ANS = [
    "Sure, here it is: <gen>.",
    "Of course: <gen>.",
    "Here is the generated image: <gen>.",
]
EDIT_QUESTIONS = [
    "<instruction>",
    "Please edit the image: <instruction>.",
    "Apply this edit: <instruction>.",
]
EDIT_ANS = [
    "Sure, here is the edited image: <gen>.",
    "Done: <gen>.",
]


def _to_vae(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [size, size, 3] in [-1, 1]."""
    x = resize_image(img, (size, size)).astype(np.float32)
    return x / 127.5 - 1.0


def _read_rows(ann_file: str):
    with open(ann_file) as f:
        if ann_file.endswith(".jsonl"):
            return [json.loads(line) for line in f]
        return json.load(f)


class _GenBase:
    """The rows, tokenizer and templates shared by both datasets; other
    keywords (the ones the det datasets take) are ignored, as in JAX."""

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 num_embs_gen: int = 64, output_size: int = 512,
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0, **_):
        self.rows = _read_rows(ann_file)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.num_embs_gen = num_embs_gen
        self.output_size = output_size
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def _image(self, name: str) -> np.ndarray:
        return load_image(os.path.join(self.img_prefix, name))

    def _tokens(self, q: str, a: str, **kw) -> Dict:
        return preprocess(
            preprocess_multimodal([[{"from": "human", "value": q},
                                    {"from": "gpt", "value": a}]]),
            self.tokenizer, version=self.conv_version,
            model_max_length=self.model_max_length, **kw)


@register_dataset("text2img")
class Text2ImgDataset(_GenBase):
    task = "t2i"
    dataset_name = "text2img"

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        caption = row["caption"]
        img = self._image(row["image"])
        q = self.rng.choice(GEN_QUESTIONS).replace("<caption>", caption)
        a = self.rng.choice(GEN_ANS).replace(
            "<gen>", T.gen_answer_tokens(self.num_embs_gen))
        tok = self._tokens(q, a, has_image=False)
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "output_images": _to_vae(img, self.output_size),
            "captions": caption,
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name},
        }


@register_dataset("ip2p")
class IP2PDataset(_GenBase):
    task = "edit"
    dataset_name = "ip2p"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 image_token_len: int, image_size: int = 336, **kw):
        super().__init__(ann_file, img_prefix, tokenizer, **kw)
        self.image_token_len = image_token_len
        self.image_size = image_size

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        src = self._image(row["input_image"])
        dst = self._image(row["output_image"])
        q = "<image>\n" + self.rng.choice(EDIT_QUESTIONS).replace(
            "<instruction>", row["instruction"])
        a = self.rng.choice(EDIT_ANS).replace(
            "<gen>", T.edit_answer_tokens(self.num_embs_gen))
        tok = self._tokens(q, a, has_image=True,
                           image_token_len=self.image_token_len)
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_preprocess(src, self.image_size,
                                     "pad").astype(np.float32),
            "input_images": _to_vae(src, self.output_size),
            "output_images": _to_vae(dst, self.output_size),
            "captions": row["instruction"],
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name},
        }


@register_dataset("cc3m")
class CC3MDataset(Text2ImgDataset):
    dataset_name = "cc3m"


@register_dataset("laion")
class LaionDataset(Text2ImgDataset):
    dataset_name = "laion"


@register_dataset("mj")
class MJDataset(Text2ImgDataset):
    dataset_name = "mj"


@register_dataset("journeydb")
class JourneyDBDataset(Text2ImgDataset):
    dataset_name = "journeydb"


@register_dataset("seedx")
class SeedXDataset(IP2PDataset):
    dataset_name = "seedx"
