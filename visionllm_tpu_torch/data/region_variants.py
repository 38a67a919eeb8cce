"""Region-level dataset variants: VG, RefCOCO regions, VCR, Osprey,
V3Det, LVIS and COCO recognition (counterpart of
`visionllm_tpu/data/region_variants.py`; its template strings are the
reference's byte for byte, for prompt parity).

* `vg_region` - VG region descriptions (vg.py:32-69, 293-295).
* `refcoco_region` - a region's referring expression as the answer
  (refcoco.py:59-151, 326-328).
* `vcr`, `vcr_vqa` - multi-region QA: bracketed object numbers in the
  question become region tags, in the answers object names; answers are
  `lower().capitalize()`d (vcr.py:45-140).
* `osprey` and its five flavours - multi-turn region dialogue; the
  "<region-N>" placeholders become region tags.
* `v3det_region`, `lvis_region`, `coco_region_recognition` - one
  recognition question a region, one-word answers (v3det.py:189-232,
  lvis.py:27-59).

Each sample's `regions` are [R, image_size, image_size] float masks in
the CLIP input's 'pad' geometry, one a <region> token of the
conversation. The prompt carries `image_token_len` <im_patch> ids where
the JAX datasets count `(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

import os
import random
import re
from typing import Dict, List

import numpy as np

from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.image_io import load_image
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               clip_region_masks)
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.region_dataset import region_mask_from_ann
from visionllm_tpu_torch.data.semseg_dataset import read_rows

REGION_STR = "<reg>region{i}<region></reg>"   # DEFAULT_TOKENS sor/reg/eor

VG_QUESTIONS = [
    "Can you provide me with a brief description of <spi_descript> in the picture?",
    "I'm curious about the region represented by <spi_descript> in the picture. Could you describe it in short?",
    "What can you tell me about <spi_descript> in the image?",
    "I'd like to know more about the area in the photo labeled <spi_descript>. Can you give me a brief description?",
    "Could you describe <spi_descript> in the picture in short?",
    "What content can you give me about <spi_descript> in the photo?",
    "Please provide me with a short description of <spi_descript> in the image.",
    "Can you give me a brief account of the region labeled as <spi_descript> in the picture?",
    "I'm interested in learning more about <spi_descript> in the photo. Can you describe it in short?",
    "What is the region outlined by <spi_descript> in the picture like? Could you give me a brief description?",
]

VG_BEGIN = "The <image> provides an overview of the picture.\n"

REFCOCO_BEGIN = (
    "<image>\n I will provide you with only one region "
    "containing only one object, although there may be other "
    "objects present in the image. It is recommended that you "
    "describe the object's relative position with respect to other "
    "objects in the image, as well as its position within "
    "the image and its basic attributes.")

RECOGNITION_QUESTIONS = [
    "Whis is the object category of <regions>? Answer the question with single word or phrase.",
    "Could you tell me what is the object in <regions>? Answer the question with single word or phrase.",
    "What category best describes the area represented by <regions>? Answer the question with single word or phrase.",
    "Can you specify the type of object inside the region labeld by <regions>? Answer the question with single word or phrase.",
    "How would you label the area indicated by <regions> in the image? Answer the question with single word or phrase.",
    "Give a category label to the region outlined by <regions>. Answer the question with single word or phrase.",
    "Please identify the category of the object inside the <regions>. Answer the question with single word or phrase.",
    "Examine and determine the primary subject located within <regions>. Answer the question with single word or phrase.",
    "I need your help to assign a object category to the <regions>, please. Answer the question with single word or phrase.",
    "Evaluate the content to the region shown as <regions> and provide its category. Answer the question with single word or phrase.",
]


class _RegionVariantBase:
    """Shared loading/tokenization for the region variants. Annotation
    rows are json/jsonl dicts; subclasses build the conversation and
    the region list."""

    task = "region_refer"
    dataset_name = "region"

    def __init__(self, ann_file: str, img_prefix: str, tokenizer, *,
                 image_token_len: int, image_size: int = 336,
                 image_aspect_ratio: str = "pad",
                 conv_version: str = "vicuna_v1",
                 model_max_length: int = 4096, seed: int = 0,
                 test_mode: bool = False, max_regions: int = 8, **_):
        self.rows = read_rows(ann_file)
        self.img_prefix = img_prefix
        self.tokenizer = tokenizer
        self.image_token_len = image_token_len
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.model_max_length = model_max_length
        self.test_mode = test_mode
        self.max_regions = max_regions
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.rows)

    def _load_image(self, row) -> np.ndarray:
        return load_image(os.path.join(self.img_prefix, row["image"]))

    def _regions_from_row(self, row, h, w) -> np.ndarray:
        """[R, h, w] region masks from row["regions"] (list of dicts
        with bbox/segmentation) or row["bbox"]."""
        anns = row.get("regions")
        if anns is None:
            anns = [row]
        masks = [region_mask_from_ann(a, h, w)
                 for a in anns[:self.max_regions]]
        return np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)

    def _conversations(self, row) -> List[Dict[str, str]]:
        raise NotImplementedError

    def _answer_text(self, row) -> str:
        convs = self._conversations(row)
        return convs[1]["value"] if len(convs) > 1 else ""

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        img = self._load_image(row)
        h, w = img.shape[:2]
        masks = self._regions_from_row(row, h, w)
        conversations = self._conversations(row)
        tok = preprocess(
            preprocess_multimodal([conversations]), self.tokenizer,
            version=self.conv_version, has_image=True,
            image_token_len=self.image_token_len,
            model_max_length=self.model_max_length)
        regions = clip_region_masks(masks, self.image_size)
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": clip_preprocess(img, self.image_size,
                                     self.image_aspect_ratio
                                     ).astype(np.float32),
            "regions": regions,
            "num_regions": len(regions),
            "answer": self._answer_text(row),
            "img_metas": {"task": self.task,
                          "dataset_name": self.dataset_name},
        }


@register_dataset("vg_region")
class VGRegionDataset(_RegionVariantBase):
    """rows: {"image", "bbox"|"segmentation", "caption"}."""

    task = "region_refer"
    dataset_name = "vg"

    def _conversations(self, row):
        q_t = (VG_QUESTIONS[0] if self.test_mode
               else self.rng.choice(VG_QUESTIONS))
        region = REGION_STR.format(i=1)
        q = VG_BEGIN + q_t.replace("<spi_descript>", region)
        return [{"from": "human", "value": q},
                {"from": "gpt", "value": row.get("caption", "")}]


@register_dataset("refcoco_region")
class RefCocoRegionDataset(_RegionVariantBase):
    """rows: {"image", "bbox"|"segmentation", "caption": <referring
    expression>} — the expression is the training answer."""

    task = "region_refer"
    dataset_name = "refcoco"

    def _conversations(self, row):
        region = REGION_STR.format(i=1)
        q = (REFCOCO_BEGIN + " This is the region you need to describe: "
             + region + ".")
        return [{"from": "human", "value": q},
                {"from": "gpt", "value": row.get("caption", "")}]


@register_dataset("vcr")
class VCRDataset(_RegionVariantBase):
    """rows: {"image", "boxes": [[x1,y1,x2,y2],...], "objects":
    [names...], "conversations": [...]} — question text references
    regions as bare numbers which become region tags (vcr.py:27-43);
    answers reference them as the object names; answers are
    lower().capitalize()'d (vcr.py:78-82)."""

    task = "region_refer"
    dataset_name = "vcr"

    def _regions_from_row(self, row, h, w):
        boxes = row.get("boxes", [])[:self.max_regions]
        masks = []
        for b in boxes:
            x1, y1, x2, y2 = [int(v) for v in b[:4]]
            m = np.zeros((h, w), np.uint8)
            m[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = 1
            masks.append(m)
        return (np.stack(masks) if masks
                else np.zeros((0, h, w), np.uint8))

    @staticmethod
    def _numbers_to_tokens(text: str) -> str:
        return re.sub(r"\[(\d+)\]",
                      lambda m: REGION_STR.format(i=int(m.group(1)) + 1),
                      text)

    def _numbers_to_names(self, text: str, objects: List[str]) -> str:
        def sub(m):
            i = int(m.group(1))
            return objects[i] if i < len(objects) else m.group(0)
        return re.sub(r"\[(\d+)\]", sub, text)

    def _conversations(self, row):
        objects = row.get("objects", [])
        convs = [dict(c) for c in row["conversations"]]
        convs[0]["value"] = ("<image>\n"
                             + self._numbers_to_tokens(convs[0]["value"]))
        for j in range(1, len(convs), 2):
            a = self._numbers_to_names(convs[j]["value"], objects)
            convs[j]["value"] = a.lower().capitalize()
        return convs


@register_dataset("osprey")
class OspreyDataset(_RegionVariantBase):
    """rows: {"image", "regions": [...], "conversations": [...]} —
    multi-turn region dialogue; region tags already present in the
    question text as <region-N> placeholders, rewritten to the
    framework's region string."""

    task = "region_vqa"
    dataset_name = "osprey"

    def _conversations(self, row):
        convs = [dict(c) for c in row["conversations"]]
        def retag(text):
            return re.sub(r"<region-?(\d+)>",
                          lambda m: REGION_STR.format(i=int(m.group(1))),
                          text)
        convs[0]["value"] = "<image>\n" + retag(convs[0]["value"])
        for j in range(2, len(convs), 2):
            convs[j]["value"] = retag(convs[j]["value"])
        return convs


@register_dataset("v3det_region")
class V3DetRegionDataset(_RegionVariantBase):
    """rows: {"image", "regions": [{"bbox"/"segmentation",
    "category"}]} — one recognition question per region, single-word
    category answers (v3det.py:189-232)."""

    task = "region_recognition"
    dataset_name = "v3det"

    def _conversations(self, row):
        convs = []
        for i, r in enumerate(row.get("regions", [])[:self.max_regions]):
            q_t = (RECOGNITION_QUESTIONS[0] if self.test_mode
                   else self.rng.choice(RECOGNITION_QUESTIONS))
            q = q_t.replace("<regions>", REGION_STR.format(i=i + 1))
            if i == 0:
                q = "<image>\n" + q
            convs.append({"from": "human", "value": q})
            convs.append({"from": "gpt", "value": r.get("category", "")})
        return convs

    def _answer_text(self, row):
        return ", ".join(r.get("category", "")
                         for r in row.get("regions", [])[:self.max_regions])


@register_dataset("lvis_region")
class LVISRegionDataset(V3DetRegionDataset):
    """Same protocol over the LVIS vocabulary; masks typically come
    from segmentations rather than boxes (lvis.py:27-59)."""

    dataset_name = "lvis"


COCO_RECOGNITION_QUESTIONS = [
    q.replace("Answer the question with single word or phrase.",
              "Answer with the category name from COCO-80, and use "
              "single word or phrase.")
    for q in RECOGNITION_QUESTIONS
]


@register_dataset("coco_region_recognition")
class CocoRecognitionDataset(V3DetRegionDataset):
    """COCO-80 region recognition (v3det.py CocoRecognition subclass:
    COCO_QUESTIONS ask for a COCO-80 category name)."""

    dataset_name = "coco"

    def _conversations(self, row):
        convs = []
        for i, r in enumerate(row.get("regions", [])[:self.max_regions]):
            q_t = (COCO_RECOGNITION_QUESTIONS[0] if self.test_mode
                   else self.rng.choice(COCO_RECOGNITION_QUESTIONS))
            q = q_t.replace("<regions>", REGION_STR.format(i=i + 1))
            if i == 0:
                q = "<image>\n" + q
            convs.append({"from": "human", "value": q})
            convs.append({"from": "gpt", "value": r.get("category", "")})
        return convs


@register_dataset("vcr_vqa")
class VCRVQADataset(VCRDataset):
    """VCR as region VQA (reference: datasets/vcr_vqa.py VCRVQA): the
    Q->A and QA->R rounds become free-text answers scored by the VQA
    harness instead of region captions."""

    task = "region_vqa"
    dataset_name = "vcr_vqa"


# Osprey conversation flavors (reference: datasets/osprey.py —
# OspreyConversations / OspreyDetailedDescription / OspreyShortForm /
# OspreyPartLevel / OspreyLVISPosNeg subclass the same machinery and
# differ in source file + answer style; rows here share the
# {"image", "regions", "conversations"} schema).
@register_dataset("osprey_conversations")
class OspreyConversationsDataset(OspreyDataset):
    dataset_name = "osprey_conversations"


@register_dataset("osprey_detailed")
class OspreyDetailedDescriptionDataset(OspreyDataset):
    dataset_name = "osprey_detailed"


@register_dataset("osprey_short")
class OspreyShortFormDataset(OspreyDataset):
    dataset_name = "osprey_short"


@register_dataset("osprey_part")
class OspreyPartLevelDataset(OspreyDataset):
    dataset_name = "osprey_part"


@register_dataset("osprey_lvis_posneg")
class OspreyLVISPosNegDataset(OspreyDataset):
    dataset_name = "osprey_lvis_posneg"
