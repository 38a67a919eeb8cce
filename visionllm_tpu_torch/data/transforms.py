"""Detection-branch transforms (host-side numpy; counterpart of
`visionllm_tpu/data/transforms.py`): keep-ratio resize, random flip and
crop, ImageNet normalization, and padding to the smallest of a few shape
buckets with the validity mask. The test pipeline resizes to (800, 1333);
the train pipeline (`det_train_transform`) is the reference's multi-scale
AutoAugment, drawing from the caller's `random.Random` in the order JAX
draws, so one seed gives JAX's sample. Boxes are xyxy pixel coordinates
and masks [N, H, W]; every step keeps them in sync.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from visionllm_tpu_torch.data.mm_utils import (IMAGENET_MEAN, IMAGENET_STD,
                                               resize_image)

# the reference's multi-scale ladder (coco_llava.py:110-118)
TRAIN_SCALES = [(480, 1333), (512, 1333), (544, 1333), (576, 1333),
                (608, 1333), (640, 1333), (672, 1333), (704, 1333),
                (736, 1333), (768, 1333), (800, 1333)]
TEST_SCALE = (800, 1333)

DEFAULT_BUCKETS = ((512, 512), (512, 800), (800, 512), (800, 800),
                   (800, 1088), (1088, 800), (800, 1344), (1344, 800))


def keep_ratio_size(h: int, w: int, scale: Tuple[int, int]
                    ) -> Tuple[int, int]:
    """mmdet keep_ratio rescale: short side <= scale[0], long <= scale[1]."""
    short, long = scale
    f = min(short / min(h, w), long / max(h, w))
    return max(1, int(round(h * f))), max(1, int(round(w * f)))


def resize(sample: Dict, scale: Tuple[int, int]) -> Dict:
    img = sample["image"]
    h, w = img.shape[:2]
    nh, nw = keep_ratio_size(h, w, scale)
    out = dict(sample)
    out["image"] = resize_image(img, (nh, nw))
    fy, fx = nh / h, nw / w
    if "boxes" in sample and len(sample["boxes"]):
        out["boxes"] = sample["boxes"] * np.asarray([fx, fy, fx, fy],
                                                    np.float32)
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = np.stack([
            resize_image(m.astype(np.uint8) * 255, (nh, nw),
                         "nearest") > 127
            for m in sample["masks"]]).astype(np.uint8)
    return out


def random_flip(sample: Dict, prob: float = 0.5,
                rng: Optional[random.Random] = None) -> Dict:
    r = rng or random
    if r.random() >= prob:
        return sample
    img = sample["image"]
    w = img.shape[1]
    out = dict(sample)
    out["image"] = img[:, ::-1].copy()
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"].copy()
        b[:, [0, 2]] = w - sample["boxes"][:, [2, 0]]
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = sample["masks"][:, :, ::-1].copy()
    return out


def random_crop(sample: Dict, crop_size: Tuple[int, int] = (384, 600),
                rng: Optional[random.Random] = None) -> Dict:
    """mmdet RandomCrop, crop_type='absolute_range',
    allow_negative_crop=True."""
    r = rng or random
    img = sample["image"]
    h, w = img.shape[:2]
    ch = min(h, r.randint(crop_size[0], crop_size[1]))
    cw = min(w, r.randint(crop_size[0], crop_size[1]))
    y0 = r.randint(0, h - ch)
    x0 = r.randint(0, w - cw)
    out = dict(sample)
    out["image"] = img[y0:y0 + ch, x0:x0 + cw].copy()
    if "boxes" in sample and len(sample["boxes"]):
        b = sample["boxes"] - np.asarray([x0, y0, x0, y0], np.float32)
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, cw)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, ch)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        out["boxes"] = b[keep]
        out["labels"] = sample["labels"][keep]
        if "masks" in sample and len(sample["masks"]):
            out["masks"] = sample["masks"][keep][:, y0:y0 + ch,
                                                 x0:x0 + cw].copy()
    return out


def normalize(sample: Dict) -> Dict:
    out = dict(sample)
    x = sample["image"].astype(np.float32) / 255.0
    out["image"] = (x - IMAGENET_MEAN) / IMAGENET_STD
    return out


def pad_to_bucket(sample: Dict,
                  buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                  ) -> Dict:
    """Pad the image (bottom/right) to the smallest bucket that fits (crop
    to the largest when none does) and emit the validity mask."""
    img = sample["image"]
    h, w = img.shape[:2]
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        bh, bw = min(fitting, key=lambda b: b[0] * b[1])
    else:
        bh, bw = max(buckets, key=lambda b: b[0] * b[1])
        img = img[:bh, :bw]
        h, w = img.shape[:2]
    out = dict(sample)
    padded = np.zeros((bh, bw, img.shape[2]), img.dtype)
    padded[:h, :w] = img
    pix_mask = np.zeros((bh, bw), bool)
    pix_mask[:h, :w] = True
    out["image"] = padded
    out["pixel_mask"] = pix_mask
    out["img_shape"] = (h, w)
    if "masks" in sample and len(sample["masks"]):
        mh = np.zeros((len(sample["masks"]), bh, bw), np.uint8)
        mh[:, :h, :w] = sample["masks"][:, :bh, :bw]
        out["masks"] = mh
    return out


def det_train_transform(sample: Dict,
                        rng: Optional[random.Random] = None,
                        scales: Optional[Sequence[Tuple[int, int]]] = None,
                        buckets: Optional[Sequence[Tuple[int, int]]] = None
                        ) -> Dict:
    """The reference's AutoAugment train pipeline: flip, then either a
    plain multi-scale resize or resize -> crop -> resize
    (coco_llava.py:104-146), then normalize and bucket-pad."""
    r = rng or random
    scales = scales or TRAIN_SCALES
    sample = random_flip(sample, 0.5, r)
    if r.random() < 0.5 or len(scales) == 1:
        sample = resize(sample, r.choice(scales))
    else:
        sample = resize(sample, r.choice([(400, 4200), (500, 4200),
                                          (600, 4200)]))
        sample = random_crop(sample, (384, 600), r)
        sample = resize(sample, r.choice(scales))
    sample = normalize(sample)
    return pad_to_bucket(sample, buckets or DEFAULT_BUCKETS)


def det_test_transform(sample: Dict, scale: Tuple[int, int] = TEST_SCALE,
                       buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                       ) -> Dict:
    """Test pipeline: keep-ratio resize to `scale`, normalize, pad."""
    sample = resize(sample, scale)
    sample = normalize(sample)
    return pad_to_bucket(sample, buckets)
