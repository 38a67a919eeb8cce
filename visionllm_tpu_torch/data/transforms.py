"""Detection-branch test transforms (host-side numpy; counterpart of the
test half of `visionllm_tpu/data/transforms.py`): keep-ratio resize to
(800, 1333), ImageNet normalization, and padding to the smallest of a
few shape buckets with the validity mask. Boxes are xyxy pixel
coordinates and masks [N, H, W]; every step keeps them in sync.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from visionllm_tpu_torch.data.mm_utils import (IMAGENET_MEAN, IMAGENET_STD,
                                               resize_image)

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


def det_test_transform(sample: Dict, scale: Tuple[int, int] = TEST_SCALE,
                       buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                       ) -> Dict:
    """Test pipeline: keep-ratio resize to `scale`, normalize, pad."""
    sample = resize(sample, scale)
    sample = normalize(sample)
    return pad_to_bucket(sample, buckets)
