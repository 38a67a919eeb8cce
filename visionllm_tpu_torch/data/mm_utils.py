"""Host-side multimodal utilities: CLIP image preprocessing and
prompt <-> token plumbing (counterpart of `visionllm_tpu/data/mm_utils.py`:
`expand2square`, `clip_preprocess`, `tokenizer_image_token`,
`expand_image_tokens`, `find_stop`).

The JAX package resizes with Pillow's bicubic resampler (or its native
copy of it). The port does without Pillow: `resize_bicubic` repeats
Pillow's 8-bit algorithm in numpy - the antialiased bicubic filter
(a = -0.5, support widened by the downscale factor), coefficients
normalized per output pixel and rounded to 22-bit fixed point, a width
pass then a height pass, each rounded and clamped to uint8 - so it gives
Pillow's pixels.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from visionllm_tpu_torch.constants import IMAGE_TOKEN_INDEX

# CLIP normalization constants (CLIPImageProcessor defaults)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def expand2square(img: np.ndarray, background: Sequence[float]) -> np.ndarray:
    """Pad an HWC image to a centered square."""
    h, w, c = img.shape
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side, c), img.dtype)
    out[...] = np.asarray(background, img.dtype)
    if w > h:
        off = (side - h) // 2
        out[off:off + h, :, :] = img
    else:
        off = (side - w) // 2
        out[:, off:off + w, :] = img
    return out


_PRECISION_BITS = 22          # Pillow's fixed point for 8-bit images


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Per output pixel: ksize source indices and fixed-point weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss)
             for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            v *= 1 << _PRECISION_BITS
            kk[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return idx, kk


def _resample(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, kk = _coeffs(img.shape[axis], out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(1, 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(idx.shape[1]):
        acc = acc + np.take(img, idx[:, t], axis=axis) * \
            kk[:, t].reshape(shape)
    return np.where(acc >= 1 << (_PRECISION_BITS + 8), 255,
                    np.where(acc <= 0, 0, acc >> _PRECISION_BITS))


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC -> uint8 [size[0], size[1], C], Pillow's bicubic."""
    x = img.astype(np.int64)
    if x.shape[1] != size[1]:
        x = _resample(x, 1, size[1])
    if x.shape[0] != size[0]:
        x = _resample(x, 0, size[0])
    return x.astype(np.uint8)


def clip_preprocess(img: np.ndarray, image_size: int = 336,
                    mode: str = "pad") -> np.ndarray:
    """uint8 HWC -> normalized float32 [image_size, image_size, 3]. mode
    "pad": expand2square with the CLIP mean (llava-style), then resize;
    mode "resize": plain resize."""
    if mode == "pad":
        img = expand2square(img, (CLIP_MEAN * 255).astype(np.uint8))
    img = resize_bicubic(img, (image_size, image_size))
    x = img.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> np.ndarray:
    """Tokenize with `<image>` placeholders mapped to image_token_index:
    split on '<image>', tokenize the chunks, interleave the sentinel,
    keeping a single leading BOS."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]
    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        # every chunk re-tokenizes with a BOS; [offset:] strips it, and the
        # (offset+1)-long sentinel chunk leaves exactly one sentinel
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    for i, x in enumerate(chunks):
        if i:
            input_ids.extend(sep[offset:])
        input_ids.extend(x[offset:])
    return np.asarray(input_ids, dtype=np.int32)


def expand_image_tokens(input_ids: np.ndarray, img_len: int,
                        im_patch_id: int) -> np.ndarray:
    """Replace each IMAGE_TOKEN_INDEX sentinel with img_len `<im_patch>`
    ids (the static-shape prompt the model consumes)."""
    out: List[int] = []
    for t in input_ids.tolist():
        if t == IMAGE_TOKEN_INDEX:
            out.extend([im_patch_id] * img_len)
        else:
            out.append(t)
    return np.asarray(out, dtype=np.int32)


def find_stop(text: str, stop_strs: Sequence[str]) -> Optional[int]:
    """First index where any stop string begins, or None."""
    pos = None
    for s in stop_strs:
        i = text.find(s)
        if i >= 0 and (pos is None or i < pos):
            pos = i
    return pos
