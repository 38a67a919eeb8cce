"""Host-side multimodal utilities: image resizing, CLIP preprocessing and
prompt <-> token plumbing (counterpart of `visionllm_tpu/data/mm_utils.py`:
`expand2square`, `resize_image`, `clip_preprocess`,
`find_closest_aspect_ratio`, `dynamic_preprocess`,
`tokenizer_image_token`, `expand_image_tokens`, `find_stop`; and of
`visionllm_tpu/eval/region_eval.py`'s region helpers `region_str`,
`boxes_to_masks` and `clip_region_masks`, which serving and the region
eval share).

The JAX package resizes with its native copy of Pillow's resampler (or
Pillow). The port does without Pillow: `resize_image` runs the same
native resizer (`native_image.resize_u8`), and `resize_image_np` repeats
Pillow's 8-bit algorithm in numpy as its plain version - the antialiased
bicubic (a = -0.5) or triangle (bilinear) filter, support widened by the
downscale factor, weights normalized per output pixel and rounded to
22-bit fixed point, a width pass then a height pass, each rounded and
clamped to uint8 - and its nearest-neighbour stepping, so both give
Pillow's pixels.
`resize_float` is Pillow's bilinear resize of a float32 ("F") image,
which keeps the weights in double precision.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from visionllm_tpu_torch.constants import DEFAULT_TOKENS, IMAGE_TOKEN_INDEX
from visionllm_tpu_torch.data.native_image import resize_u8

# CLIP normalization constants (CLIPImageProcessor defaults)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
# ImageNet normalization (det/pose image branch)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


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


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# Pillow's resampling filters: (filter, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_triangle, 1.0)}


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int, method: str):
    """Per output pixel: ksize source indices (clamped; their weights are
    0) and the weights normalized to sum 1, in double precision; cached
    by size and method, read-only (the masks of an image share them)."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            kk[xx, x] = v / ww if ww != 0.0 else v
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    idx.setflags(write=False)
    kk.setflags(write=False)
    return idx, kk


def _fixed_point(kk: np.ndarray) -> np.ndarray:
    """Weights rounded half away from zero to 22-bit fixed point."""
    v = kk * (1 << _PRECISION_BITS)
    return np.where(v < 0, -np.floor(0.5 - v), np.floor(v + 0.5)).astype(
        np.int64)


def _resample_u8(img: np.ndarray, axis: int, out_size: int, method: str
                 ) -> np.ndarray:
    """One pass over int64 pixels in [0, 255]: the fixed-point sum with
    Pillow's rounding offset, then the clamp to [0, 255]."""
    idx, kk = _coeffs(img.shape[axis], out_size, method)
    kk = _fixed_point(kk)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(1, 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(idx.shape[1]):
        acc = acc + np.take(img, idx[:, t], axis=axis) * \
            kk[:, t].reshape(shape)
    return np.where(acc >= 1 << (_PRECISION_BITS + 8), 255,
                    np.where(acc <= 0, 0, acc >> _PRECISION_BITS))


def _resample_f32(img: np.ndarray, axis: int, out_size: int, method: str
                  ) -> np.ndarray:
    """One pass over float32 pixels ("F" mode): a double sum over the
    taps in order, rounded to float32."""
    idx, kk = _coeffs(img.shape[axis], out_size, method)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.zeros(1, np.float64)
    for t in range(idx.shape[1]):
        acc = acc + np.take(img, idx[:, t], axis=axis).astype(np.float64) \
            * kk[:, t].reshape(shape)
    return acc.astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest neighbour: the source coordinate starts at half a
    step and advances by the step in double precision, truncated."""
    step = in_size / out_size
    pos = step * 0.5
    out = np.empty(out_size, np.int64)
    for i in range(out_size):
        out[i] = int(pos)
        pos += step
    return out


def resize_image(img: np.ndarray, size: Tuple[int, int],
                 method: str = "bilinear") -> np.ndarray:
    """HW or HWC resize to `size` (h, w) with Pillow's pixels, as the JAX
    `resize_image` gives them: a uint8 image (any other dtype is first
    cast to uint8, as the JAX package does before Pillow) through the
    native resizer (`native_image.resize_u8`, GIL-free, as the JAX
    package's fast path); `resize_image_np` is its plain version."""
    x = img if img.dtype == np.uint8 else img.astype(np.uint8)
    if method not in _FILTERS and method != "nearest":
        raise ValueError(f"unknown resize method {method!r}")
    if x.size == 0:
        return resize_image_np(x, size, method)
    if x.shape[:2] == tuple(size):      # Pillow returns a copy as well
        return x.copy()
    return resize_u8(x, size, method)


def resize_image_np(img: np.ndarray, size: Tuple[int, int],
                    method: str = "bilinear") -> np.ndarray:
    """The plain version of `resize_image`, in numpy: Pillow's 8-bit
    path, a width pass then a height pass for "bilinear" and "bicubic",
    each rounded and clamped; "nearest" picks rows and columns."""
    x = img if img.dtype == np.uint8 else img.astype(np.uint8)
    if method == "nearest":
        x = x[_nearest_index(x.shape[0], size[0])] \
            if x.shape[0] != size[0] else x
        x = x[:, _nearest_index(x.shape[1], size[1])] \
            if x.shape[1] != size[1] else x
        return x.copy()
    if method not in _FILTERS:
        raise ValueError(f"unknown resize method {method!r}")
    x = x.astype(np.int64)
    if x.shape[1] != size[1]:
        x = _resample_u8(x, 1, size[1], method)
    if x.shape[0] != size[0]:
        x = _resample_u8(x, 0, size[0], method)
    return x.astype(np.uint8)


def resize_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """float32 [H, W] -> float32 [size[0], size[1]]: Pillow's bilinear
    resize of an "F"-mode image (double weights, no fixed point), width
    pass then height pass."""
    x = np.asarray(img, np.float32)
    if x.shape[1] != size[1]:
        x = _resample_f32(x, 1, size[1], "bilinear")
    if x.shape[0] != size[0]:
        x = _resample_f32(x, 0, size[0], "bilinear")
    return x


def clip_preprocess(img: np.ndarray, image_size: int = 336,
                    mode: str = "pad") -> np.ndarray:
    """uint8 HWC -> normalized float32 [image_size, image_size, 3]. mode
    "pad": expand2square with the CLIP mean (llava-style), then resize;
    mode "resize": plain resize."""
    if mode == "pad":
        img = expand2square(img, (CLIP_MEAN * 255).astype(np.uint8))
    img = resize_image(img, (image_size, image_size), "bicubic")
    x = img.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios, width,
                              height, image_size):
    """The (cols, rows) grid of `target_ratios` nearest `aspect_ratio`;
    a tie goes to the later grid when the image covers more than half
    of its area."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def dynamic_preprocess(img: np.ndarray, min_num: int = 1, max_num: int = 6,
                       image_size: int = 448, use_thumbnail: bool = True
                       ) -> List[np.ndarray]:
    """anyres tiling: split into up to max_num tiles of image_size² at the
    closest grid aspect ratio, plus a global thumbnail. Returns a list of
    HWC uint8 tiles."""
    h, w = img.shape[:2]
    aspect = w / h
    target_ratios = sorted(
        {(i, j) for n in range(min_num, max_num + 1)
         for i in range(1, n + 1) for j in range(1, n + 1)
         if min_num <= i * j <= max_num},
        key=lambda x: x[0] * x[1])
    cols, rows = find_closest_aspect_ratio(aspect, target_ratios, w, h,
                                           image_size)
    tw, th = image_size * cols, image_size * rows
    resized = resize_image(img, (th, tw))
    tiles = []
    for i in range(cols * rows):
        x0 = (i % cols) * image_size
        y0 = (i // cols) * image_size
        tiles.append(resized[y0:y0 + image_size, x0:x0 + image_size])
    if use_thumbnail and len(tiles) != 1:
        tiles.append(resize_image(img, (image_size, image_size)))
    return tiles


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


def region_str(n: int = 1, named: bool = True) -> str:
    """'<reg>region1<region></reg>, ...' for n regions (the caption eval's
    unnumbered '<reg>region<region></reg>' with named=False)."""
    parts = [DEFAULT_TOKENS["sor"] + (f"region{i + 1}" if named
                                      else "region")
             + DEFAULT_TOKENS["reg"] + DEFAULT_TOKENS["eor"]
             for i in range(n)]
    return ", ".join(parts)


def boxes_to_masks(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy boxes [N, 4] -> binary masks [N, h, w]: rows y0..ceil(y1),
    columns x0..ceil(x1), the lower corner truncated."""
    masks = np.zeros((len(boxes), h, w), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        masks[i, int(y0):int(math.ceil(y1)), int(x0):int(math.ceil(x1))] = 1
    return masks


def clip_region_masks(masks: np.ndarray, image_size: int,
                      aspect: str = "pad") -> np.ndarray:
    """[R, H, W] original-geometry masks -> [R, image_size, image_size]
    in the CLIP input's geometry: padded to a centred square with zeros
    (aspect "pad", as `clip_preprocess` pads the image), resized by
    nearest neighbour, thresholded at half."""
    out = []
    for m in masks:
        m255 = (m[..., None] * 255).astype(np.uint8)
        if aspect == "pad":
            m255 = expand2square(m255, (0,))
        out.append((resize_image(m255[..., 0], (image_size, image_size),
                                 "nearest") > 127).astype(np.float32))
    return np.stack(out) if out else np.zeros(
        (0, image_size, image_size), np.float32)
