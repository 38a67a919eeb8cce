"""COCO-compressed RLE mask codec (counterpart of
`visionllm_tpu/ops/rle.py`): column-major runs, each count stored as its
delta to the count two back in 5-bit groups offset by 48 - the wire
format of COCO tooling, so masks the perception endpoints return decode
with it; and `rle_iou`, the pairwise mask IoU of the COCO evaluator.

`rle_decode`, `rle_encode` and `rle_area` run the native codec
(`csrc/host/rle.cc`, a copy of the JAX package's, built with g++ at first
use by `kernels/host_build.py`, called through ctypes as the JAX package
calls it). Their `*_np` versions are the plain numpy codec; a string the
native decoder rejects (counts that do not fill the mask) takes the numpy
path, as in the JAX package."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np

from visionllm_tpu_torch.kernels.host_build import host_library

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = host_library("rle")
        lib.rle_decode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p]
        lib.rle_encode.restype = ctypes.c_int64
        lib.rle_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.rle_area.restype = ctypes.c_int64
        lib.rle_area.argtypes = [ctypes.c_char_p]
        _LIB = lib
    return _LIB


def _counts_from_string(s: bytes) -> List[int]:
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _string_from_counts(cnts: List[int]) -> bytes:
    out = bytearray()
    for i, c in enumerate(cnts):
        x = c - (cnts[i - 2] if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Compressed-RLE string -> row-major [h, w] uint8 mask."""
    if isinstance(counts, str):
        counts = counts.encode()
    out = np.zeros((h, w), np.uint8)
    if _lib().rle_decode(counts, h, w, out.ctypes.data) == 0:
        return out
    return rle_decode_np(counts, h, w)


def rle_decode_np(counts, h: int, w: int) -> np.ndarray:
    """The plain version of `rle_decode`."""
    if isinstance(counts, str):
        counts = counts.encode()
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in _counts_from_string(counts):
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T


def rle_encode(mask: np.ndarray) -> Dict:
    """Row-major [h, w] binary mask -> {"size": [h, w], "counts": str}."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    cap = 2 * h * w + 16
    buf = ctypes.create_string_buffer(cap)
    n = _lib().rle_encode(mask.ctypes.data, h, w, buf, cap)
    return {"size": [h, w], "counts": buf.raw[:n].decode()}


def rle_encode_np(mask: np.ndarray) -> Dict:
    """The plain version of `rle_encode`."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    col = mask.T.reshape(-1)
    change = np.nonzero(np.diff(col))[0] + 1
    bounds = np.concatenate([[0], change, [col.size]])
    runs = np.diff(bounds).tolist()
    if col[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": _string_from_counts(runs).decode()}


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    return int(_lib().rle_area(counts))


def rle_area_np(rle: Dict) -> int:
    """The plain version of `rle_area`."""
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    return int(sum(_counts_from_string(counts)[1::2]))


def rle_iou(dt: List[Dict], gt: List[Dict],
            iscrowd: Optional[List[int]] = None) -> np.ndarray:
    """Pairwise mask IoU [len(dt), len(gt)] of RLE dicts (decoded; the
    COCO evaluator's segm IoU). A crowd gt divides by the detection's
    area alone."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)), np.float64)
    h, w = dt[0]["size"]
    d = np.stack([rle_decode(x["counts"], h, w) for x in dt]).reshape(
        len(dt), -1).astype(bool)
    g = np.stack([rle_decode(x["counts"], h, w) for x in gt]).reshape(
        len(gt), -1).astype(bool)
    inter = (d[:, None] & g[None]).sum(-1).astype(np.float64)
    if iscrowd is None:
        iscrowd = [0] * len(gt)
    out = np.zeros((len(dt), len(gt)), np.float64)
    for j in range(len(gt)):
        if iscrowd[j]:
            denom = d.sum(-1).astype(np.float64)
        else:
            denom = d.sum(-1) + g[j].sum() - inter[:, j]
        out[:, j] = inter[:, j] / np.maximum(denom, 1)
    return out
