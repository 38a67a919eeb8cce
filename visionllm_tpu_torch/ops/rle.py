"""COCO-compressed RLE mask codec in numpy (counterpart of the numpy path
of `visionllm_tpu/ops/rle.py`): column-major runs, each count stored as
its delta to the count two back in 5-bit groups offset by 48 - the wire
format of COCO tooling, so masks the perception endpoints return decode
with it."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


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
    return int(sum(_counts_from_string(counts)[1::2]))
