"""COCO-format annotation store and mask decoding (counterpart of
`visionllm_tpu/data/coco.py`): the JSON index with mmdet's contiguous
category mapping, per-image annotations, and polygon / uncompressed-RLE /
compressed-RLE segmentations to [H, W] uint8 masks.

The JAX package rasterizes polygons with Pillow's
`ImageDraw.polygon(pts, outline=1, fill=1)`. With the outline's ink equal
to the fill's, Pillow draws the fill alone; `rasterize_polygons` repeats
that fill in numpy pixel for pixel, as measured against Pillow 12.1:

- vertices are truncated toward zero to integers;
- a horizontal edge is drawn as its own span, and a horizontal edge that
  continues the previous one in the same direction extends it;
- every other edge is crossed at each row y from its top row to its
  bottom row at x = (y - y0) * dx + x0 in float32, with dx = (x1 - x0) /
  (y1 - y0) in float32; an edge crossed at its bottom row above the
  polygon's last row counts twice;
- at a corner where an edge crosses a row exactly at an integer and
  another edge starts (or ends) on that row at the same rounded x, the
  first such edge in polygon order that is not vertical decides: one of
  the other slope sign leaves the crossing; one of the same sign moves
  it to meet the next (or previous) row, to round(max) + 1 of the two
  edges' crossings there when it lies right of that, to round(min) - 1
  when it lies left of it (round half away from zero), each edge
  joining one such corner a row;
- the sorted crossings pair into spans [round_up(x0), round_down(x1)],
  each rounding half away from zero.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence

import numpy as np

from visionllm_tpu_torch.ops.rle import rle_decode


class CocoIndex:
    """Parsed COCO annotation file with contiguous category mapping
    (mmdet convention: cat ids -> 0..K-1 in category order)."""

    def __init__(self, ann_file: str, filter_empty: bool = False):
        with open(ann_file) as f:
            raw = json.load(f)
        self.images = {img["id"]: img for img in raw.get("images", [])}
        self.categories = sorted(raw.get("categories", []),
                                 key=lambda c: c["id"])
        self.cat2label = {c["id"]: i for i, c in enumerate(self.categories)}
        self.class_names = [c["name"] for c in self.categories]
        self.anns_by_image: Dict[int, List[dict]] = {
            i: [] for i in self.images}
        for ann in raw.get("annotations", []):
            if ann["image_id"] in self.anns_by_image:
                self.anns_by_image[ann["image_id"]].append(ann)
        ids = sorted(self.images)
        if filter_empty:
            ids = [i for i in ids if any(
                not a.get("iscrowd", 0) for a in self.anns_by_image[i])]
        self.img_ids = ids

    def __len__(self) -> int:
        return len(self.img_ids)

    def image_info(self, idx: int) -> dict:
        return self.images[self.img_ids[idx]]

    def load_anns(self, idx: int, with_mask: bool = False) -> dict:
        """labels [N], boxes xyxy [N, 4] float32, optional masks [N, H, W]
        uint8; crowd annotations and boxes of a side <= 1 px skipped, as
        mmdet does."""
        info = self.image_info(idx)
        h, w = info["height"], info["width"]
        labels, boxes, masks = [], [], []
        for ann in self.anns_by_image[self.img_ids[idx]]:
            if ann.get("iscrowd", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            if bw <= 1 or bh <= 1:
                continue
            labels.append(self.cat2label[ann["category_id"]])
            boxes.append([x, y, x + bw, y + bh])
            if with_mask:
                masks.append(decode_segmentation(ann.get("segmentation"),
                                                 h, w))
        out = {
            "labels": np.asarray(labels, np.int32),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "height": h, "width": w,
            "file_name": info["file_name"],
            "image_id": self.img_ids[idx],
        }
        if with_mask:
            out["masks"] = (np.stack(masks) if masks
                            else np.zeros((0, h, w), np.uint8))
        return out


_F = np.float32


def _roundf(x) -> float:
    """C's roundf: half away from zero."""
    x = float(x)
    return math.copysign(math.floor(abs(x) + 0.5), x)


def _round_up(f: np.float32) -> int:
    if f >= 0:
        return int(np.floor(f + _F(0.5)))
    return -int(np.floor(abs(f) + _F(0.5)))


def _round_down(f: np.float32) -> int:
    if f >= 0:
        return int(np.ceil(f - _F(0.5)))
    return -int(np.ceil(abs(f) - _F(0.5)))


def _hline(mask: np.ndarray, x0: int, y: int, x1: int) -> None:
    h, w = mask.shape
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            mask[y, x0:x1 + 1] = 1


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = (_F(0.0) if y0 == y1
                   else _F(x1 - x0) / _F(y1 - y0))
        self.x0, self.y0 = x0, y0

    def x_at(self, y: int) -> np.float32:
        return _F(_F(y - self.y0) * self.dx) + _F(self.x0)


def _edges(xy: Sequence[int]) -> List[_Edge]:
    n = len(xy) // 2
    edges: List[_Edge] = []
    for i in range(n - 1):
        x0, y0, x1, y1 = xy[2 * i:2 * i + 4]
        if y0 == y1 and i and y0 == xy[2 * i - 1]:
            # a horizontal edge continuing the previous one extends it
            if x1 > x0 > xy[2 * i - 2]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xy[2 * i - 2]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy[2 * n - 2] != xy[0] or xy[2 * n - 1] != xy[1]:
        edges.append(_Edge(xy[2 * n - 2], xy[2 * n - 1], xy[0], xy[1]))
    return edges


def _corner(table: List[_Edge], i: int, x: np.float32, y: int):
    """The moved crossing of edge i at its integral crossing x on row y,
    and the edge it joins, or None."""
    cur = table[i]
    for k, oth in enumerate(table):
        if k == i or not ((y == cur.ymin and y == oth.ymin)
                          or (y == cur.ymax and y == oth.ymax)):
            continue
        if _roundf(x) != _roundf(oth.x_at(y)) or oth.dx == 0:
            continue
        if (oth.dx > 0) != (cur.dx > 0):
            return None         # met first by an edge of the other slope
        off = -1 if y == cur.ymax else 1
        if not oth.ymin <= y + off <= oth.ymax:
            continue
        a, b = cur.x_at(y + off), oth.x_at(y + off)
        if x > _roundf(max(a, b)) + 1:
            return _F(_roundf(max(a, b)) + 1), k
        if x < _roundf(min(a, b)) - 1:
            return _F(_roundf(min(a, b)) - 1), k
        return None
    return None


def _fill_polygon(mask: np.ndarray, xy: Sequence[int]) -> None:
    h = mask.shape[0]
    table = []
    ymin, ymax = h - 1, 0
    for e in _edges(xy):
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(mask, e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    tops = np.asarray([e.ymin for e in table])
    bottoms = np.asarray([e.ymax for e in table])
    for y in range(max(ymin, 0), min(ymax, h) + 1):
        xx, joined = [], set()
        for i in np.nonzero((tops <= y) & (y <= bottoms))[0].tolist():
            cur = table[i]
            x = cur.x_at(y)
            xx.append(x)
            if y == cur.ymax and y < min(ymax, h):
                xx.append(x)
            elif cur.dx != 0 and i not in joined and _roundf(x) == x:
                moved = _corner(table, i, x, y)
                if moved is not None:
                    xx[-1] = moved[0]
                    joined.update((i, moved[1]))
        xx.sort()
        for t in range(1, len(xx), 2):
            _hline(mask, _round_up(xx[t - 1]), y, _round_down(xx[t]))


def rasterize_polygons(polys: Sequence[Sequence[float]], h: int,
                       w: int) -> np.ndarray:
    """COCO polygon list [[x0, y0, x1, y1, ...], ...] -> [h, w] uint8
    mask, Pillow's `ImageDraw.polygon` fill pixel for pixel (see the
    module docstring); polygons of fewer than 3 points are skipped."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            _fill_polygon(mask, [int(v) for p in pts for v in p])
    return mask


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """Polygon / RLE / compressed-RLE segmentation -> [H, W] uint8."""
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return rasterize_polygons(seg, h, w)
    counts = seg["counts"]
    if isinstance(counts, list):            # uncompressed RLE
        m = np.zeros(h * w, np.uint8)
        pos, val = 0, 0
        for c in counts:
            m[pos:pos + c] = val
            pos += c
            val = 1 - val
        return m.reshape(w, h).T            # column-major
    return rle_decode(counts, h, w)
