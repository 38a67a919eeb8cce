"""Visual-prompt shape sampler (counterpart of
`visionllm_tpu/data/visual_sampler.py`, after the reference's
datasets/visual_sampler/): each generator takes a ground-truth binary
mask and returns a binary prompt mask of the same size (a point, a box, a
circle, a scribble, a polygon or the mask itself), for the interactive
(<region>) datasets.

Every generator makes the JAX one's `random.Random` draws in the same
order, so one seed gives JAX's shapes. The polygon is filled by
`coco.rasterize_polygons`, which gives Pillow's
`ImageDraw.polygon(..., outline=1, fill=1)` pixel for pixel (with the
outline's ink equal to the fill's, Pillow draws the fill alone).
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional

import numpy as np

from visionllm_tpu_torch.data.coco import rasterize_polygons


def sample_point(mask: np.ndarray, rng: random.Random,
                 radius: int = 4) -> np.ndarray:
    """A disc of `radius` around one in-mask pixel."""
    out = np.zeros_like(mask, np.uint8)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return out
    i = rng.randrange(len(ys))
    y, x = int(ys[i]), int(xs[i])
    yy, xx = np.ogrid[:mask.shape[0], :mask.shape[1]]
    out[(yy - y) ** 2 + (xx - x) ** 2 <= radius ** 2] = 1
    return out


def sample_box(mask: np.ndarray, rng: random.Random,
               jitter: float = 0.1) -> np.ndarray:
    """The mask's tight box, shifted by up to `jitter` of its size."""
    out = np.zeros_like(mask, np.uint8)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return out
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    h, w = y1 - y0 + 1, x1 - x0 + 1
    jy = int(h * jitter * (rng.random() * 2 - 1))
    jx = int(w * jitter * (rng.random() * 2 - 1))
    y0 = np.clip(y0 + jy, 0, mask.shape[0] - 1)
    x0 = np.clip(x0 + jx, 0, mask.shape[1] - 1)
    y1 = np.clip(y1 + jy, y0, mask.shape[0] - 1)
    x1 = np.clip(x1 + jx, x0, mask.shape[1] - 1)
    out[y0:y1 + 1, x0:x1 + 1] = 1
    return out


def sample_circle(mask: np.ndarray, rng: random.Random) -> np.ndarray:
    """A disc at the mask's centroid, half its smaller extent across."""
    out = np.zeros_like(mask, np.uint8)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return out
    cy, cx = ys.mean(), xs.mean()
    r = max(2.0, 0.5 * min(ys.max() - ys.min(), xs.max() - xs.min()))
    yy, xx = np.ogrid[:mask.shape[0], :mask.shape[1]]
    out[(yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2] = 1
    return out


def sample_scribble(mask: np.ndarray, rng: random.Random,
                    n_segments: int = 6, thickness: int = 3) -> np.ndarray:
    """A walk through `n_segments + 1` in-mask pixels, thickened."""
    out = np.zeros_like(mask, np.uint8)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return out
    idx = [rng.randrange(len(ys)) for _ in range(n_segments + 1)]
    pts = [(int(ys[i]), int(xs[i])) for i in idx]
    half = thickness // 2
    for (y0, x0), (y1, x1) in zip(pts[:-1], pts[1:]):
        n = max(abs(y1 - y0), abs(x1 - x0), 1)
        for t in range(n + 1):
            y = int(round(y0 + (y1 - y0) * t / n))
            x = int(round(x0 + (x1 - x0) * t / n))
            out[max(0, y - half):y + half + 1,
                max(0, x - half):x + half + 1] = 1
    return out


def sample_polygon(mask: np.ndarray, rng: random.Random,
                   n_vertices: int = 8) -> np.ndarray:
    """The polygon through `n_vertices` in-mask pixels in the order of
    their angle about their mean."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros_like(mask, np.uint8)
    idx = [rng.randrange(len(ys)) for _ in range(n_vertices)]
    pts = np.asarray([(xs[i], ys[i]) for i in idx], np.float64)
    c = pts.mean(0)
    order = np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))
    return rasterize_polygons([pts[order].ravel().tolist()],
                              mask.shape[0], mask.shape[1])


def sample_mask(mask: np.ndarray, rng: random.Random) -> np.ndarray:
    return mask.astype(np.uint8)


GENERATORS: Dict[str, Callable] = {
    "point": sample_point,
    "box": sample_box,
    "circle": sample_circle,
    "scribble": sample_scribble,
    "polygon": sample_polygon,
    "mask": sample_mask,
}


class ShapeSampler:
    """A random prompt shape a region (reference sampler.py:16-40); an
    empty shape from a non-empty mask falls back to the mask."""

    def __init__(self, modes: Optional[List[str]] = None, seed: int = 0):
        self.modes = modes or list(GENERATORS)
        self.rng = random.Random(seed)

    def __call__(self, mask: np.ndarray) -> np.ndarray:
        mode = self.rng.choice(self.modes)
        out = GENERATORS[mode](mask.astype(bool), self.rng)
        if out.sum() == 0 and mask.sum() > 0:
            out = mask.astype(np.uint8)
        return out
