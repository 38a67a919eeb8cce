"""Write the synthetic JPEG fixtures of this folder and `manifest.json`.

    python tests/data/jpeg/make_fixtures.py

Needs Pillow (on libjpeg). Each image is drawn from a numpy seed: a
colour gradient, filled rectangles, ellipses and triangles (the objects,
whose boxes and polygons the manifest records, so an annotation file can
be written over the fixtures), and a little noise. The manifest holds
each file's encoder options, its shape, the sha256 of Pillow's
`np.asarray(Image.open(p).convert("RGB"))` bytes (the pixels the port's
decoder must give on a host without Pillow), and Pillow's and libjpeg's
versions. Not a test module: pytest does not collect it.
"""

import hashlib
import json
import math
import os

import numpy as np
from PIL import Image, ImageDraw, features

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> ((height, width), gray, encoder options): COCO's common sizes
FIXTURES = {
    "coco_420_q75.jpg": ((480, 640), False, {"quality": 75}),
    "coco_444_q95.jpg": ((640, 480), False,
                         {"quality": 95, "subsampling": 0}),
    "coco_422_q85.jpg": ((427, 640), False,
                         {"quality": 85, "subsampling": 1}),
    "progressive_opt.jpg": ((375, 500), False,
                            {"quality": 80, "progressive": True,
                             "optimize": True}),
    "restart_odd.jpg": ((367, 481), False,
                        {"quality": 75, "restart_marker_blocks": 5}),
    "progressive_restart_422.jpg": ((500, 375), False,
                                    {"quality": 70, "subsampling": 1,
                                     "progressive": True,
                                     "restart_marker_rows": 2}),
    "gray_q90.jpg": ((640, 427), True, {"quality": 90}),
}


def draw(seed: int, hw, gray: bool):
    """The seeded image and its objects (category, bbox xywh, polygon)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1 = rng.uniform(0, 255, (2, 3))
    t = (x / w + y / h) / 2
    base = c0 * (1 - t[..., None]) + c1 * t[..., None]
    img = Image.fromarray(base.astype(np.uint8))
    d = ImageDraw.Draw(img)
    objects = []
    for i in range(int(rng.integers(3, 7))):
        kind = ("rect", "ellipse", "triangle")[i % 3]
        bw, bh = rng.uniform(0.12, 0.35) * w, rng.uniform(0.12, 0.35) * h
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        if kind == "rect":
            poly = [(x0, y0), (x0 + bw, y0), (x0 + bw, y0 + bh),
                    (x0, y0 + bh)]
        elif kind == "ellipse":
            poly = [(x0 + bw / 2 * (1 + math.cos(a)),
                     y0 + bh / 2 * (1 + math.sin(a)))
                    for a in np.linspace(0, 2 * math.pi, 16, endpoint=False)]
        else:
            poly = [(x0 + bw / 2, y0), (x0 + bw, y0 + bh), (x0, y0 + bh)]
        d.polygon(poly, fill=fill)
        objects.append({
            "category": kind,
            "bbox": [round(x0, 2), round(y0, 2), round(bw, 2), round(bh, 2)],
            "polygon": [round(v, 2) for p in poly for v in p]})
    arr = np.asarray(img).astype(np.float32)
    arr += rng.normal(0, 3, arr.shape)
    out = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    return (out.convert("L") if gray else out), objects


def pixel_sha256(path: str) -> str:
    with Image.open(path) as im:
        return hashlib.sha256(
            np.ascontiguousarray(np.asarray(im.convert("RGB"))).tobytes()
        ).hexdigest()


def main():
    manifest = {"pillow": Image.__version__,
                "libjpeg": features.version("jpg"),
                "libjpeg_turbo": bool(features.check_feature(
                    "libjpeg_turbo")),
                "files": {}}
    for seed, (name, (hw, gray, opts)) in enumerate(sorted(FIXTURES.items())):
        img, objects = draw(seed, hw, gray)
        path = os.path.join(HERE, name)
        img.save(path, "JPEG", **opts)
        manifest["files"][name] = {
            "options": opts, "gray": gray, "shape": [hw[0], hw[1], 3],
            "bytes": os.path.getsize(path), "sha256": pixel_sha256(path),
            "objects": objects}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
