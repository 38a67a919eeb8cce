"""The port's COCO data layer against the JAX package on the CPU, exact:
`rasterize_polygons` pixel for pixel against JAX's (Pillow's
`ImageDraw.polygon`), `decode_segmentation`, `CocoIndex.load_anns`,
`rle_iou`, the train transforms, `CocoDetDataset` (test and train, with
masks), `RefCocoGrdDataset`, `ReasonSegDataset`, `batched_samples`, the
registry and the shipped eval configs. Every array, id and `img_metas`
field must be identical; the word-level `MockTokenizer` instance is
shared, so words get the same ids on both sides.

The synthetic COCO set (`write_coco`) is PNGs written by Pillow from a
numpy seed: JAX reads them through Pillow, the port through its own PNG
reader. Its annotations carry fractional polygons (several for one
object), uncompressed and compressed RLE, a crowd object and a box under
1 px, over non-contiguous category ids.
"""

import json
import random

import numpy as np
import pytest
from PIL import Image

from tests.mock_tokenizer import MockTokenizer
from visionllm_tpu.data import build as jbuild
from visionllm_tpu.data import coco as jcoco
from visionllm_tpu.data import transforms as jtr
from visionllm_tpu.data.det_dataset import CocoDetDataset as JaxDetDataset
from visionllm_tpu.data.grd_dataset import ReasonSegDataset as JaxReasonSeg
from visionllm_tpu.data.grd_dataset import RefCocoGrdDataset as JaxRefCoco
from visionllm_tpu.eval import batching as jbatching
from visionllm_tpu.eval import configs as jconfigs
from visionllm_tpu.ops import rle as jrle
from visionllm_tpu_torch.data import build as tbuild
from visionllm_tpu_torch.data import coco as tcoco
from visionllm_tpu_torch.data import transforms as ttr
from visionllm_tpu_torch.data.det_dataset import CocoDetDataset
from visionllm_tpu_torch.data.grd_dataset import (ReasonSegDataset,
                                                  RefCocoGrdDataset)
from visionllm_tpu_torch.eval import batching as tbatching
from visionllm_tpu_torch.eval import configs as tconfigs
from visionllm_tpu_torch.ops import rle as trle

IMAGE_SIZE = 56            # tiny_test_config's CLIP input
IMAGE_TOKENS = 16          # its image feature rows, (56 // 14) ** 2
TEST_SCALE, BUCKETS = (48, 64), ((64, 64),)
TRAIN_SCALES = [(40, 64), (48, 64)]
TRAIN_BUCKETS = ((64, 64), (64, 96), (96, 64), (96, 96))
CATEGORIES = [{"id": 1, "name": "cat"}, {"id": 3, "name": "dog"},
              {"id": 7, "name": "person"}, {"id": 8, "name": "car"}]
SIZES = [(48, 64), (64, 48), (40, 40), (48, 64), (45, 70)]


# ---------------------------------------------------------------------------
# seeded polygons
# ---------------------------------------------------------------------------

def blob(rng, h, w, r_min=3.0):
    """A smooth closed contour sampled every 2-8 px, as an annotator
    clicks one: fractional vertices, convex or concave."""
    R = rng.uniform(r_min, max(r_min + 1, min(h, w) / 2))
    cx, cy = rng.uniform(-0.1 * w, 1.1 * w), rng.uniform(-0.1 * h, 1.1 * h)
    n = max(3, int(2 * np.pi * R / rng.uniform(2, 8)))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 1)
    k = np.arange(1, 4)[:, None]
    amp, ph = rng.uniform(0, 0.3, 3)[:, None], rng.uniform(0, 6.3, 3)[:, None]
    rad = R * (1 + (amp * np.sin(k * ang[None] + ph)).sum(0))
    rad = rad + rng.normal(0, 0.5, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).ravel().tolist()


def star(rng, h, w):
    """A star polygon: vertices at sorted angles and random radii (concave
    and convex corners)."""
    n = int(rng.integers(3, 14))
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(3, max(h, w) / 1.5, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).ravel().tolist()


def sliver(rng, h, w):
    x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
    x1, y1 = rng.uniform(0, w), rng.uniform(0, h)
    return [x0, y0, x1, y1, x1 + rng.uniform(-1.5, 1.5),
            y1 + rng.uniform(-1.5, 1.5)]


def revisiting(rng, h, w):
    """A small polygon whose truncated vertices repeat: spikes that meet
    at one vertex, edges that retrace others."""
    n = int(rng.integers(3, 8))
    cx, cy = rng.uniform(2, w - 2), rng.uniform(2, h - 2)
    return np.stack([cx + rng.uniform(-4, 4, n), cy + rng.uniform(-4, 4, n)],
                    1).ravel().tolist()


def polygons(kind, seed, h, w):
    rng = np.random.default_rng(seed)
    if kind == "revisiting":
        return [revisiting(rng, h, w)]
    if kind == "integer":
        return [np.round(star(rng, h, w)).tolist()]
    if kind == "fractional_star":
        return [star(rng, h, w)]
    if kind == "contour":
        return [blob(rng, h, w)]
    if kind == "sliver":
        return [sliver(rng, h, w)]
    if kind == "off_image":      # centred outside the frame
        p = np.asarray(blob(rng, h, w, r_min=6.0)).reshape(-1, 2)
        return [(p + [w * 0.6, -h * 0.5]).ravel().tolist()]
    return [blob(rng, h, w) for _ in range(int(rng.integers(2, 4)))]


POLY_KINDS = ["integer", "fractional_star", "contour", "sliver", "off_image",
              "multi", "revisiting"]


@pytest.mark.parametrize("kind", POLY_KINDS)
def test_rasterize_polygons_matches_jax_pixel_for_pixel(kind):
    """40 seeded polygons (or polygon lists) of each kind, 280 in all."""
    for seed in range(40):
        rng = np.random.default_rng(1000 + seed)
        h, w = int(rng.integers(12, 120)), int(rng.integers(12, 120))
        polys = polygons(kind, seed, h, w)
        want = jcoco.rasterize_polygons(polys, h, w)
        got = tcoco.rasterize_polygons(polys, h, w)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {seed}")


def test_rasterize_polygons_corner_cases_match_jax():
    """Integer corners whose rows meet at one pixel, horizontal runs,
    spikes meeting at one vertex, an edge retraced, a vertical edge at a
    corner, a degenerate two-point list (skipped) and an empty list."""
    cases = [[[4, 3, 8, 1, 2, 4]], [[2, 2, 12, 4, 6, 11]],
             [[1, 1, 8, 1, 8, 6, 1, 6]], [[10, 5, 16, 8, 58, 26]],
             [[3, 5, 4, 4, 6, 3, 9, 3, 12, 3, 12, 9]], [[2.0, 3.0, 5.0, 6.0]],
             [], [[-2, 5, -1, 4, 1, 3]], [[9, 7, 8, 8, -1, 14]],
             [[20, 7, 21, 8, 20, 7, 18, 8]], [[5, 5, 4, 2, 5, 5, 11, 1]],
             [[2, 4, 2, 1, 7, 3, 2, 1]], [[6, 0, 10, 2, 10, 2]],
             [[110, 20, 53, 1, 74, 4]], [[4, 3, 3, 4, 6, 2, 4, 3, 7, 4]]]
    for polys in cases:
        np.testing.assert_array_equal(
            tcoco.rasterize_polygons(polys, 30, 64),
            jcoco.rasterize_polygons(polys, 30, 64), err_msg=str(polys))


# ---------------------------------------------------------------------------
# the synthetic COCO set
# ---------------------------------------------------------------------------

def _rle_counts(mask):
    col = mask.T.reshape(-1)
    change = np.nonzero(np.diff(col))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [col.size]])).tolist()
    return [0] + runs if col[0] == 1 else runs


def write_coco(root, seed=0, sizes=SIZES):
    """PNG images and a COCO instances file under `root`; returns the
    annotation file's path. Each image holds 3-5 objects: polygon lists,
    an uncompressed-RLE and a compressed-RLE mask, one crowd object (RLE)
    on image 0 and a box under 1 px on image 1."""
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"img{i}.png"
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / name)
        images.append({"id": 10 + i, "file_name": name, "height": h,
                       "width": w})
        for j in range(int(rng.integers(3, 6))):
            kind = j % 3
            if kind == 0:
                seg = [blob(rng, h, w, r_min=4.0)
                       for _ in range(int(rng.integers(1, 3)))]
                mask = jcoco.rasterize_polygons(seg, h, w)
            else:
                mask = np.zeros((h, w), np.uint8)
                y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
                mask[y0:y0 + int(rng.integers(4, 20)),
                     x0:x0 + int(rng.integers(4, 20))] = 1
                seg = ({"size": [h, w], "counts": _rle_counts(mask)}
                       if kind == 1 else jrle.rle_encode(mask))
            ys, xs = np.nonzero(mask)
            if len(ys) == 0:
                continue
            x, y = float(xs.min()), float(ys.min())
            bbox = [x, y, float(xs.max()) + 1 - x, float(ys.max()) + 1 - y]
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": CATEGORIES[int(rng.integers(0, 4))]
                         ["id"], "bbox": bbox, "area": float(mask.sum()),
                         "iscrowd": 0, "segmentation": seg})
    anns[0]["iscrowd"] = 1
    anns[0]["segmentation"] = jrle.rle_encode(
        jcoco.decode_segmentation(anns[0]["segmentation"], sizes[0][0],
                                  sizes[0][1]))
    tiny = next(a for a in anns if a["image_id"] == 11)
    tiny["bbox"] = [3.0, 4.0, 0.6, 5.0]
    # a crowd-only image (dropped by train mode's filter_empty)
    h, w = sizes[-1]
    anns = [a for a in anns if a["image_id"] != 10 + len(sizes) - 1]
    anns.append({"id": len(anns) + 1, "image_id": 10 + len(sizes) - 1,
                 "category_id": 3, "bbox": [2.0, 2.0, 9.0, 9.0],
                 "area": 81.0, "iscrowd": 1,
                 "segmentation": jrle.rle_encode(
                     np.pad(np.ones((9, 9), np.uint8),
                            ((2, h - 11), (2, w - 11))))})
    path = root / "instances.json"
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": CATEGORIES[::-1]}, f)
    return str(path)


def write_refcoco(root, ann_file, seed=1):
    """A RefCOCO-style file over the same images: each non-crowd object
    with a box over 1 px carries 1-2 expressions; every other one an
    explanation ("answer") for ReasonSeg."""
    with open(ann_file) as f:
        raw = json.load(f)
    rng = np.random.default_rng(seed)
    words = ["left", "right", "big", "small", "red", "striped", "front"]
    anns = []
    for a in raw["annotations"]:
        if a["iscrowd"] or min(a["bbox"][2:]) <= 1:
            continue
        exprs = [" ".join(rng.choice(words, 3).tolist())
                 for _ in range(int(rng.integers(1, 3)))]
        ann = {**a, "expressions": exprs}
        if a["id"] % 2:
            ann["answer"] = "because it is " + str(rng.choice(words))
        anns.append(ann)
    path = root / "refcoco.json"
    with open(path, "w") as f:
        json.dump({"images": raw["images"], "annotations": anns}, f)
    return str(path)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_port")
    ann = write_coco(root)
    ref = write_refcoco(root, ann)
    return root, ann, ref


def assert_same(got, want, where="sample"):
    """Recursive equality of dataset outputs: arrays identical (dtype
    included), dicts key for key, tuples and scalars equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# annotations, segmentations, RLE IoU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_empty", [False, True])
def test_coco_index_load_anns_matches_jax(coco_dir, filter_empty):
    _, ann, _ = coco_dir
    want = jcoco.CocoIndex(ann, filter_empty=filter_empty)
    got = tcoco.CocoIndex(ann, filter_empty=filter_empty)
    assert got.img_ids == want.img_ids
    assert got.class_names == want.class_names
    assert got.cat2label == want.cat2label
    for i in range(len(want)):
        for with_mask in (False, True):
            assert_same(got.load_anns(i, with_mask=with_mask),
                        want.load_anns(i, with_mask=with_mask), f"image {i}")


def test_decode_segmentation_matches_jax(coco_dir):
    _, ann, _ = coco_dir
    with open(ann) as f:
        raw = json.load(f)
    sizes = {im["id"]: (im["height"], im["width"]) for im in raw["images"]}
    kinds = set()
    for a in raw["annotations"]:
        seg = a["segmentation"]
        kinds.add("polygon" if isinstance(seg, list) else
                  "rle" if isinstance(seg["counts"], list) else "compressed")
        h, w = sizes[a["image_id"]]
        assert_same(tcoco.decode_segmentation(seg, h, w),
                    jcoco.decode_segmentation(seg, h, w), f"ann {a['id']}")
    assert kinds == {"polygon", "rle", "compressed"}
    assert_same(tcoco.decode_segmentation(None, 5, 7),
                jcoco.decode_segmentation(None, 5, 7))


def test_rle_iou_matches_jax():
    rng = np.random.default_rng(5)
    h, w = 37, 29

    def masks(n):
        out = []
        for _ in range(n):
            m = np.zeros((h, w), np.uint8)
            y0, x0 = rng.integers(0, h - 5), rng.integers(0, w - 5)
            m[y0:y0 + rng.integers(3, 20), x0:x0 + rng.integers(3, 20)] = 1
            out.append(jrle.rle_encode(m))
        return out

    dt, gt = masks(7), masks(5)
    for crowd in (None, [0, 1, 0, 0, 1]):
        want = jrle.rle_iou(dt, gt, crowd)
        got = trle.rle_iou(dt, gt, crowd)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert trle.rle_iou([], gt).shape == (0, 5)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _sample(seed, h=48, w=64, n=4):
    rng = np.random.default_rng(seed)
    boxes = np.sort(rng.uniform(0, min(h, w), (n, 2, 2)), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]]
    return {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "boxes": boxes.astype(np.float32),
            "labels": rng.integers(0, 4, n).astype(np.int32),
            "masks": rng.integers(0, 2, (n, h, w)).astype(np.uint8)}


@pytest.mark.parametrize("seed", range(6))
def test_det_train_transform_matches_jax(seed):
    """Both draw from a `random.Random` of the same seed: the same flip,
    branch, scales and crop, and identical arrays; the generators end in
    the same state."""
    rj, rt = random.Random(seed), random.Random(seed)
    want = jtr.det_train_transform(_sample(seed), rj, TRAIN_SCALES,
                                   TRAIN_BUCKETS)
    got = ttr.det_train_transform(_sample(seed), rt, TRAIN_SCALES,
                                  TRAIN_BUCKETS)
    assert_same(got, want)
    assert rt.getstate() == rj.getstate()


def test_flip_and_crop_match_jax():
    for seed in range(4):
        for fn in ("random_flip", "random_crop"):
            rj, rt = random.Random(seed), random.Random(seed)
            kw = {} if fn == "random_flip" else {"crop_size": (20, 40)}
            assert_same(getattr(ttr, fn)(_sample(seed), rng=rt, **kw),
                        getattr(jtr, fn)(_sample(seed), rng=rj, **kw), fn)


# ---------------------------------------------------------------------------
# datasets, batching, registry
# ---------------------------------------------------------------------------

def _det_kwargs(test_mode, with_mask):
    kw = dict(test_mode=test_mode, with_mask=with_mask,
              image_size=IMAGE_SIZE, test_scale=TEST_SCALE, seed=3,
              max_gt_per_img=6)
    if test_mode:
        kw["buckets"] = BUCKETS
    else:
        kw.update(train_scales=TRAIN_SCALES, buckets=TRAIN_BUCKETS)
    return kw


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["boxes", "masks"])
def test_coco_det_dataset_matches_jax(coco_dir, test_mode, with_mask):
    root, ann, _ = coco_dir
    tok = MockTokenizer()
    kw = _det_kwargs(test_mode, with_mask)
    want = JaxDetDataset(ann, str(root), tok, **kw)
    got = CocoDetDataset(ann, str(root), tok, image_token_len=IMAGE_TOKENS,
                         **kw)
    assert len(got) == len(want) and got.class_names == want.class_names
    for i in range(len(want)):
        assert_same(got[i], want[i], f"item {i}")
    assert got.rng.getstate() == want.rng.getstate()


@pytest.mark.parametrize("cls", ["refcoco", "reasonseg"])
@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
def test_grounding_datasets_match_jax(coco_dir, cls, test_mode):
    root, _, ref = coco_dir
    tok = MockTokenizer()
    jcls, tcls = ((JaxRefCoco, RefCocoGrdDataset) if cls == "refcoco"
                  else (JaxReasonSeg, ReasonSegDataset))
    kw = dict(test_mode=test_mode, image_size=IMAGE_SIZE,
              test_scale=TEST_SCALE, buckets=BUCKETS if test_mode else
              TRAIN_BUCKETS, seed=4)
    if cls == "refcoco":
        kw["with_mask"] = True
    want = jcls(ref, str(root), tok, **kw)
    got = tcls(ref, str(root), tok, image_token_len=IMAGE_TOKENS, **kw)
    assert len(got) == len(want) > 6
    for i in range(len(want)):
        assert_same(got[i], want[i], f"item {i}")


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_batched_samples_matches_jax(coco_dir, batch_size):
    """Test mode at the 800 px scale's buckets: images of several shapes
    share batches by bucket, tails padded by the last sample."""
    root, ann, _ = coco_dir
    tok = MockTokenizer()
    kw = dict(test_mode=True, image_size=IMAGE_SIZE, test_scale=(48, 64),
              buckets=((48, 64), (64, 48), (64, 64), (64, 96)))
    jds = JaxDetDataset(ann, str(root), tok, **kw)
    tds = CocoDetDataset(ann, str(root), tok, image_token_len=IMAGE_TOKENS,
                         **kw)
    keys = ("input_ids", "image", "image_aug", "pixel_mask")
    want = list(jbatching.batched_samples(jds, len(jds), batch_size, keys))
    got = list(tbatching.batched_samples(tds, len(tds), batch_size, keys))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        assert_same(g[2], w[2], "arrays")
        for gs, ws in zip(g[1], w[1]):
            assert_same(gs, ws, "sample")


def test_registry_builds_the_shipped_configs_types(coco_dir):
    root, ann, ref = coco_dir
    tok = MockTokenizer()
    cfgs = [{"type": "coco_det", "ann_file": ann, "img_prefix": str(root),
             "test_mode": True, "with_mask": True, "ratio": 0.5},
            {"type": "refcoco_grd", "ann_file": ref,
             "img_prefix": str(root), "test_mode": True}]
    common = dict(image_size=IMAGE_SIZE, test_scale=TEST_SCALE,
                  buckets=BUCKETS)
    want = jbuild.build_multi_datasets(cfgs, tok, **common)
    got = tbuild.build_multi_datasets(cfgs, tok, image_token_len=IMAGE_TOKENS,
                                      **common)
    assert got.cum == want.cum
    assert [got.task_of(i) for i in range(len(got))] == \
        [want.task_of(i) for i in range(len(want))]
    for i in range(len(want)):
        assert_same(got[i], want[i], f"item {i}")
    with pytest.raises(KeyError, match="odinw_det"):
        tbuild.build_dataset({"type": "odinw_det"}, tok)


def test_load_eval_config_matches_jax():
    assert tconfigs.list_shipped_configs() == jconfigs.list_shipped_configs()
    for key in jconfigs.list_shipped_configs():
        assert tconfigs.load_eval_config(key) == \
            jconfigs.load_eval_config(key), key
    with pytest.raises(FileNotFoundError):
        tconfigs.load_eval_config("det/none")
