"""The port's remaining dataset types against the JAX package on the CPU:
the det variants, semseg, the visual-prompt `ShapeSampler`, the
interactive, region, region-variant and in-context (mmic) datasets, the
raw label read, the registry and the shipped eval configs.

Every array, id and `img_metas` field must equal JAX's (`assert_same`:
arrays identical, dtype included); the word-level `MockTokenizer`
instance is shared, so words get the same ids on both sides. The images
are PNGs written by Pillow from numpy seeds (`write_coco` and the
fixtures below): JAX reads them through Pillow, the port through its own
reader. At the tiny config (56 px, no pixel shuffle) both packages put
16 <im_patch> ids an image in a prompt.
"""

import json
import random

import numpy as np
import pytest
from PIL import Image, ImageDraw

import visionllm_tpu.data  # noqa: F401  (registers the JAX types)
import visionllm_tpu_torch.data  # noqa: F401  (registers the port's)
from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_coco_data import (BUCKETS, IMAGE_SIZE, IMAGE_TOKENS,
                                        TEST_SCALE, TRAIN_BUCKETS,
                                        TRAIN_SCALES, assert_same,
                                        write_coco)
from visionllm_tpu.data import build as jbuild
from visionllm_tpu.data import collator as jcollator
from visionllm_tpu.data import visual_sampler as jvs
from visionllm_tpu_torch.data import build as tbuild
from visionllm_tpu_torch.data import collator as tcollator
from visionllm_tpu_torch.data import visual_sampler as tvs
from visionllm_tpu_torch.data.image_io import load_label
from visionllm_tpu_torch.data.loader import PrefetchLoader
from visionllm_tpu_torch.eval import configs as tconfigs

ADE_CLASSES = ["wall", "building", "sky", "floor", "tree", "ceiling",
               "road", "bed"]


def _seg_label(rng, h, w, k):
    """A label map of blocks of class ids below `k`, 255 (ignore) in
    places."""
    label = np.full((h, w), 255, np.uint8)
    for _ in range(6):
        y0, x0 = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 6))
        label[y0:y0 + int(rng.integers(4, h // 2)),
              x0:x0 + int(rng.integers(4, w // 2))] = rng.integers(0, k)
    return label


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """`write_coco`'s set plus the semseg labels (gray and palette PNGs),
    region, VCR, recognition, Osprey and mmic rows over its images."""
    root = tmp_path_factory.mktemp("data_variants")
    ann = write_coco(root, seed=11)
    rng = np.random.default_rng(12)
    with open(ann) as f:
        images = json.load(f)["images"]
    names = [im["file_name"] for im in images]
    files = {"instances": ann, "crowd": str(root / "crowd.json")}
    with open(ann) as f:
        raw = json.load(f)
    for a in raw["annotations"]:     # CrowdHuman's one category
        a["category_id"] = 1
    raw["categories"] = [{"id": 1, "name": "person"}]
    with open(files["crowd"], "w") as f:
        json.dump(raw, f)
    seg_rows = []
    for i, im in enumerate(images[:4]):
        label = _seg_label(rng, im["height"], im["width"],
                           len(ADE_CLASSES) + 2)
        pil = Image.fromarray(label)
        if i % 2:   # a palette PNG: its indices are the labels
            pil = pil.convert("P")
            pil.putpalette(rng.integers(0, 256, 768).astype(np.uint8)
                           .tolist())
        pil.save(root / f"label{i}.png")
        seg_rows.append({"image": names[i], "label": f"label{i}.png"})

    def box(im):
        h, w = im["height"], im["width"]
        x, y = float(rng.integers(0, w - 12)), float(rng.integers(0, h - 12))
        return [x, y, float(rng.integers(4, 12)), float(rng.integers(4, 12))]

    region = [{"image": im["file_name"], "bbox": box(im),
               "caption": f"a thing number {k}"}
              for k, im in enumerate(images)]
    region[1]["segmentation"] = [[3.5, 4.0, 30.2, 6.0, 20.0, 28.7]]
    region[2] = {"image": images[2]["file_name"], "bbox": box(images[2]),
                 "category": "dog"}
    vcr = [{"image": im["file_name"],
            "boxes": [[4, 5, 25, 20], [30, 10, 39, 28], [1, 2, 12, 9]][:2 + k % 2],
            "objects": ["person", "bottle", "chair"],
            "conversations": [
                {"from": "human", "value": f"Why is [0] near [1]? ({k})"},
                {"from": "gpt", "value": "[0] is THIRSTY for [1]."},
                {"from": "human", "value": "And [2]?"},
                {"from": "gpt", "value": "[2] IS empty."}]}
           for k, im in enumerate(images[:3])]
    rec = [{"image": im["file_name"],
            "regions": [{"bbox": box(im), "category": "cat"},
                        {"bbox": box(im), "category": "traffic light",
                         "segmentation": [[2.0, 2.0, 20.0, 3.0, 10.0, 18.0]]},
                        {"bbox": box(im), "category": "dog"}][:1 + k]}
           for k, im in enumerate(images[:3])]
    osprey = [{"image": im["file_name"],
               "regions": [{"bbox": box(im)}, {"bbox": box(im)}],
               "conversations": [
                   {"from": "human",
                    "value": "Describe <region1> and <region-2> please."},
                   {"from": "gpt", "value": "A small cat."},
                   {"from": "human", "value": "What of <region2>?"},
                   {"from": "gpt", "value": "A dog."}]}
              for im in images[:3]]
    ic_text = [{"images": names[k:k + 2 + k % 2],
                "conversations": [
                    {"from": "human", "value": "<image>\n" * (2 + k % 2)
                     + "Which is bigger?"},
                    {"from": "gpt", "value": "The second one."}]}
               for k in range(3)]
    ic_mask = [{"support_image": names[k], "support_bbox": box(images[k]),
                "query_image": names[k + 1],
                "query_boxes": [box(images[k + 1])
                                for _ in range(1 + k)]}
               for k in range(3)]
    ic_mask[1]["support_segmentation"] = [[2.0, 2.0, 20.0, 3.0, 10.0, 18.0]]
    for key, rows, ext in (("semseg", seg_rows, ".json"),
                           ("region", region, ".json"),
                           ("vcr", vcr, ".jsonl"), ("rec", rec, ".json"),
                           ("osprey", osprey, ".json"),
                           ("ic_text", ic_text, ".json"),
                           ("ic_mask", ic_mask, ".json")):
        path = root / (key + ext)
        with open(path, "w") as f:
            if ext == ".jsonl":
                f.write("".join(json.dumps(r) + "\n" for r in rows))
            else:
                json.dump(rows, f)
        files[key] = str(path)
    return root, files


def _pair(type_name, ann, root, **kw):
    """The JAX and the port dataset of one registered type, one shared
    tokenizer."""
    tok = MockTokenizer()
    cfg = {"type": type_name, "ann_file": ann, **kw}
    if type_name.startswith("mmic"):
        cfg["image_folder"] = str(root)
    else:
        cfg["img_prefix"] = str(root)
    want = jbuild.build_dataset(cfg, tok)
    got = tbuild.build_dataset(cfg, tok, image_token_len=IMAGE_TOKENS)
    return got, want


def _all_same(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        assert_same(got[i], want[i], f"item {i}")
    if hasattr(want, "rng"):
        assert got.rng.getstate() == want.rng.getstate()


# ---------------------------------------------------------------------------
# the det variants
# ---------------------------------------------------------------------------

DET_VARIANTS = ["det_generic", "odinw_det", "crowdhuman_det", "cod_det",
                "sod_det"]


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
@pytest.mark.parametrize("type_name", DET_VARIANTS)
def test_det_variants_match_jax(data_dir, type_name, test_mode):
    root, files = data_dir
    kw = dict(test_mode=test_mode, image_size=IMAGE_SIZE, seed=5,
              test_scale=TEST_SCALE, max_gt_per_img=6)
    if type_name == "det_generic":
        kw["dataset_name"] = "objects365"
    if type_name in ("cod_det", "sod_det", "odinw_det"):
        kw["with_mask"] = True
    if test_mode:
        kw["buckets"] = BUCKETS
    else:
        kw.update(train_scales=TRAIN_SCALES, buckets=TRAIN_BUCKETS)
    ann = files["crowd" if type_name == "crowdhuman_det" else "instances"]
    got, want = _pair(type_name, ann, root, **kw)
    assert got.class_names == want.class_names
    assert got.dataset_name == want.dataset_name
    _all_same(got, want)


# ---------------------------------------------------------------------------
# semseg and its label read
# ---------------------------------------------------------------------------

def test_load_label_matches_pillow(data_dir, tmp_path):
    """Gray and palette PNGs give what `np.asarray(Image.open(...))` gives
    (the gray value, the palette index); RGB and gray+alpha PNGs their
    samples; a 16-bit PNG raises."""
    root, files = data_dir
    for i in range(4):
        path = root / f"label{i}.png"
        want = np.asarray(Image.open(path))
        assert Image.open(path).mode == ("P" if i % 2 else "L")
        got = load_label(str(path))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    for mode, shape in (("RGB", (9, 7, 3)), ("LA", (9, 7, 2)),
                        ("RGBA", (9, 7, 4))):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                        mode).save(tmp_path / f"{mode}.png")
        np.testing.assert_array_equal(
            load_label(str(tmp_path / f"{mode}.png")),
            np.asarray(Image.open(tmp_path / f"{mode}.png")))
    Image.fromarray(rng.integers(0, 60000, (5, 6)).astype(np.uint16)).save(
        tmp_path / "deep.png")
    with pytest.raises(NotImplementedError):
        load_label(str(tmp_path / "deep.png"))


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
def test_semseg_dataset_matches_jax(data_dir, test_mode):
    root, files = data_dir
    kw = dict(class_names=ADE_CLASSES, test_mode=test_mode,
              image_size=IMAGE_SIZE, max_classes_per_sample=5, seed=2,
              test_scale=TEST_SCALE)
    if test_mode:
        kw["buckets"] = BUCKETS
    else:
        kw.update(train_scales=TRAIN_SCALES, buckets=TRAIN_BUCKETS)
    got, want = _pair("semseg", files["semseg"], root, **kw)
    refused = 0
    for i in range(len(want)):
        g = got[i]
        try:
            w = want[i]
        except (IndexError, ValueError):
            # JAX indexes the targets by position and fails when the crop
            # drops a class (ROADMAP.md §C.2); the port keeps the other
            # classes in their slots
            refused += 1
            t = g["targets"]
            kept = np.nonzero(t["valid"])[0]
            assert len(kept) < len(g["img_metas"]["class_ids"])
            assert all(t["masks"][k].any() for k in kept)
            continue
        assert_same(g, w, f"item {i}")
    assert got.rng.getstate() == want.rng.getstate()
    assert refused < len(want)
    seg = MockTokenizer().convert_tokens_to_ids("[SEG]")
    assert int((got[0]["input_ids"] == seg).sum()) == 5


def test_semseg_without_class_names_raises_value_error(data_dir):
    """The shipped ade20k config gives no class_names: JAX's class fails
    with a TypeError (ROADMAP.md §C.2), the port's with a ValueError that
    names them (§C.3)."""
    root, files = data_dir
    cfg = {"type": "semseg", "ann_file": files["semseg"],
           "img_prefix": str(root), "test_mode": True}
    with pytest.raises(TypeError, match="class_names"):
        jbuild.build_dataset(cfg, MockTokenizer())
    with pytest.raises(ValueError, match="class_names"):
        tbuild.build_dataset(cfg, MockTokenizer(),
                             image_token_len=IMAGE_TOKENS)


# ---------------------------------------------------------------------------
# the shape sampler
# ---------------------------------------------------------------------------

def _sampler_masks(seed):
    """A seeded object mask: a blob, a thin bar, one pixel or nothing."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 70)), int(rng.integers(20, 70))
    mask = np.zeros((h, w), np.uint8)
    kind = seed % 4
    if kind == 0:
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        yy, xx = np.mgrid[:h, :w]
        mask[(yy - cy) ** 2 / rng.uniform(9, 400)
             + (xx - cx) ** 2 / rng.uniform(9, 400) <= 1] = 1
    elif kind == 1:
        y = int(rng.integers(0, h))
        mask[y:y + int(rng.integers(1, 3)), int(rng.integers(0, w // 2)):] = 1
    elif kind == 2:
        mask[int(rng.integers(0, h)), int(rng.integers(0, w))] = 1
    return mask


@pytest.mark.parametrize("name", sorted(jvs.GENERATORS))
def test_shape_generators_match_jax_pixel_for_pixel(name):
    """Each generator over 60 seeded masks, from generators in the same
    state: the same prompt mask pixel for pixel and the same draws
    (the polygon through `rasterize_polygons`, against Pillow)."""
    for seed in range(60):
        mask = _sampler_masks(seed)
        rj, rt = random.Random(seed), random.Random(seed)
        want = jvs.GENERATORS[name](mask.astype(bool), rj)
        got = tvs.GENERATORS[name](mask.astype(bool), rt)
        assert got.dtype == want.dtype, (name, seed)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {seed}")
        assert rt.getstate() == rj.getstate(), (name, seed)


def test_polygon_fill_matches_pillow_at_outline_one():
    """`sample_polygon`'s fill against `ImageDraw.polygon(..., outline=1,
    fill=1)` itself on its vertices, over 200 seeded vertex sets."""
    for seed in range(200):
        mask = _sampler_masks(4 * seed)
        if not mask.any():
            continue
        got = tvs.sample_polygon(mask.astype(bool), random.Random(seed))
        ys, xs = np.nonzero(mask)
        r = random.Random(seed)
        pts = np.asarray([(xs[i], ys[i]) for i in
                          [r.randrange(len(ys)) for _ in range(8)]],
                         np.float64)
        c = pts.mean(0)
        order = np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))
        img = Image.new("L", (mask.shape[1], mask.shape[0]), 0)
        ImageDraw.Draw(img).polygon([tuple(pts[i]) for i in order],
                                    outline=1, fill=1)
        np.testing.assert_array_equal(got, np.asarray(img), err_msg=seed)


def test_shape_sampler_matches_jax():
    """`ShapeSampler` over 200 masks in a row from one seed: the same
    modes, shapes and fallbacks."""
    for modes in (None, ["polygon", "scribble"]):
        js, ts = jvs.ShapeSampler(modes, seed=7), tvs.ShapeSampler(modes,
                                                                   seed=7)
        for seed in range(200):
            mask = _sampler_masks(seed)
            np.testing.assert_array_equal(ts(mask), js(mask), err_msg=seed)
        assert ts.rng.getstate() == js.rng.getstate()


# ---------------------------------------------------------------------------
# interactive, region and region variants, mmic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
def test_interactive_dataset_matches_jax(data_dir, test_mode):
    root, files = data_dir
    kw = dict(test_mode=test_mode, image_size=IMAGE_SIZE, max_regions=4,
              seed=9, test_scale=TEST_SCALE, buckets=BUCKETS)
    got, want = _pair("coco_interactive", files["instances"], root, **kw)
    _all_same(got, want)
    assert got.sampler.rng.getstate() == want.sampler.rng.getstate()
    reg = MockTokenizer().convert_tokens_to_ids("<region>")
    s = got[0]
    assert int((s["input_ids"] == reg).sum()) == s["num_regions"] > 0


@pytest.mark.parametrize("mode", ["caption", "recognition"])
@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
def test_region_caption_dataset_matches_jax(data_dir, mode, test_mode):
    root, files = data_dir
    got, want = _pair("region_caption", files["region"], root, mode=mode,
                      test_mode=test_mode, image_size=IMAGE_SIZE, seed=4)
    _all_same(got, want)


REGION_VARIANTS = {
    "vg_region": "region", "refcoco_region": "region", "vcr": "vcr",
    "vcr_vqa": "vcr", "osprey": "osprey", "osprey_conversations": "osprey",
    "osprey_detailed": "osprey", "osprey_short": "osprey",
    "osprey_part": "osprey", "osprey_lvis_posneg": "osprey",
    "v3det_region": "rec", "lvis_region": "rec",
    "coco_region_recognition": "rec"}


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
@pytest.mark.parametrize("type_name", sorted(REGION_VARIANTS))
def test_region_variants_match_jax(data_dir, type_name, test_mode):
    root, files = data_dir
    got, want = _pair(type_name, files[REGION_VARIANTS[type_name]], root,
                      test_mode=test_mode, image_size=IMAGE_SIZE, seed=6,
                      max_regions=2)
    assert got.task == want.task and got.dataset_name == want.dataset_name
    _all_same(got, want)


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
def test_mmic_datasets_match_jax(data_dir, test_mode):
    root, files = data_dir
    got, want = _pair("mmic_text", files["ic_text"], root, max_images=3,
                      image_size=IMAGE_SIZE)
    _all_same(got, want)
    imp = MockTokenizer().convert_tokens_to_ids("<im_patch>")
    s = got[2]
    assert int((s["input_ids"] == imp).sum()) == \
        s["num_images"] * IMAGE_TOKENS
    kw = dict(test_mode=test_mode, image_size=IMAGE_SIZE, seed=8,
              max_gt_per_img=3)
    if not test_mode:
        kw.update(train_scales=TRAIN_SCALES, buckets=TRAIN_BUCKETS)
    got, want = _pair("mmic_mask", files["ic_mask"], root, **kw)
    _all_same(got, want)


def test_region_masks_reach_no_train_step(data_dir):
    """JAX's collator stacks no `regions` (nor `num_regions`), so the
    masks of region, interactive and mmic_mask samples never reach a JAX
    train step (ROADMAP.md §C.2); the port's collator does the same."""
    root, files = data_dir
    for type_name, key, extra in (
            ("coco_interactive", "instances", dict(max_regions=4)),
            ("vg_region", "region", {}), ("mmic_mask", "ic_mask", {})):
        got, want = _pair(type_name, files[key], root,
                          image_size=IMAGE_SIZE, test_mode=True, **extra)
        samples_j, samples_t = [want[0], want[1]], [got[0], got[1]]
        if type_name == "mmic_mask":     # one query bucket a batch
            samples_j, samples_t = samples_j[:1], samples_t[:1]
        bj = jcollator.collate(samples_j)
        bt = tcollator.collate(samples_t)
        assert "regions" in samples_t[0] and "regions" not in bj
        assert set(bt) == set(bj), (type_name, set(bt) ^ set(bj))


# ---------------------------------------------------------------------------
# the loader's seeded samples, the registry, the shipped configs
# ---------------------------------------------------------------------------

def _interactive_batches(files, root, workers, tok):
    ds = tbuild.build_dataset(
        {"type": "coco_interactive", "ann_file": files["instances"],
         "img_prefix": str(root), "test_mode": False, "max_regions": 4},
        tok, image_token_len=IMAGE_TOKENS,
        image_size=IMAGE_SIZE)
    concat = tbuild.ConcatDataset([ds])
    batches = [[0, 1], [2, 3], [1, 0], [3, 2]]

    class Seeded:
        def __getitem__(self, i):
            return tbuild.seeded_sample(concat, i, f"7:{i}")

    return list(PrefetchLoader(Seeded(), batches, list,
                               num_workers=workers))


def test_interactive_batches_equal_across_four_worker_runs(data_dir):
    """`seeded_sample` reseeds the sampler's generator too, so two loader
    runs at 4 workers give equal batches, prompt shapes included, and
    the same index gives the same sample in any batch."""
    root, files = data_dir
    # the word-level tokenizer numbers words in the order the loader's
    # threads meet them: one synchronous pass fixes every id first
    tok = MockTokenizer()
    _interactive_batches(files, root, 0, tok)
    runs = [_interactive_batches(files, root, 4, tok) for _ in range(2)]
    assert len(runs[0]) == len(runs[1]) == 4
    for a, b in zip(*runs):
        assert_same(a, b)
    assert_same(runs[0][0][0], runs[0][2][1])


def test_simple_tokenizer_threads_get_distinct_ids():
    """8 threads tokenizing disjoint words give every word its own id (the
    port's `SimpleTokenizer` locks its counter), and one thread's ids are
    the JAX tokenizer's."""
    import sys
    import threading

    from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

    text = "a photo of two cats , and a dog ."
    assert SimpleTokenizer()(text).input_ids == MockTokenizer()(text).input_ids
    tok = SimpleTokenizer()
    words = [[f"w{t}x{i}" for i in range(400)] for t in range(8)]
    got = [None] * 8

    def work(t):
        got[t] = [tok.tokenize_str(w)[0] for w in words[t]]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    ids = [i for g in got for i in g]
    assert len(ids) == 3200 and len(set(ids)) == 3200


def test_registries_match():
    assert set(tbuild.DATASET_REGISTRY) == set(jbuild.DATASET_REGISTRY)


def _fixture_cfg(cfg, files, root):
    """A shipped config's dataset pointed at the fixture files."""
    cfg = dict(cfg, img_prefix=str(root), image_size=IMAGE_SIZE,
               test_scale=TEST_SCALE, buckets=BUCKETS)
    cfg["ann_file"] = files[{
        "semseg": "semseg", "crowdhuman_det": "crowd",
        "refcoco_grd": "pose17", "reasonseg": "pose17",
        "coco_pose": "pose17", "crowdpose": "pose14"}.get(cfg["type"],
                                                           "instances")]
    if cfg["type"] == "semseg":
        cfg["class_names"] = ADE_CLASSES
    return cfg


@pytest.mark.parametrize("key", tconfigs.list_shipped_configs())
def test_shipped_config_builds(data_dir, key, tmp_path):
    """Every shipped eval config builds through `load_eval_config` and
    `build_dataset` on the fixture files (the semseg one given
    `class_names`), and its first sample equals JAX's."""
    root, files = data_dir
    files = dict(files)
    for k in (17, 14):    # keypoints of COCO and of CrowdPose
        with open(files["instances"]) as f:
            raw = json.load(f)
        for a in raw["annotations"]:
            a["keypoints"] = [10, 12, 2] * k
            a["num_keypoints"] = k
            a["expressions"] = ["the left one"]
            a["answer"] = "because it is there"
        files[f"pose{k}"] = str(tmp_path / f"pose{k}.json")
        with open(files[f"pose{k}"], "w") as f:
            json.dump(raw, f)
    cfgs = tconfigs.load_eval_config(key)
    assert cfgs
    for cfg in cfgs[:2]:
        cfg = _fixture_cfg(cfg, files, root)
        tok = MockTokenizer()
        got = tbuild.build_dataset(cfg, tok, image_token_len=IMAGE_TOKENS)
        want = jbuild.build_dataset(cfg, tok)
        assert len(got) == len(want) > 0
        assert_same(got[0], want[0], key)
