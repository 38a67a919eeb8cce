"""The port's pose and gen datasets and its OKS evaluation against the JAX
package on the CPU.

* `CocoPoseDataset`, `CrowdPoseDataset` and `UniKPTDataset` (test and
  train mode) and `Text2ImgDataset`, `IP2PDataset` and their registered
  aliases on JPEG fixtures (`tests/data/jpeg/`, decoded by the port's
  decoder, by Pillow in JAX) and PNGs written by Pillow: every array, id
  and `img_metas` field identical, with JAX's `rng` set to the
  `random.Random` the port draws each sample from (`seeded_sample`). The
  JAX datasets count `(image_size // 14) ** 2` image tokens (pose) or 576
  ([EDIT]); the port's take the count from the caller, here the same.
* `oks_matrix`, `OksMAPEvaluator` (seeded detections near seeded gts,
  crowd and joint-less gts ignored) and `pck` within 1e-12 of JAX's; the
  gt fed back as detections scores OKS mAP 1.0.
* `evaluate_pose` on the tiny test config (4 body points) with one flax
  tree in both models, at batch sizes 2 and 1: the detections each run
  hands its evaluator (scores and unshuffled keypoints) within 1e-4, the
  metrics within 1e-6.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from unittest import mock

import jax
import jax.numpy as jnp

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_coco_data import assert_same
from tests.test_torch_unipose import random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data import gen_dataset as jgen
from visionllm_tpu.data import pose_dataset as jpose
from visionllm_tpu.eval import eval_pose as jeval
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.data import build as tbuild
from visionllm_tpu_torch.data import pose_dataset as tpose
from visionllm_tpu_torch.eval import eval_pose as teval
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

JPEGS = os.path.join(os.path.dirname(__file__), "data", "jpeg")
JPEG_FILES = ("coco_420_q75.jpg", "gray_q90.jpg", "progressive_opt.jpg")
PNG_SIZES = ((48, 64), (70, 45))
IMAGE_SIZE = 56
TEST_SCALE, BUCKETS = (96, 128), ((128, 128),)
EVAL_TOL = 1e-12
DET_TOL = dict(atol=1e-4, rtol=1e-4)
TINY_KPTS = ["nose", "left eye", "right eye", "left ear"]


def _keypoints(rng, box, K):
    x, y, w, h = box
    v = rng.integers(0, 3, K)
    xy = np.stack([rng.uniform(x, x + w, K), rng.uniform(y, y + h, K)], 1)
    xy[v == 0] = 0.0
    return np.concatenate([np.round(xy, 2), v[:, None]], 1).ravel().tolist(), \
        int((v > 0).sum())


def write_pose_set(root, K, seed=0, categories=None):
    """A COCO-keypoints file over the JPEG fixtures (their drawn objects'
    boxes) and Pillow PNGs (seeded boxes): K keypoints an object placed
    in its box, visibilities 0/1/2 from a seed; one object with no
    visible keypoint (which the datasets drop) and a crowd object."""
    rng = np.random.default_rng(seed)
    manifest = json.load(open(os.path.join(JPEGS, "manifest.json")))
    images, anns = [], []
    files = []
    for name in JPEG_FILES:
        if not os.path.exists(os.path.join(root, name)):
            shutil.copy(os.path.join(JPEGS, name), root)
        entry = manifest["files"][name]
        files.append((name, entry["shape"][:2],
                      [o["bbox"] for o in entry["objects"]]))
    for i, (h, w) in enumerate(PNG_SIZES):
        name = f"pose{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(root, name))
        boxes = [[float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
                  float(rng.uniform(8, w / 2)), float(rng.uniform(8, h / 2))]
                 for _ in range(3)]
        files.append((name, (h, w), boxes))
    for image_id, (name, (h, w), boxes) in enumerate(files):
        images.append({"id": image_id, "file_name": name, "height": h,
                       "width": w})
        for j, box in enumerate(boxes):
            kp, n = _keypoints(rng, box, K)
            if image_id == 1 and j == 0:
                kp, n = [0.0] * (3 * K), 0
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": 1, "bbox": box, "keypoints": kp,
                         "num_keypoints": n, "area": box[2] * box[3],
                         "iscrowd": int(image_id == 2 and j == 1)})
    path = os.path.join(root, f"pose_{K}_{seed}.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": categories or [{"id": 1,
                                                 "name": "person"}]}, f)
    return path


def write_gen_sets(root):
    names = list(JPEG_FILES) + ["pose0.png", "pose1.png"]
    t2i = os.path.join(root, "t2i.jsonl")
    with open(t2i, "w") as f:
        for i, n in enumerate(names):
            f.write(json.dumps({"image": n, "caption": f"a photo {i}"})
                    + "\n")
    ip2p = os.path.join(root, "ip2p.json")
    with open(ip2p, "w") as f:
        json.dump([{"input_image": a, "output_image": b,
                    "instruction": f"make it look like {b}"}
                   for a, b in zip(names, names[1:] + names[:1])], f)
    return t2i, ip2p


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_data"))
    unikpt_cats = [{"id": 1, "name": "animal", "keypoints":
                    [f"Joint_{i} " for i in range(17)]}]
    return {"root": root,
            "coco_pose": write_pose_set(root, 17),
            "crowdpose": write_pose_set(root, 14, seed=1),
            "unikpt": write_pose_set(root, 17, seed=2,
                                     categories=unikpt_cats),
            "tiny": write_pose_set(root, 4, seed=3),
            "gen": write_gen_sets(root)}


POSE_CLASSES = {"coco_pose": (jpose.CocoPoseDataset, tpose.CocoPoseDataset),
                "crowdpose": (jpose.CrowdPoseDataset,
                              tpose.CrowdPoseDataset),
                "unikpt": (jpose.UniKPTDataset, tpose.UniKPTDataset)}


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "train"])
@pytest.mark.parametrize("name", list(POSE_CLASSES))
def test_pose_datasets_match_jax(data_dir, name, test_mode):
    jcls, tcls = POSE_CLASSES[name]
    tok = MockTokenizer()
    kw = dict(test_mode=test_mode, image_size=IMAGE_SIZE, max_gt_per_img=4,
              num_body_points=20)
    if test_mode:
        kw.update(test_scale=TEST_SCALE, buckets=BUCKETS)
    ann = data_dir[name]
    want_ds = jcls(ann, data_dir["root"], tok, **kw)
    got_ds = tcls(ann, data_dir["root"], tok,
                  image_token_len=(IMAGE_SIZE // 14) ** 2, **kw)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.kpt_names == want_ds.kpt_names
    for i in range(len(want_ds)):
        seed = f"7:{i}:0"
        want_ds.rng = random.Random(seed)
        want = want_ds[i]
        got = tbuild.seeded_sample(got_ds, i, seed)
        assert_same(got, want, f"{name} item {i}")
        if not test_mode:
            assert got["targets"]["valid"].any()


@pytest.mark.parametrize("name", ["text2img", "cc3m", "laion", "mj",
                                  "journeydb", "ip2p", "seedx"])
def test_gen_datasets_match_jax(data_dir, name):
    t2i, ip2p = data_dir["gen"]
    edit = name in ("ip2p", "seedx")
    tok = MockTokenizer()
    kw = dict(output_size=64, num_embs_gen=8, seed=2)
    want_ds = jgen.__dict__[
        {"text2img": "Text2ImgDataset", "cc3m": "CC3MDataset",
         "laion": "LaionDataset", "mj": "MJDataset",
         "journeydb": "JourneyDBDataset", "ip2p": "IP2PDataset",
         "seedx": "SeedXDataset"}[name]](ip2p if edit else t2i,
                                         data_dir["root"], tok, **kw)
    got_ds = tbuild.build_dataset(
        {"type": name, "ann_file": ip2p if edit else t2i,
         "img_prefix": data_dir["root"], "image_token_len": 576, **kw}, tok)
    assert got_ds.dataset_name == want_ds.dataset_name
    assert got_ds.task == want_ds.task == ("edit" if edit else "t2i")
    for i in range(len(want_ds)):
        want_ds.rng = random.Random(i)
        assert_same(tbuild.seeded_sample(got_ds, i, i), want_ds[i],
                    f"{name} item {i}")


def test_registry_holds_the_pose_and_gen_types():
    for name in ("coco_pose", "crowdpose", "unikpt", "text2img", "ip2p",
                 "cc3m", "laion", "mj", "journeydb", "seedx"):
        assert name in tbuild.DATASET_REGISTRY
        assert tbuild.group_of_task(
            tbuild.DATASET_REGISTRY[name].task) in ("unipose", "sd", "ip2p")


# ---------------------------------------------------------------------------
# OKS and the evaluator
# ---------------------------------------------------------------------------

def _pose_images(n_images=12, K=17, seed=0):
    """(det, gt) pairs: 0-6 gts (about 1 in 6 crowd, a joint-less one),
    detections near them (jittered joints) plus clutter, seeded scores."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n_images):
        ng = int(rng.integers(0, 7)) if i % 5 else 0
        xy = rng.uniform(0, 200, (ng, K, 2))
        v = rng.integers(0, 3, (ng, K)).astype(np.float64)
        if ng and i % 3 == 0:
            v[0] = 0
        gt = {"keypoints": np.concatenate([xy, v[..., None]], -1),
              "areas": rng.uniform(200, 20000, ng),
              "iscrowd": (rng.uniform(size=ng) < 0.17).astype(np.int64)}
        near = xy + rng.normal(0, rng.uniform(1, 15), (ng, K, 2))
        nc = int(rng.integers(0, 6))
        d_xy = np.concatenate([near, rng.uniform(0, 200, (nc, K, 2))])
        det = {"scores": rng.uniform(0.05, 1, ng + nc),
               "keypoints": np.concatenate(
                   [d_xy, np.ones((ng + nc, K, 1))], -1)}
        pairs.append((det, gt))
    return pairs


def test_oks_matrix_matches_jax():
    sig = jeval.pose_sigmas(17)
    for det, gt in _pose_images(seed=1)[:6]:
        args = (det["keypoints"], gt["keypoints"], gt["areas"], sig)
        np.testing.assert_array_equal(teval.oks_matrix(*args),
                                      jeval.oks_matrix(*args))


@pytest.mark.parametrize("K,max_dets", [(17, 20), (14, 5)])
def test_oks_map_evaluator_matches_jax(K, max_dets):
    want = jeval.OksMAPEvaluator(num_keypoints=K, max_dets=max_dets)
    got = teval.OksMAPEvaluator(num_keypoints=K, max_dets=max_dets)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    for det, gt in _pose_images(K=K):
        want.update(det, gt)
        got.update(det, gt)
    w, g = want.summarize(), got.summarize()
    assert set(g) == set(w) == {"AP", "AP_50", "AP_75"}
    for k in w:
        assert abs(g[k] - w[k]) <= EVAL_TOL, (k, g[k], w[k])
    assert 0.05 < w["AP"] < 0.95


def test_ground_truth_as_detections_scores_oks_map_one():
    ev = teval.OksMAPEvaluator(num_keypoints=17)
    for _, gt in _pose_images(seed=2):
        keep = (gt["iscrowd"] == 0) & (gt["keypoints"][..., 2].sum(-1) > 0)
        ev.update({"scores": np.ones(int(keep.sum())),
                   "keypoints": gt["keypoints"][keep]}, gt)
    res = ev.summarize()
    assert res == {"AP": 1.0, "AP_50": 1.0, "AP_75": 1.0}, res


def test_pck_matches_jax():
    rng = np.random.default_rng(3)
    g = [np.concatenate([rng.uniform(0, 100, (17, 2)),
                         rng.integers(0, 3, (17, 1))], 1) for _ in range(5)]
    g[2][:, 2] = 0
    d = [x[:, :2] + rng.normal(0, 8, (17, 2)) for x in g]
    b = [np.asarray([10, 20, 10 + rng.uniform(20, 80), 20 + rng.uniform(20,
                                                                       80)])
         for _ in g]
    for thr in (0.05, 0.2, 0.5):
        assert teval.pck(d, g, b, thr) == jeval.pck(d, g, b, thr)


# ---------------------------------------------------------------------------
# evaluate_pose on the tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(data_dir):
    torch.set_num_threads(1)
    jcfg = jconfig.tiny_test_config(use_gdino=False, use_sd=False,
                                    use_ip2p=False, use_region_encoder=False)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    jtid = JaxTid.synthetic()
    s = jpose.CocoPoseDataset(
        data_dir["tiny"], data_dir["root"], MockTokenizer(), test_mode=True,
        image_size=IMAGE_SIZE, test_scale=TEST_SCALE, buckets=BUCKETS,
        keypoint_names=TINY_KPTS)[0]
    args = [jnp.asarray(s[k])[None] for k in
            ("input_ids", "image", "image_aug", "pixel_mask")]

    def init_method(m, input_ids, images, images_aug, pixel_mask):
        m.core(input_ids, images, jtid, compute_logits=True)
        return m.infer_pose(input_ids, images, images_aug, jtid, 1,
                            pixel_mask=pixel_mask)

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, *args, method=init_method), jax.random.PRNGKey(0))
    params = random_flax_params(shapes["params"], 6)
    tmodel = build_model(tconfig.tiny_test_config(use_gdino=False,
                                                  gdino=None),
                         device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _recording(cls):
    """`cls.update` wrapped to record each image's detections."""
    seen, update = [], cls.update

    def rec(self, det, gt):
        seen.append(det)
        return update(self, det, gt)
    return seen, rec


@pytest.mark.parametrize("batch_size", [2, 1])
def test_evaluate_pose_matches_jax(data_dir, models, batch_size):
    jmodel, params, tmodel = models
    tok = MockTokenizer()
    kw = dict(test_mode=True, image_size=IMAGE_SIZE, test_scale=TEST_SCALE,
              buckets=BUCKETS, keypoint_names=TINY_KPTS, num_body_points=4)
    jds = jpose.CocoPoseDataset(data_dir["tiny"], data_dir["root"], tok, **kw)
    tds = tpose.CocoPoseDataset(data_dir["tiny"], data_dir["root"], tok,
                                image_token_len=(IMAGE_SIZE // 14) ** 2,
                                **kw)
    real_jit = jax.jit

    def o0(fn):
        """`jax.jit` as the JAX loop calls it, compiled at XLA
        optimization level 0 (`o0_jit`, on the unpatched `jax.jit`)."""
        compiled = {}

        def call(*args):
            key = jax.tree_util.tree_structure(args), tuple(
                (np.shape(x), np.result_type(x))
                for x in jax.tree_util.tree_leaves(args))
            if key not in compiled:
                compiled[key] = real_jit(fn).lower(*args).compile(
                    {"xla_backend_optimization_level": 0})
            return compiled[key](*args)
        return call

    jseen, jrec = _recording(jeval.OksMAPEvaluator)
    tseen, trec = _recording(teval.OksMAPEvaluator)
    with mock.patch.object(jax, "jit", o0), \
            mock.patch.object(jeval.OksMAPEvaluator, "update", jrec):
        want = jeval.evaluate_pose(jmodel, params, jds, JaxTid.synthetic(),
                                   topk=3, batch_size=batch_size)
    with mock.patch.object(teval.OksMAPEvaluator, "update", trec):
        got = teval.evaluate_pose(tmodel, tds, SpecialTokenIds.synthetic(),
                                  topk=3, batch_size=batch_size)
    assert len(tseen) == len(jseen) == len(tds)
    for g, w in zip(tseen, jseen):
        np.testing.assert_allclose(g["scores"], w["scores"], **DET_TOL)
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-4)
    assert set(got) == set(want)
    for k in want:
        assert (np.isnan(want[k]) and np.isnan(got[k])) or \
            abs(got[k] - want[k]) <= 1e-6, (k, got, want)
