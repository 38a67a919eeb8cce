"""The port's semseg, interactive and region evals against the JAX
package on the CPU.

* `semantic_map_from_queries`, `MIoUEvaluator` and `sod_metrics` on
  seeded inputs: the maps identical, the metrics within 1e-12.
* The region evals' loaders (`load_region_caption`,
  `load_region_recognition`, `load_region_classification`, `load_vcr`),
  `materialize` (the port reads PNGs without Pillow) and the scorers
  (`semantic_iou`, `bow_cosine`, `score_*`) on fixed rows: equal.
* `evaluate_semseg` and `evaluate_interactive` on the tiny model (fp32,
  the region encoder on) with one flax param tree loaded into both
  packages (`random_flax_params`): the metrics within 1e-6, each image's
  device outputs (scores and mask logits; boxes and scores) within 1e-4.
  The JAX device functions compile at XLA optimization level 0
  (`o0_jit`). `run_region_eval` on the tiny core gives JAX's metrics.
"""

import json

import numpy as np
import pytest
import torch
from unittest import mock

import jax
import jax.numpy as jnp

import visionllm_tpu.data  # noqa: F401  (registers the JAX types)
import visionllm_tpu_torch.data  # noqa: F401  (registers the port's)
from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_coco_data import (BUCKETS, IMAGE_SIZE, IMAGE_TOKENS,
                                        TEST_SCALE, write_coco)
from tests.test_torch_data_variants import ADE_CLASSES, _seg_label
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data.interactive_dataset import \
    CocoInteractiveDataset as JaxInteractive
from visionllm_tpu.data.semseg_dataset import SemSegDataset as JaxSemSeg
from visionllm_tpu.eval import eval_det as jeval_det
from visionllm_tpu.eval import eval_interactive as jeval_inter
from visionllm_tpu.eval import eval_semseg as jsem
from visionllm_tpu.eval import region_eval as jre
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.data.interactive_dataset import \
    CocoInteractiveDataset
from visionllm_tpu_torch.data.semseg_dataset import SemSegDataset
from visionllm_tpu_torch.eval import eval_interactive as teval_inter
from visionllm_tpu_torch.eval import eval_semseg as tsem
from visionllm_tpu_torch.eval import region_eval as tre
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.composite import build_core, build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

METRIC_TOL = 1e-6
OUT_TOL = 1e-4
MAX_NEW = 4


# ---------------------------------------------------------------------------
# the semantic map, mIoU and the salient-object metrics
# ---------------------------------------------------------------------------

def test_semantic_map_from_queries_matches_jax():
    rng = np.random.default_rng(0)
    for q, k, h, w in ((5, 3, 7, 9), (20, 12, 16, 16), (1, 1, 4, 5)):
        logits = rng.normal(0, 3, (q, k + 2)).astype(np.float32)
        masks = rng.normal(0, 4, (q, h, w)).astype(np.float32)
        np.testing.assert_array_equal(
            tsem.semantic_map_from_queries(logits, masks, k),
            jsem.semantic_map_from_queries(logits, masks, k))


def test_miou_evaluator_matches_jax():
    rng = np.random.default_rng(1)
    want, got = jsem.MIoUEvaluator(9), tsem.MIoUEvaluator(9)
    for _ in range(6):
        gt = _seg_label(rng, 40, 52, 7)
        pred = np.where(rng.uniform(size=gt.shape) < 0.7, gt,
                        rng.integers(0, 9, gt.shape)).astype(np.int64)
        pred[gt == 255] = rng.integers(0, 9)
        want.update(pred, gt)
        got.update(pred, gt)
    np.testing.assert_array_equal(got.conf, want.conf)
    w, g = want.summarize(), got.summarize()
    assert set(g) == set(w) == {"mIoU", "aAcc"}
    for key in w:
        assert abs(g[key] - w[key]) <= 1e-12, key
    assert tsem.MIoUEvaluator(3).summarize() == \
        jsem.MIoUEvaluator(3).summarize()


def test_sod_metrics_match_jax():
    rng = np.random.default_rng(2)
    preds, gts = [], []
    for i in range(5):
        g = (rng.uniform(size=(30, 40)) < 0.3).astype(np.uint8)
        p = rng.uniform(size=(30, 40))
        preds.append((p * 255).astype(np.uint8) if i % 2 else p)
        gts.append(g * (255 if i == 3 else 1))
    preds.append(np.zeros((8, 8)))
    gts.append(np.zeros((8, 8)))
    w, g = jsem.sod_metrics(preds, gts), tsem.sod_metrics(preds, gts)
    assert set(g) == set(w) == {"MAE", "maxF"}
    for key in w:
        assert abs(g[key] - w[key]) <= 1e-12, key


# ---------------------------------------------------------------------------
# the region evals' loaders, materialize and scorers
# ---------------------------------------------------------------------------

def write_region_files(root, ann_file):
    """The four region-eval formats over a COCO set's images: a
    caption file (several captions a region, one region given by a
    segmentation), the instances themselves for recognition, an Osprey
    classification file and a VCR jsonl."""
    with open(ann_file) as f:
        raw = json.load(f)
    images = raw["images"]
    anns = [a for a in raw["annotations"] if not a["iscrowd"]]
    cap = {"images": images, "annotations": []}
    for k, a in enumerate(anns[:5]):
        for j in range(1 + k % 2):
            row = {"image_id": a["image_id"], "bbox": a["bbox"],
                   "caption": f"a red thing {k} {j}"}
            if k == 1:
                row["segmentation"] = a["segmentation"]
            cap["annotations"].append(row)
    cls = [{"id": im["id"], "file_name": im["file_name"],
            "height": im["height"], "width": im["width"],
            "categories": ["traffic_light", "dog:head"][:1 + i % 2],
            "annotations": [{"bbox": a["bbox"],
                             "segmentation": a["segmentation"]}
                            for a in anns if a["image_id"] == im["id"]
                            ][:1 + i % 2]}
           for i, im in enumerate(images[:3])]
    files = {"caption": root / "region_cap.json",
             "recognition": ann_file,
             "classification": root / "region_cls.json",
             "vcr": root / "vcr.jsonl"}
    with open(files["caption"], "w") as f:
        json.dump(cap, f)
    with open(files["classification"], "w") as f:
        json.dump(cls, f)
    with open(files["vcr"], "w") as f:
        for k, im in enumerate(images[:3]):
            f.write(json.dumps({
                "image": im["file_name"],
                "boxes": [[0.1, 0.2, 0.5, 0.6], [0.3, 0.05, 0.9, 0.45]],
                "conversations": [{"from": "human", "value":
                                   "<image>\nWhy does <regions> wait? "
                                   "A. rain B. sun C. no D. yes"}],
                "correct_option": "ABCD"[k], "category": ("Q->A",
                                                          "QA->R")[k % 2]})
                + "\n")
    return {k: str(v) for k, v in files.items()}


@pytest.fixture(scope="module")
def region_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("region_eval")
    ann = write_coco(root, seed=21)
    return root, write_region_files(root, ann)


LOADER_KWARGS = {
    "region-caption": [{"test_format": "bbox"}, {"test_format": "mask"}],
    "region-recognition": [{"vocab": "coco", "test_format": "bbox"},
                           {"vocab": "lvis", "test_format": "mask",
                            "limit": 3}],
    "region-classification": [{"test_format": "bbox"},
                              {"test_format": "mask", "limit": 2}],
    "vcr": [{}, {"limit": 2}]}
TASK_FILES = {"region-caption": "caption",
              "region-recognition": "recognition",
              "region-classification": "classification", "vcr": "vcr"}


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("task", sorted(LOADER_KWARGS))
def test_region_loaders_and_materialize_match_jax(region_set, task):
    root, files = region_set
    for kw in LOADER_KWARGS[task]:
        want = jre.TASKS[task][0](files[TASK_FILES[task]], str(root), **kw)
        got = tre.TASKS[task][0](files[TASK_FILES[task]], str(root), **kw)
        _same_rows(got, want)
        _same_rows(tre.materialize(got, IMAGE_SIZE),
                   jre.materialize(want, IMAGE_SIZE))
    assert [t[2] for t in tre.TASKS.values()] == \
        [t[2] for t in jre.TASKS.values()]


def test_region_scorers_match_jax():
    pairs = [("a red dog", "red dog"), ("Traffic-light.", "traffic light"),
             ("", "cat"), ("the the cat", "cat the"), ("x/y_z", "x y z")]
    for p, t in pairs:
        assert tre.semantic_iou(p, t) == jre.semantic_iou(p, t)
        assert tre.bow_cosine(p, t) == jre.bow_cosine(p, t)
    cap = [{"prediction": "a red thing", "captions": ["A red thing 1",
                                                      "a blue thing"]},
           {"prediction": "nothing", "captions": []}]
    rec = [{"prediction": p, "label": "dog", "label_names": ["cat", "dog"],
            "str2idx": {"cat": 1, "dog": 3}, "image_id": 5,
            "bbox": [1, 2, 3, 4]} for p in ("dog", "cat", "cow")]
    cls = [{"prediction": p, "category": "traffic light"}
           for p in ("traffic light.", "category: light", "dog")]
    vcr = [{"prediction": p, "answer": a, "category": c}
           for p, a, c in (("a.", "A", "Q->A"), ("b", "C", "Q->A"),
                           ("D", "D", "QA->R"))]
    for name, rows in (("score_region_caption", cap),
                       ("score_region_recognition", rec),
                       ("score_region_classification", cls),
                       ("score_vcr", vcr)):
        assert getattr(tre, name)(rows) == getattr(jre, name)(rows), name


# ---------------------------------------------------------------------------
# evaluate_semseg, evaluate_interactive and run_region_eval on the tiny
# model
# ---------------------------------------------------------------------------

def tiny_composite():
    """(the JAX tiny config with the region encoder, seeded params of its
    core, gdino and unipose): the tree's shapes from `jax.eval_shape` of
    the init through the core with a region, `infer_det` and
    `infer_pose`."""
    jcfg = jconfig.tiny_test_config(use_sd=False, use_ip2p=False)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    tid = JaxTid.synthetic()
    ids = jnp.asarray([[1] + [tid.imp] * IMAGE_TOKENS
                       + [tid.reg, 5, tid.det, tid.emb, tid.emb + 1, 2]])
    img = jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3))
    aug = jnp.zeros((1, 64, 64, 3))
    regions = jnp.ones((1, 1, IMAGE_SIZE, IMAGE_SIZE))

    def init_method(m):
        m.core(ids, img, tid, compute_logits=True, regions=regions)
        m.infer_det(ids, img, aug, tid)
        return m.infer_pose(ids, img, aug, tid, 1)

    shapes = jax.eval_shape(lambda r: jmodel.init(r, method=init_method),
                            jax.random.PRNGKey(0))
    return jcfg, random_flax_params(shapes["params"], 3)


def port_tiny(params):
    torch.set_num_threads(1)
    model = build_model(tconfig.tiny_test_config(use_region_encoder=True),
                        device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    return model


def jax_tiny(jcfg):
    return JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)


def o0(make):
    """A JAX `make_*_infer_fn` whose jitted function compiles at XLA
    optimization level 0."""
    return lambda *a, **k: o0_jit(make(*a, **k).__wrapped__)


def recording(make, store, to_np):
    """`make` whose infer functions append each call's outputs (as
    numpy) to `store`."""
    def wrapped(*a, **k):
        fn = make(*a, **k)

        def call(*args):
            out = fn(*args)
            store.append({key: to_np(v) for key, v in out.items()})
            return out
        return call
    return wrapped


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jcfg, params = tiny_composite()
    root = tmp_path_factory.mktemp("evalx")
    ann = write_coco(root, seed=31)
    with open(ann) as f:
        images = json.load(f)["images"]
    rng = np.random.default_rng(32)
    rows = []
    for i, im in enumerate(images[:3]):
        label = _seg_label(rng, im["height"], im["width"], len(ADE_CLASSES))
        from PIL import Image
        Image.fromarray(label).save(root / f"label{i}.png")
        rows.append({"image": im["file_name"], "label": f"label{i}.png"})
    with open(root / "semseg.json", "w") as f:
        json.dump(rows, f)
    return {"jcfg": jcfg, "params": params, "model": port_tiny(params),
            "root": root, "ann": ann, "semseg": str(root / "semseg.json")}


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for key in want:
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key],
                                                             np.float64)
        assert g.shape == w.shape, (what, key)
        assert np.abs(g - w).max(initial=0) <= tol, (what, key)


def test_evaluate_semseg_matches_jax(tiny):
    tok = MockTokenizer()
    kw = dict(class_names=ADE_CLASSES, test_mode=True,
              image_size=IMAGE_SIZE, test_scale=TEST_SCALE, buckets=BUCKETS)
    jds = JaxSemSeg(tiny["semseg"], str(tiny["root"]), tok, **kw)
    tds = SemSegDataset(tiny["semseg"], str(tiny["root"]), tok,
                        image_token_len=IMAGE_TOKENS, **kw)
    outs_j, outs_t, maps_j, maps_t = [], [], [], []
    real_j, real_t = jsem.MIoUEvaluator.update, tsem.MIoUEvaluator.update

    def keep(store, real):
        def update(self, pred, gt):
            store.append(pred)
            return real(self, pred, gt)
        return update

    with mock.patch.object(jeval_det, "make_det_infer_fn", recording(
            o0(jeval_det.make_det_infer_fn), outs_j, np.asarray)), \
            mock.patch.object(jsem.MIoUEvaluator, "update",
                              keep(maps_j, real_j)):
        want = jsem.evaluate_semseg(jax_tiny(tiny["jcfg"]), tiny["params"],
                                    jds, JaxTid.synthetic())
    with mock.patch.object(tsem, "make_det_infer_fn", recording(
            tsem.make_det_infer_fn, outs_t, lambda v: v.numpy())), \
            mock.patch.object(tsem.MIoUEvaluator, "update",
                              keep(maps_t, real_t)):
        got = tsem.evaluate_semseg(tiny["model"], tds,
                                   SpecialTokenIds.synthetic())
    assert len(outs_t) == len(outs_j) == len(tds) == 3
    for i, (g, w) in enumerate(zip(outs_t, outs_j)):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        _close({k: g[k] for k in ("scores", "mask_logits")},
               {k: w[k] for k in ("scores", "mask_logits")}, OUT_TOL,
               f"image {i}")
    for g, w in zip(maps_t, maps_j):
        assert g.shape == w.shape and (g == w).mean() > 0.999
    assert set(got) == set(want) == {"mIoU", "aAcc"}
    for key in want:
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got, want)


def test_evaluate_interactive_matches_jax(tiny):
    tok = MockTokenizer()
    kw = dict(test_mode=True, image_size=IMAGE_SIZE, test_scale=TEST_SCALE,
              buckets=BUCKETS, max_regions=4)
    jds = JaxInteractive(tiny["ann"], str(tiny["root"]), tok, **kw)
    tds = CocoInteractiveDataset(tiny["ann"], str(tiny["root"]), tok,
                                 image_token_len=IMAGE_TOKENS, **kw)
    outs_j, outs_t = [], []
    with mock.patch.object(jeval_inter, "make_interactive_infer_fn",
                           recording(o0(jeval_inter.make_interactive_infer_fn),
                                     outs_j, np.asarray)):
        want = jeval_inter.evaluate_interactive(
            jax_tiny(tiny["jcfg"]), tiny["params"], jds, JaxTid.synthetic())
    with mock.patch.object(teval_inter, "make_interactive_infer_fn",
                           recording(teval_inter.make_interactive_infer_fn,
                                     outs_t, lambda v: v.numpy())):
        got = teval_inter.evaluate_interactive(tiny["model"], tds,
                                               SpecialTokenIds.synthetic())
    assert len(outs_t) == len(outs_j) == len(tds)
    for i, (g, w) in enumerate(zip(outs_t, outs_j)):
        _close(g, w, OUT_TOL, f"image {i}")
    assert set(got) == set(want) == {"region_acc@0.5"}
    assert abs(got["region_acc@0.5"] - want["region_acc@0.5"]) <= METRIC_TOL


@pytest.mark.parametrize("task", ["region-recognition", "vcr"])
def test_run_region_eval_matches_jax(tiny, region_set, task):
    root, files = region_set
    jcfg = tiny["jcfg"]
    tok = MockTokenizer()
    rows_kw = {"limit": 2}
    want_rows = jre.TASKS[task][0](files[TASK_FILES[task]], str(root),
                                   **rows_kw)
    got_rows = tre.TASKS[task][0](files[TASK_FILES[task]], str(root),
                                  **rows_kw)
    jgen = jax_generate_fn(JaxCore(jcfg, dtype=jnp.float32),
                           JaxTid.synthetic(), max_new_tokens=MAX_NEW)
    want = jre.run_region_eval(task, jgen, tiny["params"]["core"], tok,
                               want_rows, image_size=IMAGE_SIZE)
    cfg = tconfig.tiny_test_config(use_region_encoder=True)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, tiny["params"]["core"])
    gen = build_generate_fn(core, SpecialTokenIds.synthetic(),
                            max_new_tokens=MAX_NEW)
    got = tre.run_region_eval(task, gen, cfg, tok, got_rows, device="cpu")
    assert got == want
