"""The port's COCO evaluator and its det and grounding evaluation loops
against the JAX package on the CPU.

* `CocoMAPEvaluator`, bbox and segm: seeded detections over 20 images
  (crowd gt, every area range, empty images, categories with no gt)
  within 1e-12 of JAX's; `box_iou_xyxy` identical.
* `evaluate_det` (with masks, at `batch_size` 2 and 1) and `evaluate_grd`
  (with masks) on the tiny test config in fp32 with one flax param tree
  loaded into both models (`random_flax_params`): the metric dicts within
  1e-6. The JAX device functions compile at XLA optimization level 0
  (`o0_jit`), as the perception tests compile theirs.
* The image-token count at a tiny pixel-shuffle config: the port's
  datasets fill as many <im_patch> ids as the model gives feature rows;
  JAX's datasets count `(image_size // 14) ** 2` (`ROADMAP.md` §C.2).
"""

import numpy as np
import pytest
import torch
from unittest import mock

import jax
import jax.numpy as jnp

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_coco_data import (BUCKETS, IMAGE_SIZE, IMAGE_TOKENS,
                                        TEST_SCALE, write_coco,
                                        write_refcoco)
from tests.test_torch_internvl import _tiny as tiny_26b
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data import coco as jcoco
from visionllm_tpu.data.det_dataset import CocoDetDataset as JaxDetDataset
from visionllm_tpu.data.grd_dataset import RefCocoGrdDataset as JaxRefCoco
from visionllm_tpu.eval import coco_eval as jcoco_eval
from visionllm_tpu.eval import eval_det as jeval_det
from visionllm_tpu.eval import eval_grd as jeval_grd
from visionllm_tpu.eval import postprocess as jpost
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.ops import rle as jrle
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.data.det_dataset import CocoDetDataset
from visionllm_tpu_torch.data.grd_dataset import RefCocoGrdDataset
from visionllm_tpu_torch.eval import coco_eval as tcoco_eval
from visionllm_tpu_torch.eval.eval_det import evaluate_det
from visionllm_tpu_torch.eval.eval_grd import evaluate_grd
from visionllm_tpu_torch.models.composite import build_core, build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

EVAL_TOL = 1e-12
METRIC_TOL = 1e-6


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

def _boxes(rng, n, size=160.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = np.exp(rng.uniform(np.log(3), np.log(size / 1.2), (n, 2)))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _box_masks(boxes, h=170, w=170):
    out = []
    for x0, y0, x1, y1 in boxes:
        m = np.zeros((h, w), np.uint8)
        m[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))] = 1
        out.append(jrle.rle_encode(m))
    return out


def _evaluator_images(n_images=20, num_classes=5, seed=0):
    """(det, gt) pairs: gt of 0-8 objects (about 1 in 6 crowd, areas from
    a few px to large), detections near the gts (jittered, some relabelled)
    plus clutter, scores seeded; some images without gt, one without
    detections."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n_images):
        ng = int(rng.integers(0, 9)) if i % 7 else 0
        g_boxes = _boxes(rng, ng)
        gt = {"labels": rng.integers(0, num_classes - 1, ng),
              "boxes": g_boxes,
              "iscrowd": (rng.uniform(size=ng) < 0.17).astype(np.int64),
              "masks": _box_masks(g_boxes)}
        jitter = rng.normal(0, 4, (ng, 4)).astype(np.float32)
        near = g_boxes + jitter
        near[:, 2:] = np.maximum(near[:, 2:], near[:, :2] + 1)
        labels = gt["labels"].copy()
        flip = rng.uniform(size=ng) < 0.2
        labels[flip] = rng.integers(0, num_classes, int(flip.sum()))
        nc = int(rng.integers(0, 12)) if i != 3 else 0
        d_boxes = np.concatenate([near, _boxes(rng, nc)]) if i != 3 else \
            np.zeros((0, 4), np.float32)
        d_labels = np.concatenate([labels, rng.integers(0, num_classes, nc)]) \
            if i != 3 else np.zeros(0, np.int64)
        det = {"scores": rng.uniform(0.05, 1, len(d_boxes)).astype(
                   np.float32),
               "labels": d_labels, "boxes": d_boxes.astype(np.float32),
               "masks": _box_masks(d_boxes)}
        pairs.append((det, gt))
    return pairs


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_map_evaluator_matches_jax(iou_type):
    want = jcoco_eval.CocoMAPEvaluator(5, iou_type)
    got = tcoco_eval.CocoMAPEvaluator(5, iou_type)
    for det, gt in _evaluator_images():
        want.update(det, gt)
        got.update(det, gt)
    w, g = want.summarize(), got.summarize()
    assert set(g) == set(w)
    for k in w:
        assert (np.isnan(w[k]) and np.isnan(g[k])) or \
            abs(g[k] - w[k]) <= EVAL_TOL, (k, g[k], w[k])
    assert 0.05 < w["mAP"] < 0.95          # the cases exercise the protocol


def test_coco_map_evaluator_max_dets_and_area_ranges_match_jax():
    """More than max_dets detections an image, and gts given areas."""
    rng = np.random.default_rng(4)
    want = jcoco_eval.CocoMAPEvaluator(2, "bbox", max_dets=10)
    got = tcoco_eval.CocoMAPEvaluator(2, "bbox", max_dets=10)
    for _ in range(5):
        g = _boxes(rng, 6)
        gt = {"labels": rng.integers(0, 2, 6), "boxes": g,
              "areas": rng.uniform(10, 12000, 6)}
        d = np.concatenate([g + rng.normal(0, 2, g.shape), _boxes(rng, 20)])
        det = {"scores": rng.uniform(size=26), "labels": rng.integers(0, 2, 26),
               "boxes": d.astype(np.float32)}
        want.update(det, gt)
        got.update(det, gt)
    w, g = want.summarize(), got.summarize()
    for k in w:
        assert (np.isnan(w[k]) and np.isnan(g[k])) or \
            abs(g[k] - w[k]) <= EVAL_TOL, k
    assert tcoco_eval.AREA_RNGS == jcoco_eval.AREA_RNGS


def test_box_iou_matches_jax():
    rng = np.random.default_rng(6)
    d, g = _boxes(rng, 9), _boxes(rng, 7)
    for crowd in (None, [0, 1, 0, 0, 1, 0, 0]):
        np.testing.assert_array_equal(tcoco_eval.box_iou_xyxy(d, g, crowd),
                                      jcoco_eval.box_iou_xyxy(d, g, crowd))
    assert tcoco_eval.box_iou_xyxy(d[:0], g).shape == (0, 7)


def test_ground_truth_as_detections_scores_map_one():
    """The check `chip_smoke.py --phase eval` makes on the card: the gt
    fed back as detections of score 1 gives bbox and segm mAP 1.0."""
    for iou_type in ("bbox", "segm"):
        ev = tcoco_eval.CocoMAPEvaluator(5, iou_type)
        for _, gt in _evaluator_images(seed=1):
            keep = gt["iscrowd"] == 0
            det = {"scores": np.ones(int(keep.sum()), np.float32),
                   "labels": gt["labels"][keep], "boxes": gt["boxes"][keep],
                   "masks": [m for m, k in zip(gt["masks"], keep) if k]}
            ev.update(det, gt)
        res = ev.summarize()
        assert res["mAP"] == 1.0 and res["mAP_50"] == 1.0, (iou_type, res)


# ---------------------------------------------------------------------------
# evaluate_det / evaluate_grd on the tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_eval_port")
    ann = write_coco(root, seed=7)
    return root, ann, write_refcoco(root, ann, seed=8)


@pytest.fixture(scope="module")
def models(eval_set):
    """The tiny JAX composite (fp32) with seeded params, and the port's
    `build_model` of the same config with them loaded."""
    torch.set_num_threads(1)
    root, ann, _ = eval_set
    jcfg = jconfig.tiny_test_config(use_sd=False, use_ip2p=False,
                                    use_region_encoder=False)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    jtid = JaxTid.synthetic()
    s = JaxDetDataset(ann, str(root), MockTokenizer(), test_mode=True,
                      image_size=IMAGE_SIZE, test_scale=TEST_SCALE,
                      buckets=BUCKETS)[0]
    args = [jnp.asarray(s[k])[None] for k in
            ("input_ids", "image", "image_aug", "pixel_mask")]

    def init_method(m, input_ids, images, images_aug, pixel_mask):
        m.core(input_ids, images, jtid, compute_logits=True)
        m.infer_det(input_ids, images, images_aug, jtid,
                    pixel_mask=pixel_mask)
        return m.infer_pose(input_ids, images, images_aug, jtid, 1,
                            pixel_mask=pixel_mask)

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, *args, method=init_method), jax.random.PRNGKey(0))
    params = random_flax_params(shapes["params"], 2)
    tmodel = build_model(tconfig.tiny_test_config(), device="cpu",
                         dtype=torch.float32)
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _o0(make):
    """A JAX `make_*_infer_fn` whose jitted function compiles at XLA
    optimization level 0."""
    return lambda *a, **k: o0_jit(make(*a, **k).__wrapped__)


def _close_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert (np.isnan(want[k]) and np.isnan(got[k])) or \
            abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])


@pytest.mark.parametrize("batch_size", [2, 1])
def test_evaluate_det_matches_jax(eval_set, models, batch_size):
    root, ann, _ = eval_set
    jmodel, params, tmodel = models
    tok = MockTokenizer()
    kw = dict(test_mode=True, with_mask=True, image_size=IMAGE_SIZE,
              test_scale=TEST_SCALE, buckets=BUCKETS)
    jds = JaxDetDataset(ann, str(root), tok, **kw)
    tds = CocoDetDataset(ann, str(root), tok, image_token_len=IMAGE_TOKENS,
                         **kw)
    with mock.patch.object(jeval_det, "make_det_infer_fn",
                           _o0(jeval_det.make_det_infer_fn)):
        want = jeval_det.evaluate_det(jmodel, params, jds, JaxTid.synthetic(),
                                      with_mask=True, topk=10,
                                      batch_size=batch_size, progress=False)
    got = evaluate_det(tmodel, tds, SpecialTokenIds.synthetic(),
                       with_mask=True, topk=10, batch_size=batch_size,
                       progress=False)
    assert "bbox_mAP" in got and "segm_mAP" in got
    _close_dicts(got, want)


def test_evaluate_grd_matches_jax(eval_set, models):
    """Prec@0.5 within 1e-6. cIoU within 1e-6 plus the pixels whose
    finished logit lies within `delta` of 0 in the JAX run, each of which
    may flip (the two models' fp32 logits differ by about 1e-5): counted
    as the pixels where the JAX mask at logits + delta and at logits -
    delta differ (the finishing resizes are linear, their weights sum to
    1), each moving the intersection and the union by at most one."""
    root, _, ref = eval_set
    jmodel, params, tmodel = models
    tok = MockTokenizer()
    kw = dict(test_mode=True, with_mask=True, image_size=IMAGE_SIZE,
              test_scale=TEST_SCALE, buckets=BUCKETS)
    jds = JaxRefCoco(ref, str(root), tok, **kw)
    tds = RefCocoGrdDataset(ref, str(root), tok,
                            image_token_len=IMAGE_TOKENS, **kw)
    delta, near, finished = 1e-3, [], []
    finish = jpost.post_process_masks_np

    def counting(logits, *a):
        near.append(int((finish(logits + delta, *a)
                         != finish(logits - delta, *a)).sum()))
        finished.append(finish(logits, *a)[0])
        return finished[-1][None]

    with mock.patch.object(jeval_grd, "make_grd_infer_fn",
                           _o0(jeval_grd.make_grd_infer_fn)), \
            mock.patch.object(jpost, "post_process_masks_np", counting):
        want = jeval_grd.evaluate_grd(jmodel, params, jds, JaxTid.synthetic(),
                                      with_mask=True, limit=6)
    got = evaluate_grd(tmodel, tds, SpecialTokenIds.synthetic(),
                       with_mask=True, limit=6)
    assert set(got) == set(want) == {"prec@0.5", "cIoU"} and len(near) == 6
    assert abs(got["prec@0.5"] - want["prec@0.5"]) <= METRIC_TOL
    union = 0
    for i, pm in enumerate(finished):
        image_id, ann, _ = jds.items[i]
        info = jds.images[image_id]
        gm = jcoco.decode_segmentation(ann["segmentation"], info["height"],
                                       info["width"]) > 0
        union += int((pm | gm).sum())
    k = sum(near)
    slack = 2 * k / (union - k) if k else 0.0
    assert abs(got["cIoU"] - want["cIoU"]) <= METRIC_TOL + slack, \
        (got, want, near, union)


# ---------------------------------------------------------------------------
# the image-token count under pixel shuffle (ROADMAP.md §C.2)
# ---------------------------------------------------------------------------

def test_datasets_count_the_shuffled_feature_rows(eval_set):
    root, ann, ref = eval_set
    cfg = tiny_26b(tconfig, image_size=IMAGE_SIZE)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        feats, _ = core.encode_images(torch.zeros(1, IMAGE_SIZE, IMAGE_SIZE,
                                                  3))
    rows = feats.shape[1]
    assert cfg.use_pixelshuffle and rows == cfg.image_token_len == 4
    tok = MockTokenizer()
    imp = tok.convert_tokens_to_ids("<im_patch>")
    kw = dict(test_mode=True, image_size=IMAGE_SIZE, test_scale=TEST_SCALE,
              buckets=BUCKETS)
    for tcls, jcls, path in ((CocoDetDataset, JaxDetDataset, ann),
                             (RefCocoGrdDataset, JaxRefCoco, ref)):
        got = tcls(path, str(root), tok, image_token_len=cfg.image_token_len,
                   **kw)[0]
        want = jcls(path, str(root), tok, **kw)[0]
        assert int((got["input_ids"] == imp).sum()) == rows
        # the reference's count: (56 // 14) ** 2 for 4 feature rows
        assert int((want["input_ids"] == imp).sum()) == 16
