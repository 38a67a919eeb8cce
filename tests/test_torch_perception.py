"""The port's perception front door against the JAX package on the CPU:
configs and templates, the test-time transforms, preprocess, RLE, the
post-processing, `Predictor.detect`, `.ground` and `.pose`, and the
/v1/detect, /v1/ground and /v1/pose endpoints.

Inputs are made with numpy from a seed. Exact: the resampler and
`det_test_transform` (uint8 and float32-held uint8 images), preprocess
ids and labels on the word-level mock tokenizer, RLE strings, template
constants. Masks: the float resize to 1e-5, the bool masks identical
wherever |logit| > 1e-3. The Predictor and the endpoints run the tiny
test config in fp32 (Grounding-DINO and UniPose on Swin-T, CLIP and
LLaMA 2 layers) with one flax param tree (`random_flax_params`) loaded
into both: scores, boxes and keypoints within 1e-4 abs + 1e-4 rel,
labels, class names and masks identical. The image is 60 x 120 px,
resized to 64 x 128 and padded to a 128 px bucket, so the padding spans a
whole row of the stride-64 level.
"""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data import mm_utils as jmm
from visionllm_tpu.data import preprocess as jpre
from visionllm_tpu.data import templates as jtemplates
from visionllm_tpu.data import transforms as jtr
from visionllm_tpu.eval import eval_pose as jpose
from visionllm_tpu.eval import postprocess as jpost
from visionllm_tpu.eval.eval_det import make_det_infer_fn
from visionllm_tpu.eval.eval_grd import make_grd_infer_fn
from visionllm_tpu.infer import Predictor as JaxPredictor
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.ops import rle as jrle
from visionllm_tpu.serve import make_server as jax_make_server
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.data import mm_utils as tmm
from visionllm_tpu_torch.data import preprocess as tpre
from visionllm_tpu_torch.data import templates as ttemplates
from visionllm_tpu_torch.data import transforms as ttr
from visionllm_tpu_torch.eval import eval_pose as tpose
from visionllm_tpu_torch.eval import postprocess as tpost
from visionllm_tpu_torch.infer import Predictor
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.ops import rle as trle
from visionllm_tpu_torch.serve import ChatService, make_server
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)


def _img(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


# ---------------------------------------------------------------------------
# configs and templates
# ---------------------------------------------------------------------------

def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["perception", "gen", "tiny"])
def test_config_matches_jax(which):
    """Every field the port keeps equals the JAX config's; UniPose's and
    the generation heads' configs field for field. The port's tiny config
    leaves the generation heads and the region encoder off (the parity
    tests load JAX trees without `sd` / `ip2p` / `region_encoder` keys
    and pass those in as overrides), so it is held to JAX's tiny config
    with them off."""
    if which == "perception":
        want = jconfig.vllm_7b_config(use_sd=False, use_ip2p=False,
                                      use_region_encoder=False)
        got = tconfig.vllm_7b_perception_config()
    elif which == "gen":
        want = jconfig.vllm_7b_config(use_gdino=False, use_unipose=False,
                                      use_region_encoder=False)
        got = tconfig.vllm_7b_gen_config()
    else:
        want = jconfig.tiny_test_config(use_sd=False, sd=None,
                                        use_ip2p=False, ip2p=None,
                                        use_region_encoder=False)
        got = tconfig.tiny_test_config()
    for name, val in _fields(got).items():
        ref = getattr(want, name)
        if dataclasses.is_dataclass(val):
            theirs = _fields(ref)
            assert {k: theirs[k] for k in _fields(val)} == _fields(val), name
            if name in ("unipose", "sd", "ip2p", "region_encoder"):
                assert _fields(val) == theirs, name
        else:
            assert val == ref, name


def test_templates_are_the_jax_constants():
    names = [n for n in dir(jtemplates) if n.isupper()]
    assert names
    for n in names:
        assert getattr(ttemplates, n) == getattr(jtemplates, n), n
    for fn in ("det_answer_tokens", "grd_answer_tokens", "pose_answer_tokens",
               "gen_answer_tokens", "edit_answer_tokens"):
        for k in (1, 4, 8):
            assert getattr(ttemplates, fn)(k) == getattr(jtemplates, fn)(k)


# ---------------------------------------------------------------------------
# resampling and the test-time transforms: exact
# ---------------------------------------------------------------------------

RESIZES = [((37, 53), (64, 91)), ((120, 80), (45, 30)), ((33, 90), (33, 61)),
           ((480, 640), (800, 1067)), ((61, 47), (200, 13))]


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_image_matches_jax(method, dtype):
    for i, (src, dst) in enumerate(RESIZES):
        img = _img(i, src + (3,)).astype(dtype)
        want = jmm.resize_image(img, dst, method)
        got = tmm.resize_image(img, dst, method)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    gray = _img(9, (50, 70))
    np.testing.assert_array_equal(tmm.resize_image(gray, (31, 97), method),
                                  jmm.resize_image(gray, (31, 97), method))


@pytest.mark.parametrize("shape,scale,buckets", [
    ((480, 640, 3), jtr.TEST_SCALE, jtr.DEFAULT_BUCKETS),
    ((640, 480, 3), jtr.TEST_SCALE, jtr.DEFAULT_BUCKETS),
    ((500, 500, 3), jtr.TEST_SCALE, jtr.DEFAULT_BUCKETS),
    ((60, 120, 3), (64, 128), ((128, 128),)),
    ((300, 90, 3), (64, 128), ((64, 64), (128, 64))),   # crop: none fits
])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_det_test_transform_matches_jax(shape, scale, buckets, dtype):
    assert ttr.TEST_SCALE == jtr.TEST_SCALE
    assert ttr.DEFAULT_BUCKETS == jtr.DEFAULT_BUCKETS
    img = _img(sum(shape), shape).astype(dtype)
    boxes = np.asarray([[1.0, 2.0, 30.0, 40.0]], np.float32)
    masks = (_img(1, (1,) + shape[:2]) > 127).astype(np.uint8)

    def sample():
        return {"image": img, "boxes": boxes, "masks": masks,
                "labels": np.zeros((1,), np.int32)}
    want = jtr.det_test_transform(sample(), scale, buckets)
    got = ttr.det_test_transform(sample(), scale, buckets)
    assert got["image"].dtype == np.float32
    for k in ("image", "pixel_mask", "boxes", "masks"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["img_shape"] == want["img_shape"]


def test_post_process_masks_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 32, 32))).astype(np.float32)
    img_shape, ori = (64, 128), (60, 120)
    # the float path: x4 upsample, crop, resize to the original size
    from PIL import Image
    for m in logits:
        up = np.asarray(Image.fromarray(m).resize((128, 128), Image.BILINEAR))
        got_up = tmm.resize_float(m, (128, 128))
        np.testing.assert_allclose(got_up, up, atol=1e-5, rtol=0)
        crop = up[:img_shape[0], :img_shape[1]]
        down = np.asarray(Image.fromarray(crop).resize((ori[1], ori[0]),
                                                       Image.BILINEAR))
        np.testing.assert_allclose(tmm.resize_float(crop, ori), down,
                                   atol=1e-5, rtol=0)
    want = jpost.post_process_masks_np(logits, img_shape, ori)
    got = tpost.post_process_masks_np(logits, img_shape, ori)
    assert got.dtype == bool and got.shape == want.shape
    final = np.stack([tmm.resize_float(tmm.resize_float(m, (128, 128))[
        :img_shape[0], :img_shape[1]], ori) for m in logits])
    sure = np.abs(final) > 1e-3
    np.testing.assert_array_equal(got[sure], want[sure])


# ---------------------------------------------------------------------------
# preprocess, RLE, post-processing
# ---------------------------------------------------------------------------

CONVERSATIONS = {
    "v1_image": ("v1", True, [
        {"from": "human", "value": "<image>\nwhere is the cat?"},
        {"from": "gpt", "value": "Yes, it is [GRD][EMB][EMB2]."}]),
    "vicuna_multi_turn": ("vicuna_v1", True, [
        {"from": "human", "value": "what is this <image>"},
        {"from": "gpt", "value": "a dog"},
        {"from": "human", "value": "and its color?"},
        {"from": "gpt", "value": "brown, with white paws."}]),
    "v1_text": ("v1", False, [
        {"from": "human", "value": "hello there"},
        {"from": "gpt", "value": "hi, how can I help?"}]),
    "internlm": ("internlm2_chat", True, [
        {"from": "human", "value": "<image>\ndetect the person"},
        {"from": "gpt", "value": "here [DET][EMB]"},
        {"from": "human", "value": "and the dog"},
        {"from": "gpt", "value": "there [DET][EMB]"}]),
}


@pytest.mark.parametrize("name", list(CONVERSATIONS))
def test_preprocess_matches_jax(name):
    version, has_image, conv = CONVERSATIONS[name]
    tok = MockTokenizer()

    def run(mod):
        return mod.preprocess(mod.preprocess_multimodal(
            [[dict(t) for t in conv]]), tok, version=version,
            has_image=has_image, image_token_len=16)
    want, got = run(jpre), run(tpre)
    for k in ("input_ids", "labels"):
        assert len(got[k]) == 1
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        assert got[k][0].dtype == want[k][0].dtype


def test_rle_matches_jax():
    rng = np.random.default_rng(3)
    for h, w in [(7, 5), (60, 120), (1, 9), (33, 2)]:
        for fill in (0.0, 0.3, 0.97, 1.0):
            m = (rng.random((h, w)) < fill).astype(bool)
            got, want = trle.rle_encode(m), jrle.rle_encode(m)
            assert got == want
            np.testing.assert_array_equal(
                trle.rle_decode(got["counts"], h, w),
                jrle.rle_decode(want["counts"], h, w))
            assert trle.rle_area(got) == jrle.rle_area(want) == m.sum()


def test_post_process_det_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 30, 8)).astype(np.float32)
    logits[..., 5:] = np.finfo(np.float32).min
    boxes = rng.uniform(0.1, 0.9, (2, 30, 4)).astype(np.float32)
    want = jpost.post_process_det(jnp.asarray(logits), jnp.asarray(boxes),
                                  5, topk=17)
    got = tpost.post_process_det(torch.from_numpy(logits),
                                 torch.from_numpy(boxes), 5, topk=17)
    for k in ("labels", "query_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    np.testing.assert_allclose(
        tpost.scale_boxes_np(got["boxes"][0].numpy(), (60, 120)),
        jpost.scale_boxes_np(np.asarray(want["boxes"][0]), (60, 120)))


def test_post_process_pose_matches_jax():
    rng = np.random.default_rng(5)
    args = (rng.standard_normal((9, 3)).astype(np.float32),
            rng.uniform(0.1, 0.9, (9, 4)).astype(np.float32),
            rng.uniform(0, 1, (9, 12)).astype(np.float32))
    want = jpose.post_process_pose(*args, (60, 120), topk=5)
    got = tpose.post_process_pose(*args, (60, 120), topk=5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Predictor and the endpoints
# ---------------------------------------------------------------------------

SCALE, BUCKETS = (64, 128), ((128, 128),)
IMAGE = _img(0, (60, 120, 3))
CLASSES = ["cat", "dog", "person"]
KEYPOINTS = ["nose", "left eye", "right eye", "left ear"]
DETECT = dict(threshold=0.0, topk=10, with_mask=True)
POSE = dict(keypoint_names=KEYPOINTS, threshold=0.0, topk=5)
EXPRESSION = "the dog on the left"


@pytest.fixture(scope="module")
def predictors():
    torch.set_num_threads(1)
    jcfg = jconfig.tiny_test_config(use_sd=False, use_ip2p=False,
                                    use_region_encoder=False)
    tok = MockTokenizer()
    jpred = JaxPredictor(jcfg, None, tok, dtype=jnp.float32,
                         test_scale=SCALE, buckets=BUCKETS)
    jpred.model = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    arr = jpred._prepare(IMAGE, "<image>\nq", "a")

    def init_method(m, input_ids, images, images_aug, pixel_mask):
        m.core(input_ids, images, jpred.tid, compute_logits=True)
        m.infer_det(input_ids, images, images_aug, jpred.tid,
                    pixel_mask=pixel_mask)
        return m.infer_pose(input_ids, images, images_aug, jpred.tid, 1,
                            pixel_mask=pixel_mask)

    shapes = jax.eval_shape(lambda r: jpred.model.init(
        r, arr["input_ids"], arr["image"], arr["image_aug"],
        arr["pixel_mask"], method=init_method), jax.random.PRNGKey(0))
    jpred.params = random_flax_params(shapes["params"], 1)
    # the JAX predictor's three device functions, compiled at XLA's
    # optimization level 0 (same operations, half the compile time)
    jpred._fns[("det", len(CLASSES), DETECT["topk"])] = o0_jit(
        make_det_infer_fn(jpred.model, jpred.tid, len(CLASSES),
                          DETECT["topk"]))
    jpred._fns[("grd",)] = o0_jit(make_grd_infer_fn(jpred.model, jpred.tid))
    jpred._fns[("pose",)] = o0_jit(
        lambda p, ids, im, ia, pm: jpred.model.apply(
            {"params": p}, ids, im, ia, jpred.tid, 1, pixel_mask=pm,
            method=JaxModel.infer_pose))

    model = build_model(tconfig.tiny_test_config(), device="cpu",
                        dtype=torch.float32)
    load_jax_params(model, jpred.params)
    tpred = Predictor(tconfig.tiny_test_config(), model, tok, device="cpu",
                      test_scale=SCALE, buckets=BUCKETS)
    return jpred, tpred


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


def test_predictor_prompts_and_inputs_match_jax(predictors):
    jpred, tpred = predictors
    for q, a in (("<image>\nfind it", "Yes, it is [GRD][EMB]."),
                 ("<image>\n" + "x " * 40, "y [DET][EMB][EMB2][EMB3][EMB4]")):
        want, got = jpred._prepare(IMAGE, q, a), tpred._prepare(IMAGE, q, a)
        assert got["input_ids"].shape[1] % 32 == 0
        for k in ("input_ids", "image", "image_aug", "pixel_mask"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        assert got["ori_shape"] == want["ori_shape"]
        assert got["img_shape"] == want["img_shape"]


def test_detect_matches_jax(predictors):
    jpred, tpred = predictors
    want = jpred.detect(IMAGE, CLASSES, **DETECT)
    got = tpred.detect(IMAGE, CLASSES, **DETECT)
    assert len(got["scores"]) == DETECT["topk"]
    _close(got["scores"], want["scores"])
    _close(got["boxes"], want["boxes"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["class_names"] == want["class_names"]
    assert len(got["masks"]) == len(want["masks"])
    for g, w in zip(got["masks"], want["masks"]):
        assert g.shape == IMAGE.shape[:2] and g.dtype == bool
        np.testing.assert_array_equal(g, w)


def test_ground_matches_jax(predictors):
    jpred, tpred = predictors
    want = jpred.ground(IMAGE, EXPRESSION, with_mask=True)
    got = tpred.ground(IMAGE, EXPRESSION, with_mask=True)
    _close(got["box"], want["box"])
    _close(got["score"], want["score"])
    np.testing.assert_array_equal(got["mask"], want["mask"])


def test_pose_matches_jax(predictors):
    jpred, tpred = predictors
    want = jpred.pose(IMAGE, **POSE)
    got = tpred.pose(IMAGE, **POSE)
    assert got["keypoints"].shape == (POSE["topk"], len(KEYPOINTS), 3)
    for k in ("scores", "boxes", "keypoints"):
        _close(got[k], want[k])
    assert got["keypoint_names"] == want["keypoint_names"]


def test_predictor_rejects_a_bad_image(predictors):
    _, tpred = predictors
    with pytest.raises(ValueError, match="H, W, 3"):
        tpred.detect(np.zeros((4, 4), np.uint8), ["x"])


@pytest.fixture(scope="module")
def servers(predictors):
    jpred, tpred = predictors
    cfg = tconfig.tiny_test_config()
    svc = ChatService(cfg, tpred.model.core, tpred.tokenizer,
                      image_size=cfg.vis_encoder.image_size, device="cpu",
                      max_new_tokens=2, max_prompt=64)
    # the JAX server's perception endpoints never touch its chat service
    srvs = [make_server(svc, port=0, predictor=tpred),
            jax_make_server(None, port=0, predictor=jpred),
            make_server(svc, port=0)]
    for s in srvs:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield srvs, [f"http://127.0.0.1:{s.server_address[1]}"
                              for s in srvs]
    for s in srvs:
        s.shutdown()
        s.server_close()
    svc.close()


def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _img_req(img, **kw):
    return {"image_b64": base64.b64encode(img.tobytes()).decode(),
            "image_shape": list(img.shape), **kw}


def _json_close(got, want, path=""):
    """Floats within TOL, everything else (ints, strings, RLE) equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL["atol"] + TOL["rtol"] * abs(want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("path,body", [
    ("/v1/detect", dict(classes=CLASSES, **DETECT)),
    ("/v1/ground", dict(expression=EXPRESSION, with_mask=True)),
    ("/v1/pose", POSE),
])
def test_endpoints_match_the_jax_server(servers, path, body):
    _, (url, jurl, _) = servers
    code, got = _post(url + path, _img_req(IMAGE, **body))
    jcode, want = _post(jurl + path, _img_req(IMAGE, **body))
    assert code == jcode == 200, (got, want)
    _json_close(got, want)
    if path == "/v1/detect":
        assert len(got["masks"]) == body["topk"]
        m0 = trle.rle_decode(got["masks"][0]["counts"],
                             *got["masks"][0]["size"])
        assert m0.shape == IMAGE.shape[:2]


def test_endpoint_bad_requests_are_400(servers):
    _, (url, jurl, bare) = servers
    for u in (url, jurl):
        code, out = _post(u + "/v1/detect", _img_req(IMAGE))   # no classes
        assert code == 400 and "classes" in out["error"]
        code, out = _post(u + "/v1/detect", {"classes": ["x"]})  # no image
        assert code == 400 and "image_b64" in out["error"]
        code, out = _post(u + "/v1/ground", _img_req(IMAGE))
        assert code == 400 and "expression" in out["error"]
    code, out = _post(bare + "/v1/detect", _img_req(IMAGE, classes=["x"]))
    assert code == 400 and "perception" in out["error"]
    code, _ = _post(url + "/v1/nothing", {})
    assert code == 404


def test_perception_queue_full_is_503(servers):
    (srv, _, _), (url, _, _) = servers
    sem = srv.RequestHandlerClass.predictor_sem
    held = 0
    while sem.acquire(blocking=False):
        held += 1
    try:
        code, out = _post(url + "/v1/pose", _img_req(IMAGE, **POSE))
    finally:
        for _ in range(held):
            sem.release()
    assert held == 32
    assert code == 503 and out["retry"] is True
    code, _ = _post(url + "/v1/pose", _img_req(IMAGE, **POSE))
    assert code == 200
