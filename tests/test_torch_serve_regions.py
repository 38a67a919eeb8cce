"""Region-prompted serving in the port (`ChatService` with `regions`)
against the JAX package's service on the CPU, in fp32, at
`tiny_test_config` dims with the region encoder on, one flax param tree
loaded into both, and one `RoundTripTokenizer` shared by every service
(so a word gets the same id in all of them).

The seven cases of JAX's `tests/test_serve_regions.py`, on the port:
plain mode equals a hand-built call of its generate loop, a region
changes the conditioning, slot mode equals plain mode, a mask region
equals its box region, a session turn reuses its KV only with the same
regions, the errors, and HTTP boxes and RLE masks. Then the port against
JAX: prompt assembly and region masks identical, the answers' ids
identical in B1 dispatch and in slot mode; the port's chunked
admission, speculative service and SSE stream against its plain answer.
Tokens and ids identical throughout.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.ops.rle import rle_encode
from visionllm_tpu_torch.serve import ChatService, make_server
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import RoundTripTokenizer

JCFG = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                       use_ip2p=False, use_region_encoder=True)
CFG = tiny_test_config(use_gdino=False, gdino=None, use_region_encoder=True)
SIZE = CFG.vis_encoder.image_size
IMG = np.random.RandomState(5).randint(0, 255, (40, 56, 3), np.uint8)
BOX = [8.0, 6.0, 30.0, 28.0]
SMALL_BOX = [0.0, 0.0, 4.0, 4.0]
SERVE = dict(max_new_tokens=5, max_prompt=160, max_regions=3)


def _box_mask():
    m = np.zeros(IMG.shape[:2], np.float32)
    m[6:28, 8:30] = 1
    return m


def _blob_mask():
    m = np.zeros(IMG.shape[:2], np.float32)
    m[25:38, 2:15] = 1
    m[30:34, 40:52] = 1
    return m


@pytest.fixture(scope="module")
def setup():
    """The JAX and the port's B1 dispatch services over one param tree,
    the port's slot, chunked-slot and speculative services over its
    core, and the JAX slot service."""
    torch.set_num_threads(1)
    tok = RoundTripTokenizer()
    jsvc = JaxChatService(JCFG, None, tok, image_size=SIZE,
                          dtype=jnp.float32, **SERVE)
    img_len = JCFG.vis_encoder.num_patches
    ids = jnp.asarray([[1] + [jsvc.tid.imp] * img_len + [jsvc.tid.reg, 5]],
                      jnp.int32)
    params = jax.jit(lambda r: JaxCore(JCFG, dtype=jnp.float32).init(
        r, ids, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), jsvc.tid,
        regions=jnp.ones((1, 1, SIZE, SIZE), jnp.float32)))(
            jax.random.PRNGKey(3))["params"]
    jsvc.params = params = jax.tree.map(np.asarray, params)
    jslots = JaxChatService(JCFG, None, tok, image_size=SIZE, slots=2,
                            sessions=2, session_chunk=8, dtype=jnp.float32,
                            **SERVE)
    jslots.params = params
    core = build_core(CFG, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)

    def port(**kw):
        return ChatService(CFG, core, tok, device="cpu", **SERVE, **kw)

    svcs = {"jax": jsvc, "jax_slots": jslots, "plain": port(),
            "slots": port(slots=2, sessions=2, session_chunk=8),
            "chunked": port(slots=2, prefill_chunk=32),
            "spec": port(spec_k=3)}
    yield svcs
    for s in svcs.values():
        s.close()


# ---------------------------------------------------------------------------
# JAX's test_serve_regions.py, on the port
# ---------------------------------------------------------------------------

def test_plain_matches_direct_generate(setup):
    plain = setup["plain"]
    out = plain.generate("What is <regions>?", image=IMG, regions=[BOX])
    regs = plain._region_masks([BOX], IMG)
    ids, img, conv = plain._encode("What is <regions>?", IMG, num_regions=1)
    L = plain.max_prompt
    pid = np.zeros((1, L), np.int64)
    mask = np.zeros((1, L), bool)
    pid[0, L - len(ids):] = ids
    mask[0, L - len(ids):] = True
    ref = plain.generate_fn(
        torch.from_numpy(pid), torch.from_numpy(img[None, None]),
        attn_mask=torch.from_numpy(mask), live=torch.ones(1, dtype=bool),
        regions=torch.from_numpy(regs[None]))
    n = int(ref["num_generated"])
    assert out["ids"] == ref["out_tokens"][0, :n].tolist()[:len(out["ids"])]
    want = plain.tokenizer.decode(ref["out_tokens"][0, :n].numpy(),
                                  skip_special_tokens=True)
    assert out["text"] == want.split(conv.sep2 or conv.sep)[0].strip()


def test_region_changes_conditioning(setup):
    plain = setup["plain"]
    a = plain.generate("Describe <regions>.", image=IMG, regions=[BOX],
                       logprobs=True)
    b = plain.generate("Describe <regions>.", image=IMG,
                       regions=[SMALL_BOX], logprobs=True)
    assert a["num_tokens"] > 0 and b["num_tokens"] > 0
    assert a["logprobs"][0] != b["logprobs"][0]


@pytest.mark.parametrize("mode", ["slots", "chunked", "spec"])
def test_other_modes_match_plain(setup, mode):
    regions = [BOX, _blob_mask()]
    want = setup["plain"].generate("What is <regions>?", image=IMG,
                                   regions=regions)
    got = setup[mode].generate("What is <regions>?", image=IMG,
                               regions=regions)
    assert got["ids"] == want["ids"]
    assert got["text"] == want["text"]


def test_mask_region_equals_box_region(setup):
    plain = setup["plain"]
    np.testing.assert_array_equal(plain._region_masks([BOX], IMG),
                                  plain._region_masks([_box_mask()], IMG))
    a = plain.generate("What is <regions>?", image=IMG, regions=[BOX])
    b = plain.generate("What is <regions>?", image=IMG,
                       regions=[_box_mask()])
    assert a["ids"] == b["ids"]


@pytest.mark.parametrize("follow_up", ["same", "changed"])
def test_session_region_fingerprint(setup, follow_up):
    """The second turn extends the first turn's parked KV only with the
    same regions: its ids start with the cached prefix either way (the
    <regions> placeholder expands to the same ids for any masks). The
    JAX slot service answers the same turns alike."""
    first = "Look at <regions> closely."
    sid = "rg_" + follow_up
    regs = [BOX] if follow_up == "same" else [SMALL_BOX]
    turns, hist = {}, {}
    for name in ("slots", "jax_slots"):
        svc = setup[name]
        r1 = svc.generate(first, image=IMG, regions=[BOX], session=sid)
        hist[name] = [first, r1["text"]]
        turns[name] = svc.generate("tell me more", image=IMG, regions=regs,
                                   history=hist[name], session=sid)
    got = turns["slots"]
    want = setup["slots"].generate("tell me more", image=IMG, regions=regs,
                                   history=hist["slots"])
    assert got["session_reused"] is (follow_up == "same")
    assert got["ids"] == want["ids"]
    assert (got["session_reused"], got["ids"]) == (
        turns["jax_slots"]["session_reused"], turns["jax_slots"]["ids"])


ERRORS = {
    "no_image": (dict(prompt="What is <regions>?", regions=[BOX]), "image"),
    "no_placeholder": (dict(prompt="no placeholder", image=IMG,
                            regions=[BOX]), "<regions>"),
    "two_placeholders": (dict(prompt="<regions> and <regions>", image=IMG,
                              regions=[BOX]), "<regions>"),
    "too_many": (dict(prompt="What is <regions>?", image=IMG,
                      regions=[BOX] * 4), "max_regions"),
    "bad_shape": (dict(prompt="What is <regions>?", image=IMG,
                       regions=[np.zeros((3, 3), np.float32)]), "box"),
    "none": (dict(prompt="What is <regions>?", image=IMG, regions=[]),
             "max_regions"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_region_errors_like_jax(setup, name):
    kw, words = ERRORS[name]
    with pytest.raises(ValueError) as want:
        setup["jax"].generate(**kw)
    with pytest.raises(ValueError) as got:
        setup["plain"].generate(**kw)
    assert str(got.value) == str(want.value)
    assert words in str(got.value)


@pytest.mark.parametrize("which", ["no_encoder", "micro_batching"])
def test_service_refusals_like_jax(setup, which):
    tok = setup["plain"].tokenizer
    if which == "no_encoder":
        cfgs = (jax_tiny_config(use_gdino=False, use_unipose=False,
                                use_sd=False, use_ip2p=False,
                                use_region_encoder=False),
                tiny_test_config(use_gdino=False, gdino=None))
        kw = {}
    else:
        cfgs, kw = (JCFG, CFG), dict(max_batch=2)
    core = setup["plain"].core if which != "no_encoder" else build_core(
        cfgs[1], device="cpu", dtype=torch.float32)
    jsvc = JaxChatService(cfgs[0], None, tok, image_size=SIZE,
                          max_new_tokens=2, max_prompt=64,
                          dtype=jnp.float32, **kw)
    tsvc = ChatService(cfgs[1], core, tok, max_new_tokens=2, max_prompt=64,
                       device="cpu", **kw)
    try:
        with pytest.raises(ValueError) as want:
            jsvc.generate("What is <regions>?", image=IMG, regions=[BOX])
        with pytest.raises(ValueError) as got:
            tsvc.generate("What is <regions>?", image=IMG, regions=[BOX])
        assert str(got.value) == str(want.value)
        assert ("RegionEncoder" if which == "no_encoder"
                else "micro-batching") in str(got.value)
    finally:
        jsvc.close()
        tsvc.close()


def _post(url, obj):
    req = urllib.request.Request(
        url, json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_region_request(setup):
    svc = setup["slots"]
    srv = make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/generate"
    try:
        body = {"prompt": "What is <regions>?",
                "image_b64": base64.b64encode(IMG.tobytes()).decode(),
                "image_shape": list(IMG.shape)}
        code, out = _post(url, {**body, "region_boxes": [BOX]})
        assert code == 200, out
        want = svc.generate("What is <regions>?", image=IMG, regions=[BOX])
        assert out["ids"] == want["ids"]
        m = _box_mask().astype(np.uint8)
        code, out2 = _post(url, {**body, "region_masks": [rle_encode(m)]})
        assert code == 200, out2
        assert out2["ids"] == out["ids"]
        # two boxes and an RLE mask: boxes first, then masks
        blob = _blob_mask()
        code, out3 = _post(url, {
            **body, "region_boxes": [BOX, SMALL_BOX],
            "region_masks": [rle_encode(blob.astype(np.uint8))]})
        assert code == 200, out3
        want3 = svc.generate("What is <regions>?", image=IMG,
                             regions=[BOX, SMALL_BOX, blob])
        assert out3["ids"] == want3["ids"]
        code, err = _post(url, {"prompt": "What is <regions>?",
                                "region_boxes": [BOX]})
        assert code == 400 and "image" in err["error"]
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# the port against the JAX service
# ---------------------------------------------------------------------------

REQUESTS = {
    "one_box": dict(prompt="What is <regions>?", regions=[BOX]),
    "box_and_mask": dict(prompt="Compare <regions> please.",
                         regions=[SMALL_BOX, _blob_mask()]),
    "in_history": dict(prompt="and its colour?",
                       history=["What is <regions>?", "a t7 box"],
                       regions=[BOX, SMALL_BOX, _box_mask()]),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_prompt_and_masks_match_jax(setup, name):
    req = REQUESTS[name]
    jsvc, tsvc = setup["jax"], setup["plain"]
    n = len(req["regions"])
    jids, jimg, jconv = jsvc._encode(req["prompt"], IMG, req.get("history"),
                                     num_regions=n)
    tids, timg, tconv = tsvc._encode(req["prompt"], IMG, req.get("history"),
                                     num_regions=n)
    assert tconv.get_prompt() == jconv.get_prompt()
    np.testing.assert_array_equal(tids, jids)
    assert int((tids == tsvc.tid.reg).sum()) == n
    np.testing.assert_array_equal(tsvc._region_masks(req["regions"], IMG),
                                  jsvc._region_masks(req["regions"], IMG))


@pytest.mark.parametrize("mode", ["plain", "slots"])
@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_answers_match_jax(setup, name, mode):
    req = REQUESTS[name]
    jsvc = setup["jax" if mode == "plain" else "jax_slots"]
    want = jsvc.generate(image=IMG, **req)
    got = setup[mode].generate(image=IMG, **req)
    assert got["num_tokens"] >= 1
    assert got["ids"] == want["ids"]
    assert got["text"] == want["text"]


def test_stream_with_regions_equals_blocking(setup):
    svc = setup["slots"]
    want = svc.generate("What is <regions>?", image=IMG, regions=[BOX])
    deltas = list(svc.generate_stream("What is <regions>?", image=IMG,
                                      regions=[BOX]))
    assert "".join(deltas).strip() == want["text"]
