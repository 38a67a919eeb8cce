"""The port's chat serving (`visionllm_tpu_torch/serve.py` and the prompt
plumbing it uses) against the JAX package on the CPU, in fp32, at
`tiny_test_config` dims, with the same flax params and the word-level
`SimpleTokenizer`:

* the port's `ChatService` answers image, text-only and multi-turn
  history requests with the same ids and text as the JAX `ChatService`;
* concurrent requests coalesced into one micro-batch get their single
  answers;
* conversation prompts and `tokenizer_image_token` are identical, and
  `clip_preprocess` is within one uint8 level of the JAX one (in fact
  equal: both run Pillow's fixed-point bicubic);
* the HTTP front answers /healthz, /v1/generate and /metrics.
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
from visionllm_tpu.data import mm_utils as jmm
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.data import mm_utils as tmm
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.serve import ChatService, make_server
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

SERVE = dict(max_new_tokens=8, max_prompt=64, max_batch=3)


def _img(seed, shape):
    return np.random.RandomState(seed).randint(0, 255, shape, np.uint8)


REQUESTS = {
    "image": dict(prompt="describe the image", image=_img(0, (64, 48, 3))),
    "text_only": dict(prompt="hello there"),
    "history": dict(prompt="and then what", image=_img(1, (40, 56, 3)),
                    history=["what is this", "a cat",
                             {"role": "user", "content": "where is it"},
                             {"role": "assistant", "content": "on a mat"}]),
}


@pytest.fixture(scope="module")
def services():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    size = jcfg.vis_encoder.image_size
    jtid = JaxTid.synthetic()
    ids = jnp.asarray([[1] + [jtid.imp] * jcfg.vis_encoder.num_patches
                       + [5, 6]], jnp.int32)
    params = jax.jit(lambda r: JaxCore(jcfg, dtype=jnp.float32).init(
        r, ids, jnp.zeros((1, size, size, 3)), jtid))(
            jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)
    tok = SimpleTokenizer()
    jsvc = JaxChatService(jcfg, params, tok, image_size=size,
                          batch_window_ms=1.0, dtype=jnp.float32, **SERVE)
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    tsvc = ChatService(cfg, core, tok, image_size=size, device="cpu",
                       batch_window_ms=1.0, **SERVE)
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_chat_service_matches_jax(services, name):
    jsvc, tsvc = services
    req = REQUESTS[name]
    want = jsvc.generate(**req)
    got = tsvc.generate(**req)
    assert got["num_tokens"] >= 1
    assert got["ids"] == want["ids"]
    assert got["text"] == want["text"]


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_prompt_assembly_matches_jax(services, name):
    jsvc, tsvc = services
    req = REQUESTS[name]
    jids, jimg, jconv = jsvc._encode(req["prompt"], req.get("image"),
                                     req.get("history"))
    tids, timg, tconv = tsvc._encode(req["prompt"], req.get("image"),
                                     req.get("history"))
    assert tconv.get_prompt() == jconv.get_prompt()
    np.testing.assert_array_equal(tids, jids)
    raw = tmm.tokenizer_image_token(tconv.get_prompt(), tsvc.tokenizer)
    np.testing.assert_array_equal(
        raw, jmm.tokenizer_image_token(jconv.get_prompt(), tsvc.tokenizer))
    if jimg is not None:
        # one uint8 level in normalized units is 1 / 255 / CLIP_STD
        np.testing.assert_array_less(
            np.abs(timg - jimg) * tmm.CLIP_STD * 255, 1.0 + 1e-3)


def test_concurrent_requests_equal_singles(services):
    _, tsvc = services
    batched = ChatService(tsvc.cfg, tsvc.core, tsvc.tokenizer,
                          image_size=tsvc.image_size, device="cpu",
                          batch_window_ms=2000.0, **SERVE)
    try:
        reqs = [REQUESTS[n] for n in sorted(REQUESTS)]
        solo = [tsvc.generate(**r) for r in reqs]
        calls0 = batched.stats["batches_total"]
        results = [None] * len(reqs)

        def fire(i):
            results[i] = batched.generate(**reqs[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert batched.stats["batches_total"] - calls0 == 1
        for s, r in zip(solo, results):
            assert r is not None and r["ids"] == s["ids"]
    finally:
        batched.close()


def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_front(services):
    _, tsvc = services
    srv = make_server(tsvc, port=0, model_name="tiny-port")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and health["model"] == "tiny-port"
        img = REQUESTS["image"]["image"]
        code, body = _post(url + "/v1/generate", {
            "prompt": "describe the image",
            "image_b64": base64.b64encode(img.tobytes()).decode(),
            "image_shape": list(img.shape)})
        assert code == 200, body
        assert body["ids"] == tsvc.generate(**REQUESTS["image"])["ids"]
        code, body = _post(url + "/v1/generate", {"image_b64": "xx"})
        assert code == 400 and "error" in body
        code, _ = _post(url + "/v1/nope", {"prompt": "x"})
        assert code == 404
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        assert metrics["requests_total"] >= 2
        assert metrics["steps_total"] >= metrics["batches_total"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_modes_not_ported_raise(services):
    _, tsvc = services
    for kw in (dict(spec_k=2), dict(slots=2), dict(sampling=True),
               dict(sessions=2)):
        with pytest.raises(NotImplementedError):
            ChatService(tsvc.cfg, tsvc.core, tsvc.tokenizer, device="cpu",
                        **kw)
    with pytest.raises(NotImplementedError):
        tsvc.generate("what is <regions>", regions=[[0, 0, 4, 4]])
