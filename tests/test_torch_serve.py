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
* the HTTP front answers /healthz, /v1/generate and /metrics;
* /v1/generate refuses sampling, sessions, streams and region prompts
  with the JAX server's status and words, and reads temperature 0,
  top_p and seed as the JAX server does;
* a closed `ChatService` raises instead of leaving a caller waiting.
"""

import base64
import dataclasses
import json
import threading
import time
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
from visionllm_tpu.ops.rle import rle_encode as jax_rle_encode
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu.serve import make_server as jax_make_server
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.data import mm_utils as tmm
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.serve import ChatService, _Request, make_server
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
def weights():
    """One flax param tree loaded into the port's core, the JAX and the
    port's configs, and one tokenizer every service of the module shares
    (so a word gets the same id in both)."""
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
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    return jcfg, params, cfg, core, SimpleTokenizer()


def _service_pair(weights, **kw):
    """The JAX and the port's ChatService over the same weights."""
    jcfg, params, cfg, core, tok = weights
    size = jcfg.vis_encoder.image_size
    return (JaxChatService(jcfg, params, tok, image_size=size,
                           batch_window_ms=1.0, dtype=jnp.float32, **kw),
            ChatService(cfg, core, tok, image_size=size, device="cpu",
                        batch_window_ms=1.0, **kw))


@pytest.fixture(scope="module")
def services(weights):
    jsvc, tsvc = _service_pair(weights, **SERVE)
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


NOT_PORTED = ("spec_k", "int8", "kv_int8", "regions")
# the refusals that remain, as (LLM config fields, service arguments)
REFUSED_MODES = {"spec_k": ({}, dict(spec_k=2, max_batch=2)),
                 "int8": ({"kv_quant": "int8"},
                          dict(slots=2, prefill_chunk=16)),
                 "kv_int8": ({"kv_quant": "int8"}, dict(slots=2, sessions=2))}


@pytest.mark.parametrize("mode", NOT_PORTED)
def test_modes_not_ported_raise(services, mode):
    """The modes JAX refuses raise its ValueError in its words:
    speculative decoding with max_batch > 1, an int8 KV cache with
    chunked prefill and with sessions; a config without a region encoder
    refuses regions."""
    jsvc, tsvc = services
    if mode in REFUSED_MODES:
        llm, kw = REFUSED_MODES[mode]
        jcfg = dataclasses.replace(jsvc.cfg, llm=dataclasses.replace(
            jsvc.cfg.llm, **llm))
        cfg = dataclasses.replace(tsvc.cfg, llm=dataclasses.replace(
            tsvc.cfg.llm, **llm))
        with pytest.raises(ValueError) as want:
            JaxChatService(jcfg, None, tsvc.tokenizer, **kw)
        with pytest.raises(ValueError) as got:
            ChatService(cfg, tsvc.core, tsvc.tokenizer, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    else:
        with pytest.raises(ValueError) as want:
            jsvc.generate("what is <regions>", regions=[[0, 0, 4, 4]])
        with pytest.raises(ValueError) as got:
            tsvc.generate("what is <regions>", regions=[[0, 0, 4, 4]])
        assert str(got.value) == str(want.value)
        assert "has no RegionEncoder" in str(got.value)


@pytest.fixture(scope="module")
def servers(services):
    """The JAX and the port's HTTP servers over the tiny services."""
    jsvc, tsvc = services
    srvs = [jax_make_server(jsvc, port=0), make_server(tsvc, port=0)]
    for srv in srvs:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield [f"http://127.0.0.1:{srv.server_address[1]}" for srv in srvs]
    for srv in srvs:
        srv.shutdown()
        srv.server_close()


_MASK = np.zeros((4, 4), np.uint8)
_MASK[1:3, :2] = 1

# bodies a greedy dispatch-loop server without sessions or a region
# encoder refuses; the last two check that the checks run in JAX's order
REFUSED = {
    "sampling": {"temperature": 0.7},
    "stream": {"stream": True},
    "session": {"session": "s1"},
    "region_boxes": {"region_boxes": [[0, 0, 4, 4]]},
    "region_masks": {"region_masks": [jax_rle_encode(_MASK)]},
    "stream_and_sampling": {"stream": True, "temperature": 0.7},
    "sampling_and_session": {"temperature": 0.7, "session": "s1"},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_generate_refuses_like_jax(servers, name):
    body = {"prompt": "hello there", **REFUSED[name]}
    (jcode, jbody), (tcode, tbody) = [_post(url + "/v1/generate", body)
                                      for url in servers]
    assert jcode == 400, jbody
    assert (tcode, tbody["error"]) == (jcode, jbody["error"])


def test_generate_greedy_fields_like_jax(servers):
    body = {"prompt": "hello there", "temperature": 0, "top_p": 0.9,
            "seed": 3}
    (jcode, jbody), (tcode, tbody) = [_post(url + "/v1/generate", body)
                                      for url in servers]
    assert (jcode, tcode) == (200, 200), (jbody, tbody)
    assert tbody["ids"] == jbody["ids"]
    assert tbody["text"] == jbody["text"]


def _in_thread(fn, timeout=10.0):
    """Run fn in a thread joined with `timeout`; returns (result or
    raised exception, seconds). Fails if the thread is still alive."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:      # noqa: BLE001 - handed back
            box["out"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"still waiting after {timeout} s"
    return box["out"], time.perf_counter() - t0


def _fresh_service(tsvc):
    return ChatService(tsvc.cfg, tsvc.core, tsvc.tokenizer,
                       image_size=tsvc.image_size, device="cpu",
                       batch_window_ms=1.0, **SERVE)


def test_generate_after_close_raises(services):
    svc = _fresh_service(services[1])
    _in_thread(svc.close)
    err, secs = _in_thread(lambda: svc.generate("hello there"))
    assert isinstance(err, RuntimeError), err
    assert str(err) == "ChatService is closed"
    assert secs < 5.0


def test_request_behind_close_sentinel_gets_error(services):
    """A request that sits behind the close() sentinel (queued by hand
    here: `_submit` refuses once closed) is failed, not left waiting;
    the request in flight at close() still gets its answer."""
    svc = _fresh_service(services[1])
    entered, gate = threading.Event(), threading.Event()
    run = svc._run

    def gated_run(batch):
        entered.set()
        gate.wait(10)
        return run(batch)

    svc._run = gated_run
    box = {}
    first = threading.Thread(
        target=lambda: box.update(out=svc.generate("hello there")),
        daemon=True)
    first.start()
    assert entered.wait(10), "the dispatcher took no request"
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    deadline = time.perf_counter() + 10
    while svc._queue.qsize() == 0:      # wait for the sentinel
        assert time.perf_counter() < deadline, "close() put no sentinel"
        time.sleep(0.01)
    behind = _Request(np.asarray([1, 5, 6], np.int32), None)
    svc._queue.put_nowait(behind)
    gate.set()
    assert behind.event.wait(10), "request behind the sentinel still waits"
    assert isinstance(behind.error, RuntimeError)
    first.join(10)
    closer.join(10)
    assert not first.is_alive() and not closer.is_alive()
    assert box["out"]["num_tokens"] >= 1


# ---------------------------------------------------------------------------
# continuous batching, chunked prefill, decode spans, sampling and streams
# ---------------------------------------------------------------------------

SLOT = dict(max_new_tokens=8, max_prompt=64)
# the slot modes each held against the JAX server; "span" has
# (max_new_tokens - 1) % span != 0, which without sessions changes nothing
MODES = {"slots": dict(slots=2), "chunked": dict(slots=2, prefill_chunk=32),
         "span": dict(slots=2, decode_span=3),
         "sampling": dict(slots=2, sampling=True),
         "dispatch_sampling": dict(sampling=True)}


@pytest.fixture(scope="module")
def mode_servers(weights):
    """mode -> (JAX url, port url, JAX service, port service), built on
    first use and shut down at the end of the module."""
    built, stop = {}, []

    def get(mode):
        if mode not in built:
            jsvc, tsvc = _service_pair(weights, **SLOT, **MODES[mode])
            urls = []
            for svc, make in ((jsvc, jax_make_server), (tsvc, make_server)):
                srv = make(svc, port=0)
                threading.Thread(target=srv.serve_forever,
                                 daemon=True).start()
                urls.append(f"http://127.0.0.1:{srv.server_address[1]}")
                stop.append((srv, svc))
            built[mode] = (*urls, jsvc, tsvc)
        return built[mode]

    yield get
    for srv, svc in stop:
        srv.shutdown()
        srv.server_close()
        svc.close()


def _body(name):
    req = REQUESTS[name]
    body = {"prompt": req["prompt"], "logprobs": True}
    if "image" in req:
        body.update(image_b64=base64.b64encode(req["image"].tobytes()
                                               ).decode(),
                    image_shape=list(req["image"].shape))
    if "history" in req:
        body["history"] = req["history"]
    return body


def _same_body(got, want):
    assert (got["ids"], got["text"], got["num_tokens"]) == \
        (want["ids"], want["text"], want["num_tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=2e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_slot_modes_match_jax_over_http(mode_servers, mode):
    """Three requests posted at once to the port's server (admissions
    land mid-decode) get the JAX server's bodies for them, at
    temperature 0 on the sampling servers."""
    jurl, turl, _, _ = mode_servers(mode)
    names = sorted(REQUESTS)
    want = [_post(jurl + "/v1/generate", _body(n)) for n in names]
    got = [None] * len(names)

    def fire(i):
        got[i] = _post(turl + "/v1/generate", _body(names[i]))

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for (wcode, w), (gcode, g) in zip(want, got):
        assert (gcode, wcode) == (200, 200), (g, w)
        _same_body(g, w)


@pytest.mark.parametrize("mode", ["sampling", "dispatch_sampling"])
def test_sampled_requests_are_seeded(mode_servers, mode):
    """Temperature > 0 on a sampling server: the same seed twice gives
    the same tokens; temperature 0 with a seed and a tiny top_p give the
    greedy ones (the port cannot draw JAX's bits)."""
    _, turl, _, tsvc = mode_servers(mode)
    hot = {"prompt": "hello there", "temperature": 0.7, "top_p": 0.9,
           "seed": 3}
    a, b = (_post(turl + "/v1/generate", hot) for _ in range(2))
    assert a[0] == b[0] == 200 and a[1]["ids"] == b[1]["ids"]
    greedy = tsvc.generate("hello there")["ids"]
    for extra in ({"temperature": 0.0, "seed": 5},
                  {"temperature": 2.0, "top_p": 1e-6}):
        code, body = _post(turl + "/v1/generate",
                           {"prompt": "hello there", **extra})
        assert code == 200 and body["ids"] == greedy


def _sse(url, body):
    """POST with "stream": true; returns (content type, payloads)."""
    req = urllib.request.Request(
        url + "/v1/generate", json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        frames = [ln.decode().strip() for ln in r]
    return ctype, [f[len("data: "):] for f in frames if f.startswith("data: ")]


@pytest.mark.parametrize("mode", ["slots", "span"])
def test_sse_frames_match_jax(mode_servers, mode):
    jurl, turl, _, _ = mode_servers(mode)
    body = _body("image")
    body.pop("logprobs")
    jtype, want = _sse(jurl, body)
    ttype, got = _sse(turl, body)
    assert ttype == jtype == "text/event-stream"
    assert got == want
    assert got[-1] == "[DONE]" and len(got) >= 2
    deltas = [json.loads(f)["delta"] for f in got[:-1]]
    assert "".join(deltas).strip() == _post(turl + "/v1/generate",
                                            body)[1]["text"]


STREAM_400 = {"sampling": {"temperature": 1.5},
              "history": {"history": [{"role": "assistant",
                                       "content": "y"}]},
              "session": {"session": "s1"}}


@pytest.mark.parametrize("name", sorted(STREAM_400))
def test_stream_validation_is_a_400_like_jax(mode_servers, name):
    jurl, turl, _, _ = mode_servers("slots")
    body = {"prompt": "x", "stream": True, **STREAM_400[name]}
    (jcode, jbody), (tcode, tbody) = [_post(u + "/v1/generate", body)
                                      for u in (jurl, turl)]
    assert jcode == 400, jbody
    assert (tcode, tbody["error"]) == (jcode, jbody["error"])


CONFLICTS = {
    "spec_and_batch": dict(spec_k=2, max_batch=2),
    "slots_and_batch": dict(slots=2, max_batch=2),
    "slots_and_spec": dict(slots=2, spec_k=2),
    "sampling_and_spec": dict(sampling=True, spec_k=2),
    "sampling_and_chunk": dict(slots=2, sampling=True, prefill_chunk=16),
    "sessions_without_slots": dict(sessions=2),
    "sessions_and_sampling": dict(slots=2, sessions=2, sampling=True),
}


@pytest.mark.parametrize("name", sorted(CONFLICTS))
def test_constructor_conflicts_like_jax(weights, name):
    jcfg, _, cfg, core, tok = weights
    kw = CONFLICTS[name]
    with pytest.raises(ValueError) as want:
        JaxChatService(jcfg, None, tok, dtype=jnp.float32, **kw)
    with pytest.raises(ValueError) as got:
        ChatService(cfg, core, tok, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["dispatch", "slots"])
def test_metrics_keys_like_jax(services, mode_servers, mode):
    """Slot mode has the JAX service's keys; micro-batching adds the
    port's `batches_total` and `steps_total`."""
    if mode == "slots":
        jsvc, tsvc = mode_servers("slots")[2:]
    else:
        jsvc, tsvc = services
    jsvc.generate("hello there")
    tsvc.generate("hello there")
    got, want = tsvc.metrics(), jsvc.metrics()
    extra = set() if mode == "slots" else {"batches_total", "steps_total"}
    assert set(got) == set(want) | extra
    assert got["mode"] == want["mode"]
    if mode == "slots":
        assert 0 < got["slot_occupancy"] <= 1


def test_close_with_live_slots_fails_every_waiting_call(weights):
    """close() while a slot decodes, a request waits in the backlog and a
    stream is open: every waiting call raises RuntimeError, each joined
    within 10 s."""
    jcfg, _, cfg, core, tok = weights
    svc = ChatService(cfg, core, tok, image_size=jcfg.vis_encoder.image_size,
                      device="cpu", slots=1, **SLOT)
    entered, gate = threading.Event(), threading.Event()
    step = svc._slot_step

    def gated_step(*a):
        entered.set()
        gate.wait(10)
        return step(*a)

    svc._slot_step = gated_step
    results = {}

    def run(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:      # noqa: BLE001 - handed back
            results[name] = e

    stream = svc.generate_stream("stream this")
    calls = {"decoding": lambda: list(stream),
             "backlog": lambda: svc.generate("hello there"),
             "backlog2": lambda: svc.generate("and another one")}
    threads = {n: threading.Thread(target=run, args=(n, f), daemon=True)
               for n, f in calls.items()}
    threads["decoding"].start()
    assert entered.wait(10), "no slot decoded"
    for n in ("backlog", "backlog2"):
        threads[n].start()
    deadline = time.perf_counter() + 10
    while svc._queue.qsize() < 2:
        assert time.perf_counter() < deadline, "requests not queued"
        time.sleep(0.01)
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    while svc._queue.qsize() < 3:       # the sentinel behind them
        assert time.perf_counter() < deadline, "close() put no sentinel"
        time.sleep(0.01)
    gate.set()
    for th in [*threads.values(), closer]:
        th.join(10)
        assert not th.is_alive(), "a call still waits after close()"
    for name in calls:
        err = results[name]
        assert isinstance(err, RuntimeError), (name, err)
        assert str(err) == "ChatService is closed"


def test_failed_admission_fails_its_request(weights):
    """A request whose admission raises gets the error (the JAX slot loop
    pops it from the backlog before its failure handler runs, and leaves
    it waiting); the service then answers the next request."""
    jcfg, _, cfg, core, tok = weights
    svc = ChatService(cfg, core, tok, image_size=jcfg.vis_encoder.image_size,
                      device="cpu", slots=2, **SLOT)
    prefill = svc._slot_prefill

    def broken(*a, **kw):
        svc._slot_prefill = prefill
        raise RuntimeError("prefill failed")

    svc._slot_prefill = broken
    try:
        err, _ = _in_thread(lambda: svc.generate("hello there"))
        assert isinstance(err, RuntimeError) and str(err) == "prefill failed"
        out, _ = _in_thread(lambda: svc.generate("hello there"))
        assert out["num_tokens"] >= 1
        assert svc.metrics()["errors_total"] == 1
    finally:
        svc.close()
