"""The port's speculative decoding (`build_speculative_generate_fn`,
`ChatService(spec_k=...)`) against the JAX package on the CPU, in fp32,
at `tiny_test_config` dims, on the same flax params:

* k 1, 3 and 7; the [DET] and [GEN] countdowns; three random models; a
  repetitive prompt; a left-padded prompt; an int8 KV cache. Tokens,
  `num_generated` and `num_windows` must be identical to JAX's, hidden
  states and logprobs within 1e-4, and the tokens those of the port's
  plain greedy loop;
* B > 1 raises JAX's ValueError;
* `ChatService(spec_k)` answers like JAX's, directly and over HTTP, with
  the same `metrics()` keys, and switches to the plain loop below break
  even with JAX's stderr line (thresholds lowered on both instances).
"""

import base64
import dataclasses
import functools
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.generation import (
    build_speculative_generate_fn as jax_spec_fn)
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu.serve import make_server as jax_make_server
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.generation import (build_generate_fn,
                                            build_speculative_generate_fn)
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.serve import ChatService, make_server
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

TOL = 1e-4
MAX_NEW, MAX_LEN = 16, 128
TID, JTID = SpecialTokenIds.synthetic(), JaxTid.synthetic()


def _cfgs(kv_quant=""):
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    return tuple(dataclasses.replace(c, llm=dataclasses.replace(
        c.llm, kv_quant=kv_quant)) for c in (jcfg, cfg))


def _port_core(cfg, params):
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    return core


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg, cfg = _cfgs()
    img_len = jcfg.vis_encoder.num_patches
    size = jcfg.vis_encoder.image_size
    ids = np.asarray([[1, 5, 6] + [TID.imp] * img_len + [7, 8, 9, 7, 8]],
                     np.int32)
    imgs = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    init = jax.jit(lambda r: jcore.init(r, jnp.asarray(ids),
                                        jnp.asarray(imgs), JTID)["params"])

    @functools.cache
    def weights(seed):
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
        return params, _port_core(cfg, params)

    return jcore, weights, ids, imgs


@functools.cache
def _jax_spec(jcore, k, max_new=MAX_NEW, max_len=MAX_LEN):
    return jax_spec_fn(jcore, JTID, max_new_tokens=max_new, max_len=max_len,
                       k_draft=k)


def _run_both(jcore, params, core, ids, imgs, k, first=None, mask=None,
              max_new=MAX_NEW, max_len=MAX_LEN):
    want = _jax_spec(jcore, k, max_new, max_len)(
        params, jnp.asarray(ids), jnp.asarray(imgs),
        None if first is None else jnp.asarray([first], jnp.int32),
        None, None if mask is None else jnp.asarray(mask))
    spec = build_speculative_generate_fn(core, TID, max_new_tokens=max_new,
                                         max_len=max_len, k_draft=k)
    got = spec(torch.from_numpy(ids).long(), torch.from_numpy(imgs),
               first_token=first,
               attn_mask=None if mask is None else torch.from_numpy(mask))
    return got, want


def _assert_same(got, want):
    assert got["num_generated"] == int(want["num_generated"])
    assert got["num_windows"] == int(want["num_windows"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    for key in ("out_hidden", "out_logprobs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)


def _plain_tokens(core, ids, imgs, first=None, mask=None, max_new=MAX_NEW,
                  max_len=MAX_LEN):
    out = build_generate_fn(core, TID, max_new_tokens=max_new,
                            max_len=max_len)(
        torch.from_numpy(ids).long(), torch.from_numpy(imgs),
        first_token=None if first is None else torch.tensor([first]),
        attn_mask=None if mask is None else torch.from_numpy(mask))
    n = min(out["num_generated"], max_new)
    return out["out_tokens"][0, :n].tolist()


def _check(setup, k, seed=0, first=None, ids=None, mask=None,
           max_new=MAX_NEW, max_len=MAX_LEN):
    jcore, weights, ids0, imgs = setup
    params, core = weights(seed)
    ids = ids0 if ids is None else ids
    got, want = _run_both(jcore, params, core, ids, imgs, k, first, mask,
                          max_new, max_len)
    _assert_same(got, want)
    n = got["num_generated"]
    assert got["out_tokens"][0, :n].tolist() == _plain_tokens(
        core, ids, imgs, first, mask, max_new, max_len)
    return got


@pytest.mark.parametrize("k", [1, 3, 7])
def test_spec_matches_jax(setup, k):
    _check(setup, k)


def test_det_countdown_matches_jax(setup):
    got = _check(setup, 3, first=TID.det)
    assert got["out_tokens"][0, :5].tolist() == [
        TID.det, TID.emb, TID.emb + 1, TID.emb + 2, TID.emb + 3]


def test_gen_countdown_matches_jax(setup):
    """[GEN]: num_embs_gen forced [EMB] rows, a run the window (k 4)
    does not divide."""
    n_gen = tiny_test_config().num_embs_gen
    got = _check(setup, 4, first=TID.gen, max_new=n_gen + 6, max_len=256)
    assert (got["out_tokens"][0, 1:1 + n_gen] == TID.emb).all()
    assert got["num_windows"] <= -(-n_gen // 5) + 5


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_random_models_match_jax(setup, seed):
    _check(setup, 5, seed=seed)


def test_repetitive_prompt_accepts_drafts(setup):
    jcore = setup[0]
    img_len = jcore.cfg.vis_encoder.num_patches
    phrase = [11, 12, 13, 14, 11, 12, 13, 14, 11, 12]
    ids = np.asarray([[1] + [TID.imp] * img_len + phrase], np.int32)
    got = _check(setup, 7, ids=ids)
    n_gen, n_win = got["num_generated"], got["num_windows"]
    assert 1 <= n_win <= max(n_gen - 1, 1), (n_win, n_gen)


def test_left_padded_matches_jax_and_unpadded(setup):
    _, weights, ids, imgs = setup
    pad = 6
    ids_p = np.concatenate([np.zeros((1, pad), np.int32), ids], 1)
    mask = np.concatenate([np.zeros((1, pad), bool),
                           np.ones_like(ids, bool)], 1)
    padded = _check(setup, 4, ids=ids_p, mask=mask)
    core = weights(0)[1]
    spec = build_speculative_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                                         max_len=MAX_LEN, k_draft=4)
    unpadded = spec(torch.from_numpy(ids).long(), torch.from_numpy(imgs))
    n = unpadded["num_generated"]
    assert padded["num_generated"] == n
    assert torch.equal(padded["out_tokens"], unpadded["out_tokens"])
    torch.testing.assert_close(padded["out_hidden"][:, :n - 1],
                               unpadded["out_hidden"][:, :n - 1],
                               atol=TOL, rtol=TOL)


def test_batch_rejected_like_jax(setup):
    jcore, weights, _, _ = setup
    with pytest.raises(ValueError) as want:
        _jax_spec(jcore, 7, 4, 64)(None, jnp.zeros((2, 8), jnp.int32), None)
    spec = build_speculative_generate_fn(weights(0)[1], TID,
                                         max_new_tokens=4, max_len=64)
    with pytest.raises(ValueError) as got:
        spec(torch.zeros(2, 8, dtype=torch.long), None)
    assert str(got.value) == str(want.value)


def test_int8_kv_spec_matches_jax_and_int8_plain(setup):
    """kv_quant="int8": the speculative windows attend the quantized
    buffer like the plain int8 decode does, token for token, and match
    JAX's int8 speculative run."""
    _, weights, ids, imgs = setup
    jcfg, cfg = _cfgs("int8")
    params = weights(0)[0]
    core = _port_core(cfg, params)
    got, want = _run_both(JaxCore(jcfg, dtype=jnp.float32), params, core,
                          ids, imgs, 3)
    _assert_same(got, want)
    assert got["cache"].k.dtype == torch.int8
    n = got["num_generated"]
    assert got["out_tokens"][0, :n].tolist() == _plain_tokens(core, ids, imgs)


# ---------------------------------------------------------------------------
# ChatService(spec_k)
# ---------------------------------------------------------------------------

SPEC_SERVE = dict(max_new_tokens=10, max_prompt=64, spec_k=3,
                  batch_window_ms=1.0)


def _img(seed, shape):
    return np.random.RandomState(seed).randint(0, 255, shape, np.uint8)


REQUESTS = {
    "image": dict(prompt="describe the image", image=_img(0, (64, 48, 3))),
    "text_only": dict(prompt="hello there hello there"),
    "history": dict(prompt="and then what", image=_img(1, (40, 56, 3)),
                    history=["what is this", "a cat"]),
}


@pytest.fixture(scope="module")
def services(setup):
    jcore, weights, _, _ = setup
    params, core = weights(0)
    tok = SimpleTokenizer()
    size = jcore.cfg.vis_encoder.image_size
    jsvc = JaxChatService(jcore.cfg, params, tok, image_size=size,
                          dtype=jnp.float32, **SPEC_SERVE)
    tsvc = ChatService(core.cfg, core, tok, image_size=size, device="cpu",
                       **SPEC_SERVE)
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_spec_service_matches_jax(services, name):
    jsvc, tsvc = services
    want = jsvc.generate(**REQUESTS[name], logprobs=True)
    got = tsvc.generate(**REQUESTS[name], logprobs=True)
    assert got["num_tokens"] >= 1
    assert (got["ids"], got["text"]) == (want["ids"], want["text"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=2e-4)


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_spec_service_over_http_matches_jax(services):
    jsvc, tsvc = services
    srvs = [jax_make_server(jsvc, port=0), make_server(tsvc, port=0)]
    for srv in srvs:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = REQUESTS["image"]
        body = {"prompt": req["prompt"], "logprobs": True,
                "image_b64": base64.b64encode(req["image"].tobytes()
                                              ).decode(),
                "image_shape": list(req["image"].shape)}
        want, got = (_post(f"http://127.0.0.1:{s.server_address[1]}"
                           "/v1/generate", body) for s in srvs)
        assert (got["ids"], got["text"], got["num_tokens"]) == \
            (want["ids"], want["text"], want["num_tokens"])
        np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                                   atol=2e-4)
    finally:
        for srv in srvs:
            srv.shutdown()
            srv.server_close()


def test_spec_metrics_like_jax(services):
    """Speculative mode has the JAX service's keys and acceptance counts,
    plus the port's `batches_total` and `steps_total`."""
    jsvc, tsvc = services
    jsvc.generate("hello there")
    tsvc.generate("hello there")
    got, want = tsvc.metrics(), jsvc.metrics()
    assert set(got) == set(want) | {"batches_total", "steps_total"}
    for key in ("mode", "spec_tokens_per_window", "spec_windows_total",
                "spec_disabled", "requests_total", "tokens_generated_total"):
        assert got[key] == want[key], key
    assert got["mode"] == "speculative" and got["spec_windows_total"] >= 1


def test_spec_auto_disable_like_jax(setup, capsys):
    """Thresholds lowered on both instances: after one request the
    measured acceptance is below break even, both services print the same
    line, switch to the plain loop and keep answering alike."""
    jcore, weights, _, _ = setup
    params, core = weights(0)
    tok = SimpleTokenizer()
    size = jcore.cfg.vis_encoder.image_size
    svcs = (JaxChatService(jcore.cfg, params, tok, image_size=size,
                           dtype=jnp.float32, **SPEC_SERVE),
            ChatService(core.cfg, core, tok, image_size=size, device="cpu",
                        **SPEC_SERVE))
    try:
        for svc in svcs:
            svc.SPEC_MIN_WINDOWS, svc.SPEC_BREAK_EVEN = 1, 100.0
        lines, answers = [], []
        for svc in svcs:
            first = svc.generate(**REQUESTS["image"])
            lines.append([ln for ln in capsys.readouterr().err.splitlines()
                          if ln.startswith("[serve]")])
            answers.append((first["ids"],
                            svc.generate(**REQUESTS["text_only"])["ids"]))
        assert lines[1] == lines[0] and len(lines[0]) == 1
        assert "speculative decoding disabled" in lines[0][0]
        assert answers[1] == answers[0]
        want, got = (svc.metrics() for svc in svcs)
        assert (got["mode"], got["spec_disabled"]) == \
            (want["mode"], want["spec_disabled"]) == ("batch1", True)
        assert got["spec_windows_total"] == want["spec_windows_total"]
    finally:
        for svc in svcs:
            svc.close()
