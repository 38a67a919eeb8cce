"""Session (multi-turn prefix) KV reuse in the port's slot engine and
`ChatService` against the JAX package on the CPU, in fp32, at
`tiny_test_config` dims, with one flax param tree in both and one
`RoundTripTokenizer` (generated ids survive the text round trip, so a
history can match the cached prefix).

* Device level: a parked slot extended by a delta of 3 or 11 tokens
  (one and two 8-wide windows, the fill index rolled back over the pads)
  decodes the tokens a monolithic prefill of the whole sequence gives.
* Service level, the port's answer equal to the JAX service's in each
  case: turn 2 and turn 3 against a prefill of the whole history; a
  prefix mismatch, an image swap and a padded overflow falling back; LRU
  eviction; two sessions interleaving; and the JAX service's ValueErrors.
* The fix of the reference's span overshoot (`serve.py:642`): with
  decode_span 4 a length stop that is not a span multiple still parks
  the slot at the host's fill, and turn 2 equals the history prefill.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu_torch import slots
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.serve import ChatService
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import RoundTripTokenizer

TID = SpecialTokenIds.synthetic()
L_PAD, MAX_LEN, CHUNK = 96, 192, 8
SESSION = dict(max_new_tokens=6, max_prompt=160, slots=3, sessions=2,
               session_chunk=8)


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    jtid = JaxTid.synthetic()
    size = jcfg.vis_encoder.image_size
    ids = jnp.asarray([[1] + [jtid.imp] * jcfg.vis_encoder.num_patches
                       + [5, 6]], jnp.int32)
    params = jax.jit(lambda r: JaxCore(jcfg, dtype=jnp.float32).init(
        r, ids, jnp.zeros((1, size, size, 3)), jtid))(
            jax.random.PRNGKey(7))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    return jcfg, params, cfg, core


# ---------------------------------------------------------------------------
# device level: extension == monolithic prefill
# ---------------------------------------------------------------------------

def _pad(prompt):
    ids = np.zeros((1, L_PAD), np.int64)
    mask = np.zeros((1, L_PAD), bool)
    ids[0, L_PAD - len(prompt):] = prompt
    mask[0, L_PAD - len(prompt):] = True
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _decode(step, state, valid, slot, n):
    toks = []
    for _ in range(n):
        out = step(state, valid)
        toks.append(int(out["token"][slot]))
        if bool(out["finished"][slot]):
            break
    return toks


@pytest.mark.parametrize("delta_len", [3, 11])
def test_extension_matches_monolithic_prefill(weights, delta_len):
    core = weights[3]
    size = core.cfg.vis_encoder.image_size
    image = torch.from_numpy(np.random.RandomState(0).rand(
        1, size, size, 3).astype(np.float32))
    prompt1 = [1, 5, 6] + [TID.imp] * core.cfg.vis_encoder.num_patches \
        + [7, 8]
    init, prefill, insert, step = slots.build_slot_fns(
        core, TID, n_slots=2, max_len=MAX_LEN)
    extract, embed_delta, extend, finish, kill = slots.build_session_fns(
        core)

    state, valid = init()
    ids1, mask1 = _pad(prompt1)
    pre = prefill(ids1, image, mask1)
    insert(state, 0, pre["first"], pre["embed"], pre["cache"], pre["valid"],
           valid)
    stream1 = [int(pre["first"])] + _decode(step, state, valid, 0, 5)
    kill(state, 0)

    delta = list(range(200, 200 + delta_len))
    full = prompt1 + stream1[:-1] + delta
    ids2, mask2 = _pad(full)
    ref = prefill(ids2, image, mask2)
    rstate, rvalid = init()
    insert(rstate, 1, ref["first"], ref["embed"], ref["cache"], ref["valid"],
           rvalid)
    want = [int(ref["first"])] + _decode(step, rstate, rvalid, 1, 6)

    row, valid_row = extract(state, valid, 0)
    assert row.index == L_PAD + len(stream1) - 1
    dp = torch.tensor(delta + [0] * ((-delta_len) % CHUNK))[None]
    emb = embed_delta(dp)
    for k in range(dp.shape[1] // CHUNK):
        row, last = extend(emb[:, k * CHUNK:(k + 1) * CHUNK], row,
                           valid_row, min(CHUNK, delta_len - k * CHUNK))
    assert row.index == L_PAD + len(stream1) - 1 + delta_len
    first, embed, _ = finish(last)
    insert(state, 0, first[0], embed, row, valid_row, valid)
    got = [int(first[0])] + _decode(step, state, valid, 0, 6)
    assert got == want


# ---------------------------------------------------------------------------
# service level: the port's ChatService against the JAX one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def services(weights):
    jcfg, params, cfg, core = weights
    tok = RoundTripTokenizer()
    size = cfg.vis_encoder.image_size
    jsvc = JaxChatService(jcfg, params, tok, image_size=size,
                          dtype=jnp.float32, **SESSION)
    tsvc = ChatService(cfg, core, tok, image_size=size, device="cpu",
                       **SESSION)
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


def _both(services, calls):
    """Run the same list of generate kwargs through the JAX and the port's
    service; each answer's text, ids and session flag must agree.
    Returns the port's answers."""
    jsvc, tsvc = services
    out = []
    for kw in calls:
        want, got = jsvc.generate(**kw), tsvc.generate(**kw)
        for key in ("text", "ids", "session_reused"):
            assert got.get(key) == want.get(key), (kw, key)
        out.append(got)
    return out


def _img(seed):
    return np.random.RandomState(seed).randint(0, 255, (40, 56, 3), np.uint8)


def test_session_turns_match_history_prefill(services):
    img = _img(3)
    r1, = _both(services, [dict(prompt="hello there", image=img,
                                session="s1")])
    assert r1["session_reused"] is False
    hist = ["hello there", r1["text"]]
    want, got = _both(services, [
        dict(prompt="and now this", image=img, history=hist),
        dict(prompt="and now this", image=img, history=hist, session="s1")])
    assert got["session_reused"] is True
    assert got["text"] == want["text"]
    hist3 = hist + ["and now this", got["text"]]
    want3, got3 = _both(services, [
        dict(prompt="third turn", image=img, history=hist3),
        dict(prompt="third turn", image=img, history=hist3, session="s1")])
    assert got3["session_reused"] is True and got3["text"] == want3["text"]
    got_m, want_m = services[1].metrics(), services[0].metrics()
    assert set(got_m) == set(want_m)
    for key in ("session_hits", "session_misses", "mode"):
        assert got_m[key] == want_m[key], key
    assert got_m["session_hits"] >= 2


def test_session_prefix_mismatch_falls_back(services):
    bad = ["fresh start", "completely made up reply"]
    r1, want, got = _both(services, [
        dict(prompt="fresh start", session="s2"),
        dict(prompt="next", history=bad),
        dict(prompt="next", history=bad, session="s2")])
    assert got["session_reused"] is False and got["text"] == want["text"]


def test_session_image_swap_falls_back(services):
    img_a, img_b = _img(11), _img(12)
    r1, = _both(services, [dict(prompt="look at this", image=img_a,
                                session="im1")])
    hist = ["look at this", r1["text"]]
    want, got = _both(services, [
        dict(prompt="what now", image=img_b, history=hist),
        dict(prompt="what now", image=img_b, history=hist, session="im1")])
    assert got["session_reused"] is False and got["text"] == want["text"]
    again, = _both(services, [dict(
        prompt="go on", image=img_b,
        history=hist + ["what now", got["text"]], session="im1")])
    assert again["session_reused"] is True


def test_session_padded_overflow_falls_back(services):
    """The room check budgets the delta padded to session_chunk: a fill
    where the padded last window would overrun the buffer misses."""
    r1, = _both(services, [dict(prompt="grow me", session="of1")])
    for svc in services:
        svc._sessions["of1"]["fill"] = svc.slot_max_len - svc.session_chunk \
            + 1
    got, = _both(services, [dict(prompt="hm", history=["grow me", r1["text"]],
                                 session="of1")])
    assert got["session_reused"] is False


def test_session_lru_eviction(services):
    _both(services, [dict(prompt=f"opening for {sid}", session=sid)
                     for sid in ("e1", "e2", "e3")])
    assert len(services[1]._sessions) <= 2
    assert set(services[1]._sessions) == set(services[0]._sessions)
    r, = _both(services, [dict(prompt="opening for e1")])
    hist = ["opening for e1", r["text"]]
    want, got = _both(services, [
        dict(prompt="follow up", history=hist),
        dict(prompt="follow up", history=hist, session="e1")])
    assert got["session_reused"] is False and got["text"] == want["text"]


def test_concurrent_sessions_dont_cross(services):
    ra, rb = _both(services, [dict(prompt="alpha opening", session="c1"),
                              dict(prompt="beta opening", session="c2")])
    hist = {"a": ["alpha opening", ra["text"]],
            "b": ["beta opening", rb["text"]]}
    tsvc = services[1]
    outs = {}

    def go(name, prompt, sid):
        outs[name] = tsvc.generate(prompt, history=hist[name], session=sid)

    ths = [threading.Thread(target=go, args=("a", "alpha next", "c1")),
           threading.Thread(target=go, args=("b", "beta next", "c2"))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths)
    want = _both(services, [dict(prompt="alpha next", history=hist["a"]),
                            dict(prompt="beta next", history=hist["b"])])
    assert outs["a"]["session_reused"] and outs["b"]["session_reused"]
    assert [outs["a"]["text"], outs["b"]["text"]] == [w["text"] for w in want]


def test_session_value_errors_like_jax(weights, services):
    jcfg, _, cfg, core = weights
    tok = RoundTripTokenizer()
    size = cfg.vis_encoder.image_size
    for kw in (dict(sessions=2), dict(slots=2, sessions=2, sampling=True)):
        with pytest.raises(ValueError) as want:
            JaxChatService(jcfg, None, tok, image_size=size,
                           dtype=jnp.float32, **kw)
        with pytest.raises(ValueError) as got:
            ChatService(cfg, core, tok, image_size=size, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    plain = ChatService(cfg, core, tok, image_size=size, device="cpu",
                        max_new_tokens=4, max_prompt=64)
    try:
        with pytest.raises(ValueError, match="session") as got:
            plain.generate("hi", session="x")
    finally:
        plain.close()
    with pytest.raises(ValueError) as want:
        services[0].generate("hi", session="x", temperature=0.5)
    with pytest.raises(ValueError) as got2:
        services[1].generate("hi", session="x", temperature=0.5)
    assert str(got2.value) == str(want.value)


def test_span_length_stop_parks_at_host_fill(weights):
    """decode_span 4, max_new_tokens 6: the first turn stops on length two
    ticks into its second span, so the device ran two tokens past the
    host. The parked fill is the host's, and turn 2 through the session
    equals the prefill of the whole history."""
    _, _, cfg, core = weights
    svc = ChatService(cfg, core, RoundTripTokenizer(),
                      image_size=cfg.vis_encoder.image_size, device="cpu",
                      decode_span=4, **SESSION)
    try:
        r1 = svc.generate("tell me more", session="sp")
        assert r1["num_tokens"] == SESSION["max_new_tokens"]  # a length stop
        ent = svc._sessions["sp"]
        n_prompt = len(svc._encode("tell me more", None)[0])
        assert ent["fill"] == svc.max_prompt + r1["num_tokens"] - 1
        assert len(ent["ids"]) == n_prompt + r1["num_tokens"] - 1
        hist = ["tell me more", r1["text"]]
        want = svc.generate("go on", history=hist)
        got = svc.generate("go on", history=hist, session="sp")
        assert got["session_reused"] is True
        assert got["ids"] == want["ids"]
    finally:
        svc.close()
