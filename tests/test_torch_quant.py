"""The port's int8 serving modes (`visionllm_tpu_torch/ops/quant.py`, the
int8 KV cache of `models/llama.py`, and their use by generate, the slot
engine and `ChatService`) against the JAX package on the CPU, in fp32, at
tiny dims, with inputs from a numpy seed:

* `quantize_int8` (a kernel, a scanned stack, a Linear weight) and
  `quantize_kv` bit-identical to JAX's;
* `Int8Linear` against `Int8Dense` and `Int8ActLinear` against
  `Int8ActDense` (activation codes and int32 accumulators identical),
  `int8_kv_attention` with GQA and a mask, each within 1e-5;
* `quantize_llm_int8` gives the JAX `quantize_llm_params` tree byte for
  byte, and a JAX int8 tree loads into the port; `LlamaModel` logits in
  int8, w8a8 and int8-KV decode within 1e-4 of JAX's same configuration;
* `build_generate_fn` with int8 / w8a8 weights and an int8 KV cache, the
  slot engine on an int8 cache and a w8a8 + int8-KV `ChatService`: token
  ids identical to JAX's; the int8-KV refusals in JAX's words.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu import slots as jslots
from visionllm_tpu.config import LLMConfig as JaxLLMConfig
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.llama import KVCache as JaxCache
from visionllm_tpu.models.llama import LlamaModel as JaxLlama
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.ops import quant as J
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu_torch import slots
from visionllm_tpu_torch.config import LLMConfig, tiny_test_config
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.llama import KVCache, LlamaModel
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops import quant as Q
from visionllm_tpu_torch.serve import ChatService
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

TOL = 1e-5
MODEL_TOL = 1e-4
DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=172,
            num_layers=3, num_heads=4, num_kv_heads=2,
            max_position_embeddings=256)
TID, JTID = SpecialTokenIds.synthetic(), JaxTid.synthetic()
MAX_NEW, MAX_LEN = 8, 96


def _np(x):
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype != \
        np.int8 else np.asarray(x)


@pytest.mark.parametrize("layout", ["kernel", "stacked", "linear_weight"])
def test_quantize_int8_is_bit_identical(layout):
    rng = np.random.default_rng(1)
    shape = (3, 64, 172) if layout == "stacked" else (64, 172)
    w = rng.normal(0, 0.02, shape).astype(np.float32)
    w.reshape(-1)[:64] = 0.0         # an all-zero channel hits the 1e-8 floor
    jwq, js = J.quantize_int8(jnp.asarray(w))
    if layout == "linear_weight":    # [out, in], as `Int8Linear.from_linear`
        wq, s = Q.quantize_int8(torch.from_numpy(w.T.copy()), dim=-1)
        wq = wq.t()
    else:
        wq, s = Q.quantize_int8(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(s.float().numpy(), _np(js))
    deq = wq.float() * s.float().unsqueeze(-2)
    assert ((deq - torch.from_numpy(w)).abs()
            <= s.float().unsqueeze(-2) * 0.5 + 1e-6).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_identical(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 7, 4, 16)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = J.quantize_kv(jx)
    tq, ts = Q.quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))


def _jax_tree(w):
    jwq, js = J.quantize_int8(jnp.asarray(w))
    return {"kernel_q": np.asarray(jwq), "scale": np.asarray(js)}


def test_int8_linear_matches_int8_dense():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.02, (64, 40)).astype(np.float32)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    tree = _jax_tree(w)
    want = J.Int8Dense(40, dtype=jnp.float32).apply({"params": tree},
                                                    jnp.asarray(x))
    lin = Q.Int8Linear(64, 40)
    load_jax_params(lin, tree)
    np.testing.assert_array_equal(lin.kernel_q.numpy(), tree["kernel_q"].T)
    got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_int8_act_linear_matches_int8_act_dense():
    """Activation codes and the int32 accumulator are exact integers, equal
    to an int64 numpy product; the output within 1e-5 of JAX's."""
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.02, (64, 48)).astype(np.float32)
    x = rng.normal(0, 1.3, (5, 64)).astype(np.float32)
    x[3] = 0.0                       # an all-zero row hits the 1e-8 floor
    tree = _jax_tree(w)
    want = J.Int8ActDense(48, dtype=jnp.float32).apply({"params": tree},
                                                       jnp.asarray(x))
    lin = Q.Int8ActLinear(64, 48)
    load_jax_params(lin, tree)
    xf = torch.from_numpy(x)
    sx = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    jx = jnp.asarray(x)
    jsx = jnp.maximum(jnp.max(jnp.abs(jx), -1, keepdims=True) / 127.0, 1e-8)
    jxq = jnp.clip(jnp.round(jx / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    acc = Q.int8_matmul(xq, lin.kernel_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(jxq, np.int64) @ tree["kernel_q"].astype(
            np.int64))
    np.testing.assert_allclose(lin(xf).numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("Lq", [1, 3])
def test_int8_kv_attention_matches_jax(Lq):
    rng = np.random.default_rng(7 + Lq)
    B, H, H_kv, D, T = 2, 4, 2, 16, 9
    q = rng.normal(0, 1, (B, Lq, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, H_kv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, H_kv, D)).astype(np.float32)
    mask = rng.uniform(size=(B, 1, Lq, T)) > 0.3
    mask[..., 0] = True
    kq, ks = J.quantize_kv(jnp.asarray(k))
    vq, vs = J.quantize_kv(jnp.asarray(v))
    want = J.int8_kv_attention(jnp.asarray(q), kq, ks, vq, vs,
                               jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = Q.int8_kv_attention(
        t(q), t(kq), t(_np(ks)).bfloat16(), t(vq), t(_np(vs)).bfloat16(),
        t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# the LLM: quantized trees, logits, the int8 cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llm_params():
    torch.set_num_threads(1)
    model = JaxLlama(JaxLLMConfig(**DIMS), dtype=jnp.float32)

    def init_method(m, embeds, pos):
        m.embed(jnp.zeros((1, 1), jnp.int32))
        return m(embeds, pos)

    params = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 8, DIMS["hidden_size"])), jnp.arange(8)[None],
        method=init_method))(jax.random.PRNGKey(0))["params"]
    qparams = J.quantize_llm_params(params, jit=False)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, qparams)


def _port_llm(params, **kw):
    llm = LlamaModel(LLMConfig(**DIMS, **kw))
    load_jax_params(llm, params)
    return llm.eval()


def test_quantize_llm_int8_matches_the_jax_tree(llm_params):
    """The port quantizes a loaded float LlamaModel to the bytes of the JAX
    `quantize_llm_params` tree, and the JAX tree loads into the int8
    model to the same buffers."""
    params, qparams = llm_params
    llm = Q.quantize_llm_int8(_port_llm(params))
    loaded = _port_llm(qparams, quant="int8")
    layer = qparams["layers"]["layer"]
    for i in range(DIMS["num_layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            for mod in (getattr(llm.layers[i], name),
                        getattr(loaded.layers[i], name)):
                assert isinstance(mod, Q.Int8Linear)
                np.testing.assert_array_equal(
                    mod.kernel_q.numpy(), layer[name]["kernel_q"][i].T)
                np.testing.assert_array_equal(
                    mod.scale.float().numpy(), _np(layer[name]["scale"][i]))
    np.testing.assert_array_equal(llm.lm_head.kernel_q.numpy(),
                                  qparams["lm_head"]["kernel_q"].T)
    # one tree serves both modes: w8a8 re-wraps the same buffers
    kq = llm.lm_head.kernel_q
    Q.quantize_llm_int8(llm, act=True)
    assert type(llm.lm_head) is Q.Int8ActLinear
    assert llm.lm_head.kernel_q is kq


@pytest.mark.parametrize("quant", ["int8", "w8a8"])
def test_quantized_llama_logits_match_jax(llm_params, quant):
    params, qparams = llm_params
    rng = np.random.default_rng(3)
    embeds = rng.normal(0, 1, (2, 9, DIMS["hidden_size"])).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    _, want, _ = JaxLlama(JaxLLMConfig(**DIMS, quant=quant),
                          jnp.float32).apply({"params": qparams},
                                             jnp.asarray(embeds),
                                             jnp.asarray(pos))
    with torch.no_grad():
        _, got = _port_llm(qparams, quant=quant)(
            torch.from_numpy(embeds), torch.from_numpy(pos.copy()))
        _, dense = _port_llm(params)(torch.from_numpy(embeds),
                                     torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    cos = torch.nn.functional.cosine_similarity(got.flatten(),
                                                dense.flatten(), dim=0)
    assert cos > (0.999 if quant == "int8" else 0.998)


def test_int8_kv_decode_matches_jax(llm_params):
    """A left-padded prefill into an int8 cache, 3 decode steps and a
    3-token extend window: logits within 1e-4 of JAX's, the int8 K/V and
    their scales identical."""
    params, _ = llm_params
    cfg = JaxLLMConfig(**DIMS)
    jllm = JaxLlama(cfg, jnp.float32)
    llm = _port_llm(params)
    rng = np.random.default_rng(4)
    B, L, T = 2, 6, 32
    hid = DIMS["hidden_size"]
    mask = np.ones((B, L), np.int32)
    mask[1, :2] = 0
    dmask = np.concatenate([mask, np.ones((B, T - L), np.int32)], 1)
    jc = JaxCache.create(cfg, B, T, dtype=jnp.int8)
    tc = KVCache.create(llm.cfg, B, T, torch.int8, "cpu")
    assert tc.k_scale.shape == (DIMS["num_layers"], B, T,
                                DIMS["num_kv_heads"])
    apply = jax.jit(lambda e, p, c, m, ext: jllm.apply(
        {"params": params}, e, p, attn_mask=m, cache=c, extend=ext),
        static_argnums=4)
    pairs = []
    for n, m, ext in ((L, mask, False), (1, dmask, False), (1, dmask, False),
                      (1, dmask, False), (3, dmask, True)):
        e = rng.normal(0, 1, (B, n, hid)).astype(np.float32)
        start = int(jc.index)
        p = np.broadcast_to(np.arange(start, start + n)[None], (B, n))
        _, jl, jc = apply(e, p, jc, m, ext)
        with torch.no_grad():
            _, tl = llm(torch.from_numpy(e), torch.from_numpy(p.copy()),
                        attn_mask=torch.from_numpy(m), cache=tc,
                        extend=ext)
        pairs.append((jl, tl))
    assert tc.index == int(jc.index) == L + 6
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=f"output {i}")
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(
            _np(getattr(tc, name).float() if "scale" in name
                else getattr(tc, name)), _np(getattr(jc, name)),
            err_msg=name)


# ---------------------------------------------------------------------------
# generate, the slot engine and ChatService
# ---------------------------------------------------------------------------

def _core_cfgs(**llm):
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    return tuple(dataclasses.replace(c, llm=dataclasses.replace(c.llm, **llm))
                 for c in (jcfg, cfg))


@pytest.fixture(scope="module")
def core_params():
    """A float flax core tree and its `quantize_serving_params(bits=8)`
    twin, with two prompts and their images."""
    jcfg, _ = _core_cfgs()
    img_len = jcfg.vis_encoder.num_patches
    size = jcfg.vis_encoder.image_size
    prompts = [[1, 5, 6] + [TID.imp] * img_len + [7, 8],
               [1] + [TID.imp] * img_len + [9, 10, 11, 12]]
    images = np.random.RandomState(0).rand(2, size, size, 3).astype(
        np.float32)
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.jit(lambda r: jcore.init(
        r, jnp.asarray([prompts[0]]), jnp.asarray(images[:1]), JTID))(
            jax.random.PRNGKey(0))["params"]
    qparams = J.quantize_serving_params(params, jit=False)
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, qparams), prompts, images)


def _pair(params, **llm):
    jcfg, cfg = _core_cfgs(**llm)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    return JaxCore(jcfg, dtype=jnp.float32), core


@pytest.mark.parametrize("quant,kv_quant", [("int8", ""), ("w8a8", ""),
                                            ("", "int8")])
def test_generate_matches_jax(core_params, quant, kv_quant):
    params, qparams, prompts, images = core_params
    jcore, core = _pair(qparams if quant else params, quant=quant,
                        kv_quant=kv_quant)
    ids = np.asarray([prompts[0]])
    want = jax_generate_fn(jcore, JTID, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)(
        qparams if quant else params, jnp.asarray(ids),
        jnp.asarray(images[:1]))
    got = build_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                            max_len=MAX_LEN)(torch.from_numpy(ids),
                                             torch.from_numpy(images[:1]))
    assert (got["cache"].k.dtype == torch.int8) == (kv_quant == "int8")
    assert got["num_generated"] == int(want["num_generated"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    for key in ("out_hidden", "out_logprobs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=key)


def _drive(admit, step, n_prompts, arrivals, n_slots=2):
    """Admit request i at tick arrivals[i] into a free slot; decode to
    EOS or MAX_NEW. Returns each request's tokens."""
    streams, active = {}, {}
    pending = list(range(n_prompts))
    t = 0
    while pending or active:
        while pending and arrivals[pending[0]] <= t \
                and len(active) < n_slots:
            i = pending.pop(0)
            slot = next(s for s in range(n_slots) if s not in active)
            streams[i] = [admit(slot, i)]
            if streams[i][0] != 2:
                active[slot] = i
        t += 1
        if not active:
            continue
        toks, fins = step()
        for s in list(active):
            streams[active[s]].append(int(toks[s]))
            if fins[s] or len(streams[active[s]]) >= MAX_NEW:
                del active[s]
    return [streams[i] for i in range(n_prompts)]


def test_slot_engine_int8_kv_matches_jax(core_params):
    """Two requests through two slots of an int8 cache, the second
    admitted mid-decode: token ids identical to JAX's engine."""
    params, _, prompts, images = core_params
    jcore, core = _pair(params, kv_quant="int8")
    L_pad = 40
    pads = []
    for p in prompts:
        ids = np.zeros((1, L_pad), np.int64)
        ids[0, L_pad - len(p):] = p
        pads.append((ids, ids != 0))

    t_init, t_pre, t_ins, t_step = slots.build_slot_fns(
        core, TID, n_slots=2, max_len=MAX_LEN)
    state, valid = t_init()
    assert state.cache.k.dtype == torch.int8

    def t_admit(slot, i):
        ids, mask = pads[i]
        pre = t_pre(torch.from_numpy(ids), torch.from_numpy(images[i:i + 1]),
                    torch.from_numpy(mask))
        t_ins(state, slot, pre["first"], pre["embed"], pre["cache"],
              pre["valid"], valid)
        return int(pre["first"])

    def t_tick():
        out = t_step(state, valid)
        return out["token"].numpy(), out["finished"].numpy()

    j_init, j_pre, j_ins, j_step = jslots.build_slot_fns(
        jcore, JTID, n_slots=2, max_len=MAX_LEN)
    jst = list(j_init())

    def j_admit(slot, i):
        ids, mask = pads[i]
        pre = j_pre(params, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(images[i:i + 1]), jnp.asarray(mask))
        jst[:] = j_ins(jst[0], jnp.asarray(slot), pre["first"], pre["embed"],
                       pre["cache"], pre["valid"], jst[1])
        return int(pre["first"])

    def j_tick():
        out = j_step(params, *jst)
        jst[0] = out["state"]
        return np.asarray(out["token"]), np.asarray(out["finished"])

    want = _drive(j_admit, j_tick, 2, [0, 2])
    got = _drive(t_admit, t_tick, 2, [0, 2])
    assert got == want
    assert all(len(s) > 2 for s in got)


def test_session_fns_refuse_int8_kv_like_jax(core_params):
    params, _, _, _ = core_params
    jcore, core = _pair(params, kv_quant="int8")
    with pytest.raises(ValueError) as want:
        jslots.build_session_fns(jcore)
    with pytest.raises(ValueError) as got:
        slots.build_session_fns(core)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(slots=2, prefill_chunk=16),
                                dict(slots=2, sessions=2)],
                         ids=["chunked_prefill", "sessions"])
def test_chat_service_refuses_int8_kv_like_jax(core_params, kw):
    params, _, _, _ = core_params
    jcore, core = _pair(params, kv_quant="int8")
    tok = SimpleTokenizer()
    with pytest.raises(ValueError) as want:
        JaxChatService(jcore.cfg, None, tok, dtype=jnp.float32, **kw)
    with pytest.raises(ValueError) as got:
        ChatService(core.cfg, core, tok, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "int8 KV cache is not exact" in str(got.value)


def test_w8a8_int8_kv_slot_service_matches_jax(core_params):
    """The whole slice in one service: w8a8 weights from one
    `quantize_serving_params` tree and an int8 KV cache behind
    `ChatService(slots=2)`; image and text requests get JAX's ids."""
    _, qparams, _, _ = core_params
    jcore, core = _pair(qparams, quant="w8a8", kv_quant="int8")
    tok = SimpleTokenizer()
    size = jcore.cfg.vis_encoder.image_size
    kw = dict(image_size=size, slots=2, max_new_tokens=MAX_NEW,
              max_prompt=48)
    jsvc = JaxChatService(jcore.cfg, qparams, tok, dtype=jnp.float32, **kw)
    tsvc = ChatService(core.cfg, core, tok, device="cpu", **kw)
    try:
        img = np.random.RandomState(3).randint(0, 255, (40, 52, 3), np.uint8)
        for req in (dict(prompt="describe the image", image=img),
                    dict(prompt="hello there")):
            want, got = jsvc.generate(**req), tsvc.generate(**req)
            assert got["ids"] == want["ids"] and got["num_tokens"] >= 1
    finally:
        jsvc.close()
        tsvc.close()


@pytest.mark.parametrize("level", ["composite", "core", "llm"])
def test_quantize_serving_params_finds_the_llm(core_params, level):
    """The LLM is found in a composite, a core or a bare LlamaModel, and
    quantized to the JAX `quantize_serving_params` tree's bytes."""
    params, qparams, _, _ = core_params
    core = build_core(_core_cfgs()[1], device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    model = {"composite": torch.nn.Module(), "core": core,
             "llm": core.llm}[level]
    if level == "composite":
        model.core = core
    assert Q.quantize_serving_params(model, bits=8) is model
    got = core.llm.layers[1].down_proj
    assert type(got) is Q.Int8Linear
    want = qparams["llm"]["layers"]["layer"]["down_proj"]
    np.testing.assert_array_equal(got.kernel_q.numpy(),
                                  want["kernel_q"][1].T)
    np.testing.assert_array_equal(got.scale.float().numpy(),
                                  _np(want["scale"][1]))


def test_load_int8_tree_rejects_unused_and_missing(llm_params):
    _, qparams = llm_params
    llm = LlamaModel(LLMConfig(**DIMS, quant="int8"))
    extra = dict(qparams, lm_head=dict(qparams["lm_head"],
                                       kernel=np.zeros((64, 128))))
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(llm, extra)
    missing = dict(qparams, lm_head={"kernel_q": qparams["lm_head"][
        "kernel_q"]})
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(llm, missing)
