"""The port's continuous-batching engine (`visionllm_tpu_torch/slots.py`)
and the cached extend window against the JAX package on the CPU, in fp32,
at `tiny_test_config` dims, with one flax param tree loaded into both.

Each request's tokens through the port's slots equal the JAX slot
engine's for it and the solo run of the port's `build_generate_fn`:
simultaneous and staggered arrivals, a slot reused after completion, a
[DET] countdown inside a slot, chunked prefill (against monolithic, and
interleaved with decode), and a span-4 step against single steps. Each
step's logprobs lie within 1e-4 of JAX's. `VisionLLM.llm_window`'s hidden
states, logits and cache writes lie within 1e-4 of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu import slots as jslots
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.llama import KVCache as JaxCache
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch import slots
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.llama import KVCache
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = 1e-4
MAX_NEW = 10
L_PAD = 48          # the compiled prompt length (left-padded)
MAX_LEN = 128
CHUNK = 16
TID = SpecialTokenIds.synthetic()
JTID = JaxTid.synthetic()


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    img_len = jcfg.vis_encoder.num_patches
    size = jcfg.vis_encoder.image_size
    prompts = [[1, 5, 6] + [TID.imp] * img_len + [7, 8],
               [1] + [TID.imp] * img_len + [9, 10, 11, 12],
               [1, 13] + [TID.imp] * img_len + [14]]
    images = np.random.RandomState(0).rand(len(prompts), size, size,
                                           3).astype(np.float32)
    jmodel = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.jit(lambda r: jmodel.init(
        r, jnp.asarray([prompts[0]], jnp.int32), jnp.asarray(images[:1]),
        JTID))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)
    core = build_core(tiny_test_config(use_gdino=False, gdino=None),
                      device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    gen = build_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                            max_len=MAX_LEN)

    def solo_run(i, first_token=None):
        out = gen(torch.tensor([prompts[i]]),
                  torch.from_numpy(images[i:i + 1]),
                  first_token=None if first_token is None
                  else torch.tensor([first_token]))
        return out["out_tokens"][0, :out["num_generated"]].tolist()

    solo = [solo_run(i) for i in range(len(prompts))]
    return jmodel, params, core, prompts, images, solo, solo_run


def _pad(prompt):
    ids = np.zeros((1, L_PAD), np.int64)
    mask = np.zeros((1, L_PAD), bool)
    ids[0, L_PAD - len(prompt):] = prompt
    mask[0, L_PAD - len(prompt):] = True
    return ids, mask


class PortEngine:
    """The port's slot engine behind the small interface `_drive` uses."""

    def __init__(self, setup, n_slots, span=1):
        _, _, self.core, self.prompts, self.images, _, _ = setup
        self.init_state, self.prefill, self.insert, self.step_fn = \
            slots.build_slot_fns(self.core, TID, n_slots=n_slots,
                                 max_len=MAX_LEN, span=span)

    def init(self):
        return self.init_state()

    def admit(self, st, slot, i, first_token=None):
        state, valid = st
        ids, mask = _pad(self.prompts[i])
        pre = self.prefill(torch.from_numpy(ids),
                           torch.from_numpy(self.images[i:i + 1]),
                           torch.from_numpy(mask), first_token=first_token)
        st = self.insert(state, slot, pre["first"], pre["embed"],
                         pre["cache"], pre["valid"], valid)
        return st, int(pre["first"])

    def step(self, st):
        out = self.step_fn(*st)
        return st, (out["token"].numpy(), out["finished"].numpy(),
                    out["logprob"].numpy())


class JaxEngine(PortEngine):
    """The JAX package's slot engine (`visionllm_tpu/slots.py`)."""

    def __init__(self, setup, n_slots, span=1):
        self.model, self.params, _, self.prompts, self.images, _, _ = setup
        self.init_state, self.prefill, self.insert, self.step_fn = \
            jslots.build_slot_fns(self.model, JTID, n_slots=n_slots,
                                  max_len=MAX_LEN, span=span)

    def admit(self, st, slot, i, first_token=None):
        state, valid = st
        ids, mask = _pad(self.prompts[i])
        kw = {} if first_token is None else dict(
            first_token=jnp.asarray(first_token))
        pre = self.prefill(self.params, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(self.images[i:i + 1]),
                           jnp.asarray(mask), **kw)
        st = self.insert(state, jnp.asarray(slot), pre["first"],
                         pre["embed"], pre["cache"], pre["valid"], valid)
        return st, int(pre["first"])

    def step(self, st):
        state, valid = st
        out = self.step_fn(self.params, state, valid)
        return (out["state"], valid), (np.asarray(out["token"]),
                                       np.asarray(out["finished"]),
                                       np.asarray(out["logprob"]))


def _drive(engine, arrivals, n_slots):
    """Admit request i at tick arrivals[i] into the lowest free slot
    (waiting while none is free); run to completion. Returns each
    request's tokens and step logprobs."""
    st = engine.init()
    streams, lps, active = {}, {}, {}
    pending = sorted(range(len(arrivals)), key=lambda i: arrivals[i])
    t = 0
    while pending or active:
        while pending and arrivals[pending[0]] <= t and \
                len(active) < n_slots:
            i = pending.pop(0)
            slot = next(s for s in range(n_slots) if s not in active)
            st, first = engine.admit(st, slot, i)
            streams[i], lps[i] = [first], []
            if first != 2:
                active[slot] = i
        t += 1
        if not active:
            continue
        st, (toks, fins, lp) = engine.step(st)
        for s in list(active):
            i = active[s]
            streams[i].append(int(toks[s]))
            lps[i].append(float(lp[s]))
            if fins[s] or len(streams[i]) >= MAX_NEW:
                del active[s]
    return [streams[i] for i in range(len(arrivals))], \
        [lps[i] for i in range(len(arrivals))]


ARRIVALS = {"simultaneous": ([0, 0, 0], 3), "staggered": ([0, 3, 6], 3),
            "slot_reuse": ([0, 0, 0], 2)}


@pytest.mark.parametrize("case", sorted(ARRIVALS))
def test_slot_streams_match_jax_and_solo(setup, case):
    arrivals, n_slots = ARRIVALS[case]
    solo = setup[5]
    got, got_lp = _drive(PortEngine(setup, n_slots), arrivals, n_slots)
    want, want_lp = _drive(JaxEngine(setup, n_slots), arrivals, n_slots)
    for i in range(len(arrivals)):
        assert got[i] == want[i], f"request {i}"
        assert got[i][:len(solo[i])] == solo[i], f"request {i}"
        np.testing.assert_allclose(got_lp[i], want_lp[i], atol=TOL,
                                   rtol=TOL, err_msg=f"request {i}")


def test_tool_countdown_in_slot(setup):
    """A [DET]-forced run of [EMB] rows in slot 0 beside traffic in slot
    1, against JAX's engine and the port's solo run with [DET] forced."""
    streams = []
    for engine in (PortEngine(setup, 2), JaxEngine(setup, 2)):
        st = engine.init()
        st, first = engine.admit(st, 0, 0, first_token=TID.det)
        st, _ = engine.admit(st, 1, 1)
        toks = [first]
        for _ in range(MAX_NEW - 1):
            st, (tok, _, _) = engine.step(st)
            toks.append(int(tok[0]))
        streams.append(toks)
    assert streams[0] == streams[1]
    assert streams[0] == setup[6](0, first_token=TID.det)
    assert streams[0][:1 + 4] == [TID.det] + [TID.emb + i for i in range(4)]


def _port_chunked(setup, i, between=None):
    """Request i through the port's chunked prefill (CHUNK windows);
    `between()` runs after each window. Returns (first, embed, row
    cache, valid, last logits)."""
    core, prompts, images = setup[2], setup[3], setup[4]
    new_row, embed_prompt, run, finish = slots.build_chunked_prefill_fns(
        core, TID, chunk=CHUNK, max_len=MAX_LEN)
    ids, mask = _pad(prompts[i])
    emb = embed_prompt(torch.from_numpy(ids),
                       torch.from_numpy(images[i:i + 1]))
    row = new_row()
    valid = torch.ones(MAX_LEN, dtype=torch.bool)
    valid[:L_PAD] = torch.from_numpy(mask[0])
    for k in range(L_PAD // CHUNK):
        row, last = run(emb[:, k * CHUNK:(k + 1) * CHUNK], row, valid)
        if between is not None:
            between()
    first, embed, _ = finish(last)
    return first, embed, row, valid, last


def _jax_chunked_first(setup, i):
    model, params, _, prompts, images = setup[:5]
    new_row, embed_prompt, run, finish = jslots.build_chunked_prefill_fns(
        model, JTID, chunk=CHUNK, max_len=MAX_LEN)
    ids, mask = _pad(prompts[i])
    emb = embed_prompt(params, jnp.asarray(ids, jnp.int32),
                       jnp.asarray(images[i:i + 1]))
    row = new_row()
    valid = jnp.concatenate([jnp.asarray(mask[0]),
                             jnp.ones((MAX_LEN - L_PAD,), bool)])
    for k in range(L_PAD // CHUNK):
        row, last = run(params, emb[:, k * CHUNK:(k + 1) * CHUNK], row,
                        valid)
    return int(finish(params, last)[0][0]), np.asarray(last)


@pytest.mark.parametrize("i", [0, 1])
def test_chunked_prefill_matches_monolithic(setup, i):
    """Chunked prefill: the same first token as the monolithic prefill
    and as JAX's chunked prefill, last logits within 1e-4 of both, and
    the same decode stream through a slot as the solo run."""
    engine = PortEngine(setup, 1)
    ids, mask = _pad(setup[3][i])
    mono = engine.prefill(torch.from_numpy(ids),
                          torch.from_numpy(setup[4][i:i + 1]),
                          torch.from_numpy(mask))
    first, embed, row, valid, last = _port_chunked(setup, i)
    jfirst, jlast = _jax_chunked_first(setup, i)
    assert int(first[0]) == int(mono["first"]) == jfirst
    np.testing.assert_allclose(last.numpy(), jlast, atol=TOL, rtol=TOL)
    assert row.index == L_PAD
    state, slot_valid = engine.init()
    st = engine.insert(state, 0, first[0], embed, row, valid, slot_valid)
    toks = [int(first[0])]
    for _ in range(MAX_NEW - 1):
        st, (tok, _, _) = engine.step(st)
        toks.append(int(tok[0]))
    assert toks[:len(setup[5][i])] == setup[5][i]


def test_chunked_prefill_interleaved_with_decode(setup):
    """Decode steps of a live slot between the windows of a chunked
    admission change neither request's tokens."""
    solo = setup[5]
    engine = PortEngine(setup, 2)
    st, first0 = engine.admit(engine.init(), 0, 0)
    s0 = [first0]

    def tick():
        nonlocal st
        st, (tok, _, _) = engine.step(st)
        s0.append(int(tok[0]))

    first1, embed1, row, valid, _ = _port_chunked(setup, 1, between=tick)
    st = engine.insert(st[0], 1, first1[0], embed1, row, valid, st[1])
    s1 = [int(first1[0])]
    while len(s0) < MAX_NEW or len(s1) < MAX_NEW:
        st, (tok, _, _) = engine.step(st)
        if len(s0) < MAX_NEW:
            s0.append(int(tok[0]))
        if len(s1) < MAX_NEW:
            s1.append(int(tok[1]))
    assert s0[:len(solo[0])] == solo[0]
    assert s1[:len(solo[1])] == solo[1]


def test_span_step_matches_single_steps(setup):
    """A span-4 step emits the frames 4 single steps emit (tokens,
    finished, logprobs), in the port and in JAX."""
    frames = {}
    for name, cls, span in (("port1", PortEngine, 1),
                            ("port4", PortEngine, 4),
                            ("jax4", JaxEngine, 4)):
        engine = cls(setup, 2, span=span)
        st = engine.init()
        for slot in (0, 1):
            st, _ = engine.admit(st, slot, slot)
        got = []
        for _ in range(8 // span):
            st, frame = engine.step(st)
            got.append([np.atleast_2d(f) for f in frame])
        frames[name] = [np.concatenate(f) for f in zip(*got)]
    for name in ("port4", "jax4"):
        tok, fin, lp = frames[name]
        assert tok.shape == (8, 2)
        np.testing.assert_array_equal(tok, frames["port1"][0], err_msg=name)
        np.testing.assert_array_equal(fin, frames["port1"][1], err_msg=name)
        np.testing.assert_allclose(lp, frames["port1"][2], atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("index,W", [(0, 7), (11, 5)])
def test_llm_window_matches_jax(setup, index, W):
    """`VisionLLM.llm_window` on a B2 cache holding `index` positions
    (row 1 with two invalid pads): hidden, logits and the written K/V
    within 1e-4 of JAX's; the index advances by W."""
    from visionllm_tpu.models.visionllm import VisionLLM as JV
    model, params, core = setup[:3]
    cfg = core.cfg.llm
    rng = np.random.default_rng(index)
    B = 2
    k = (0.5 * rng.standard_normal((cfg.num_layers, B, MAX_LEN,
                                    cfg.num_kv_heads, cfg.head_dim))
         ).astype(np.float32)
    v = (0.5 * rng.standard_normal(k.shape)).astype(np.float32)
    emb = (0.5 * rng.standard_normal((B, W, cfg.hidden_size))
           ).astype(np.float32)
    pos = np.tile(index + np.arange(W), (B, 1))
    valid = np.ones((B, MAX_LEN), bool)
    valid[1, :2] = False
    jc = JaxCache(k=jnp.asarray(k), v=jnp.asarray(v),
                  index=jnp.asarray(index, jnp.int32))
    jout = jax.jit(lambda p, e, ps, c, m: model.apply(
        {"params": p}, e, ps, c, m, method=JV.llm_window))(
            params, emb, pos.astype(np.int32), jc, valid)
    tc = KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                 index)
    with torch.no_grad():
        tout = core.llm_window(torch.from_numpy(emb), torch.from_numpy(pos),
                               tc, torch.from_numpy(valid))
    assert tc.index == int(jout["cache"].index) == index + W
    for key in ("hidden", "logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jout["cache"].k),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jout["cache"].v),
                               atol=TOL, rtol=TOL)
