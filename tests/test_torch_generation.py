"""The port's KV-cache decode and greedy generation against the JAX
package on the CPU, in fp32, at `tiny_test_config` dims, with dense
weights and with an int4 tree packed by the JAX
`quantize_serving_params(..., bits=4)`.

* `LlamaModel`: a left-padded prefill into a `KVCache`, then 3 decode
  steps: hidden states and logits to 1e-4 (abs + rel).
* `build_generate_fn`: a left-padded B = 3 batch with one dead row and
  [B, 1, S, S, 3] tile stacks; and a `first_token` that forces [DET] to
  run the [EMB] countdown. `out_tokens` and `num_generated` must be
  identical, `out_hidden` and `out_logprobs` within 1e-4, and so must the
  tools' text queries `extract_tool_queries_from_generation` gathers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.generation import (
    extract_tool_queries_from_generation as jax_tool_queries)
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.ops.quant import quantize_serving_params
from visionllm_tpu_torch.config import LLMConfig, tiny_test_config
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.generation import (
    extract_tool_queries_from_generation as tool_queries)
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = 1e-4
MAX_NEW, MAX_LEN = 8, 64


def _jax_cfg(quant):
    cfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                          use_ip2p=False, use_region_encoder=False)
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            quant=quant))


def _port_cfg(quant):
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            quant=quant))


def _batch(cfg, tid):
    """Three left-padded rows: two with an image, one text-only; row 2
    is dead."""
    rng = np.random.default_rng(0)
    size = cfg.vis_encoder.image_size
    img_len = cfg.vis_encoder.num_patches
    L = img_len + 12
    ids = np.zeros((3, L), np.int32)
    mask = np.zeros((3, L), bool)
    rows = [[1] + [tid.imp] * img_len + list(rng.integers(4, 90, 6)),
            [1] + list(rng.integers(4, 90, 9)),
            [1] + [tid.imp] * img_len + list(rng.integers(4, 90, 11))]
    for b, r in enumerate(rows):
        ids[b, L - len(r):] = r
        mask[b, L - len(r):] = True
    imgs = (0.5 * rng.standard_normal((3, 1, size, size, 3))).astype(
        np.float32)
    imgs[1] = 0.0
    live = np.asarray([True, True, False])
    return ids, imgs, mask, live


@pytest.fixture(scope="module", params=["", "int4"])
def models(request):
    quant = request.param
    torch.set_num_threads(1)
    jcfg = _jax_cfg(quant)
    jtid = JaxTid.synthetic()
    jcore = JaxCore(_jax_cfg(""), dtype=jnp.float32)
    ids, imgs, mask, live = _batch(jcfg, jtid)
    params = jax.jit(lambda r: jcore.init(
        r, jnp.asarray(ids[:1]), jnp.asarray(imgs[:1, 0]), jtid))(
            jax.random.PRNGKey(0))["params"]
    if quant == "int4":
        params = quantize_serving_params(params, bits=4)
        jcore = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    tcore = build_core(_port_cfg(quant), device="cpu", dtype=torch.float32)
    load_jax_params(tcore, params)
    return quant, jcore, params, tcore


def test_llama_prefill_then_decode_matches_jax(models):
    from visionllm_tpu.models.llama import KVCache as JaxCache
    from visionllm_tpu.models.llama import LlamaModel as JaxLlama
    from visionllm_tpu_torch.models.llama import KVCache
    quant, jcore, params, tcore = models
    jllm, lp = JaxLlama(jcore.cfg.llm, jnp.float32), params["llm"]
    cfg = tcore.cfg.llm
    rng = np.random.default_rng(1)
    B, L = 2, 9
    x = (0.5 * rng.standard_normal((B, L, cfg.hidden_size))).astype(
        np.float32)
    pos = np.tile(np.arange(L, dtype=np.int32)[None], (B, 1))
    mask = np.ones((B, L), np.int32)
    mask[1, :3] = 0
    dmask = np.concatenate([mask, np.ones((B, MAX_LEN - L), np.int32)], 1)
    jc = JaxCache.create(jcore.cfg.llm, B, MAX_LEN, dtype=jnp.float32)
    tc = KVCache.create(cfg, B, MAX_LEN, torch.float32, "cpu")
    apply = jax.jit(lambda p, e, ps, c, m: jllm.apply(
        {"params": p}, e, ps, attn_mask=m, cache=c))
    jh, jl, jc = apply(lp, x, pos, jc, mask)
    with torch.no_grad():
        th, tl = tcore.llm(torch.from_numpy(x), torch.from_numpy(pos).long(),
                           attn_mask=torch.from_numpy(mask), cache=tc)
    pairs = [(jh, th), (jl, tl)]
    for step in range(3):
        e = (0.5 * rng.standard_normal((B, 1, cfg.hidden_size))).astype(
            np.float32)
        p1 = np.full((B, 1), L + step, np.int32)
        jh, jl, jc = apply(lp, e, p1, jc, dmask)
        with torch.no_grad():
            th, tl = tcore.llm(torch.from_numpy(e),
                               torch.from_numpy(p1).long(),
                               attn_mask=torch.from_numpy(dmask), cache=tc)
        pairs += [(jh, th), (jl, tl)]
    assert tc.index == int(jc.index) == L + 3
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"{quant} output {i}")


@pytest.mark.parametrize("force_det", [False, True],
                         ids=["left_padded_dead_row", "det_countdown"])
def test_generate_matches_jax(models, force_det):
    quant, jcore, params, tcore = models
    jtid, tid = JaxTid.synthetic(), SpecialTokenIds.synthetic()
    ids, imgs, mask, live = _batch(jcore.cfg, jtid)
    first = np.full((3,), tid.det, np.int32) if force_det else None
    jgen = jax_generate_fn(jcore, jtid, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)
    want = jgen(params, jnp.asarray(ids), jnp.asarray(imgs),
                first_token=None if first is None else jnp.asarray(first),
                attn_mask=jnp.asarray(mask), live=jnp.asarray(live))
    tgen = build_generate_fn(tcore, tid, max_new_tokens=MAX_NEW,
                             max_len=MAX_LEN)
    got = tgen(torch.from_numpy(ids).long(), torch.from_numpy(imgs),
               first_token=None if first is None else torch.from_numpy(first),
               attn_mask=torch.from_numpy(mask), live=torch.from_numpy(live))
    assert got["num_generated"] == int(want["num_generated"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    if force_det:
        np.testing.assert_array_equal(
            got["out_tokens"].numpy()[:2, :5],
            [[tid.det, tid.emb, tid.emb + 1, tid.emb + 2, tid.emb + 3]] * 2)
    for key in ("out_hidden", "out_logprobs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    # the tools' text queries gathered from the recorded hidden states
    jq = jax_tool_queries(jcore.cfg, jtid, want["out_tokens"],
                          want["out_hidden"])
    tq = tool_queries(tcore.cfg, tid, got["out_tokens"], got["out_hidden"])
    for name in ("det", "pose", "gen", "edit"):
        np.testing.assert_array_equal(tq[name][1].numpy(),
                                      np.asarray(jq[name][1]))
        np.testing.assert_allclose(tq[name][0].numpy(),
                                   np.asarray(jq[name][0]), atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert bool(tq["det"][1][0, 0]) == force_det


def test_port_config_rejects_modes_not_ported():
    """The int8 serving modes construct (int8 and w8a8 weights, the int8
    KV cache), and so do both rematerialization modes (ported); a remat
    mode JAX does not have raises."""
    for kw in (dict(quant="int8"), dict(quant="w8a8"),
               dict(kv_quant="int8")):
        cfg = LLMConfig(**kw)
        assert (cfg.quant, cfg.kv_quant) == (kw.get("quant", ""),
                                             kw.get("kv_quant", ""))
    for mode in ("full", "dots"):
        assert LLMConfig(remat=mode).remat == mode
    with pytest.raises(ValueError, match="remat='offload'"):
        LLMConfig(remat="offload")
