"""Rematerialization in the port on the CPU, in fp32, mirroring the JAX
package's `tests/test_llama.py` (remat) and `tests/test_gdino_remat.py`:
for LLaMA (`LLMConfig.remat`, with LoRA factors among the parameters) and
Grounding-DINO (`GDinoConfig.remat`, with CDN queries), "dots" and
"full" give the loss and every gradient bit for bit equal to the port
without remat (the recomputed forward is the same arithmetic), and within
1e-4 of the JAX package's gradients under the same remat mode. The
launches of the layer's ops are counted through the recompute (a layer
runs twice under either mode), and an unknown mode raises."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.grounding_dino.model import (
    GroundingDino as JGDino)
from visionllm_tpu.models.llama import LlamaModel as JLlama
from visionllm_tpu.train import cdn as jcdn
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.models.grounding_dino import model as gd
from visionllm_tpu_torch.models.llama import LlamaModel
from visionllm_tpu_torch.models.remat import remat_call
from visionllm_tpu_torch.utils.convert import _emit, load_jax_params

LLM = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=3, num_heads=4, num_kv_heads=2, lora_r=2)
GD = dict(d_model=32, num_queries=12, encoder_layers=2, decoder_layers=2,
          num_heads=4, ffn_dim=64, text_dim=48, mask_dim=32, dn_number=4,
          max_text_len=48,
          backbone_overrides={"patch_size": 4, "embed_dim": 8,
                              "depths": (1, 1, 1, 1),
                              "num_heads": (2, 2, 4, 4), "window_size": 4})
IMG = 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def llama():
    torch.set_num_threads(1)
    jm = JLlama(jconfig.LLMConfig(**LLM), dtype=jnp.float32)
    emb, pos = jnp.zeros((1, 3, 32)), jnp.arange(3)[None]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), emb,
                                            pos))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 1))
    # nonzero LoRA factors, so their gradients carry the layer's
    params["layers"]["layer"]["q_proj"]["lora_b"] += 0.3
    # the init runs no embedding lookup; the port's table rides along
    params["embed_tokens"] = {"embedding": np.zeros((64, 32), np.float32)}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = np.tile(np.arange(9), (2, 1))
    return params, x, pos


def _jax_llama_grads(params, x, pos, remat):
    model = JLlama(jconfig.LLMConfig(**LLM, remat=remat), dtype=jnp.float32)

    def loss_fn(p):
        _, logits, _ = model.apply({"params": p}, x, pos)
        return jnp.mean(jax.nn.log_softmax(logits)[..., 0] ** 2)
    params = {k: v for k, v in params.items() if k != "embed_tokens"}
    loss, grads = o0_jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


def _port_llama_grads(params, x, pos, remat):
    model = LlamaModel(tconfig.LLMConfig(**LLM, remat=remat))
    load_jax_params(model, params)
    _, logits = model(_t(x), _t(pos))
    loss = torch.log_softmax(logits, -1)[..., 0].square().mean()
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()
                  if p.grad is not None}, model


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_llama_remat_bitwise_and_matches_jax(llama, mode):
    params, x, pos = llama
    l0, g0, _ = _port_llama_grads(params, x, pos, "")
    l1, g1, model = _port_llama_grads(params, x, pos, mode)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    jloss, jgrads = _jax_llama_grads(params, x, pos, mode)
    np.testing.assert_allclose(l1.item(), jloss, rtol=1e-6)
    want = {}
    _emit(model, "", jax.tree.map(np.asarray, jgrads), want)
    assert sorted(want) == sorted(g1)
    for n, w in want.items():
        np.testing.assert_allclose(g1[n].numpy(), w, err_msg=n, **TOL)


def jax_cdn_noise(key, B, N, dn_number):
    """The draws `build_cdn_queries(key, ...)` makes inside the JAX
    Grounding-DINO (split(key, 4)), in the port's `draw_cdn_noise`
    layout."""
    shape = (B, jcdn.cdn_groups(dn_number, N), 2, N)
    r_lab, r_new, r_sign, r_part = jax.random.split(key, 4)
    cdn = {"flip": jax.random.uniform(r_lab, shape),
           "label": jax.random.uniform(r_new, shape),
           "sign": jax.random.randint(r_sign, shape + (4,), 0, 2) * 2.0 - 1.0,
           "part": jax.random.uniform(r_part, shape + (4,))}
    return {k: _t(v).float() for k, v in cdn.items()}


def _gd_inputs():
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    tq = rng.standard_normal((1, 6, 4, 48)).astype(np.float32)
    tq_mask = np.ones((1, 6), bool)
    targets = {"labels": np.zeros((1, 3), np.int32),
               "boxes": np.asarray([[[0.5, 0.5, 0.2, 0.2],
                                     [0.3, 0.4, 0.1, 0.3],
                                     [0.7, 0.6, 0.2, 0.1]]], np.float32),
               "valid": np.ones((1, 3), bool)}
    return pixels, tq, tq_mask, targets


def _gd_loss(out):
    return (out["all_logits"].square().mean()
            + out["all_boxes"].square().mean()
            + out["dn_all_boxes"].square().mean())


@pytest.fixture(scope="module")
def gdino():
    torch.set_num_threads(1)
    pixels, tq, tq_mask, targets = _gd_inputs()
    jm = JGDino(jconfig.GDinoConfig(**GD))
    key = jax.random.PRNGKey(2)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(1), pixels, tq, tq_mask, targets=targets,
        dn_rng=key))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 3))
    noise = jax_cdn_noise(key, 1, 3, GD["dn_number"])
    return params, (pixels, tq, tq_mask, targets), key, noise


def _port_gd_grads(params, inputs, noise, remat):
    pixels, tq, tq_mask, targets = inputs
    model = gd.GroundingDino(tconfig.GDinoConfig(**GD, remat=remat))
    load_jax_params(model, params)
    tt = {k: _t(v) for k, v in targets.items()}
    tt["labels"] = tt["labels"].long()
    out = model(_t(pixels), _t(tq), _t(tq_mask), targets=tt,
                dn_noise=noise, all_layers=True)
    loss = _gd_loss(out)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()
                  if p.grad is not None}, model


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_gdino_remat_bitwise_and_matches_jax(gdino, mode):
    params, inputs, key, noise = gdino
    l0, g0, _ = _port_gd_grads(params, inputs, noise, "")
    l1, g1, model = _port_gd_grads(params, inputs, noise, mode)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    pixels, tq, tq_mask, targets = inputs
    jm = JGDino(jconfig.GDinoConfig(**GD, remat=mode))

    def loss_fn(p):
        out = jm.apply({"params": p}, pixels, tq, tq_mask, targets=targets,
                       dn_rng=key)
        return (jnp.mean(out["all_logits"] ** 2)
                + jnp.mean(out["all_boxes"] ** 2)
                + jnp.mean(out["dn_all_boxes"] ** 2))
    jloss, jgrads = o0_jit(jax.value_and_grad(loss_fn))(params)
    np.testing.assert_allclose(l1.item(), float(jloss), rtol=1e-5)
    want = {}
    _emit(model, "", jax.tree.map(np.asarray, jgrads), want)
    for n, g in g1.items():
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n,
                                   **TOL)


def test_remat_runs_the_layer_again_in_the_backward():
    """Under either mode the layer's forward runs once more in the
    backward (the MSDA and flash wrappers count their launches there);
    without autograd or without a mode it runs once."""
    calls = []

    def layer(x, w):
        calls.append(1)
        return torch.tanh(x @ w) @ w

    x = torch.randn(4, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    for mode, want in (("", 1), ("dots", 2), ("full", 2)):
        calls.clear()
        remat_call(mode, (torch.ops.aten.mm.default,), layer, x, w
                   ).sum().backward()
        assert len(calls) == want, mode
    calls.clear()
    with torch.no_grad():
        remat_call("full", (), layer, x, w)
    assert len(calls) == 1


@pytest.mark.parametrize("cls", [tconfig.LLMConfig, tconfig.GDinoConfig])
def test_unknown_remat_raises(cls):
    for mode in ("", "dots", "full"):
        assert cls(remat=mode).remat == mode
    with pytest.raises(ValueError, match="remat='everything'"):
        cls(remat="everything")
    with pytest.raises(ValueError, match="one of"):
        remat_call("save_all", (), lambda x: x, torch.ones(1,
                                                           requires_grad=True))


def test_remat_skipped_with_a_cache():
    """A decode (a KV cache given) never checkpoints: the cache is
    written in place and would be written twice."""
    cfg = tconfig.LLMConfig(**dict(LLM, lora_r=0, remat="full"))
    model = LlamaModel(cfg)
    from visionllm_tpu_torch.models.llama import KVCache
    cache = KVCache.create(cfg, 1, 8, torch.float32, "cpu")
    x = torch.randn(1, 3, 32)
    _, logits = model(x, torch.arange(3)[None], cache=cache)
    assert cache.index == 3 and logits.requires_grad
    assert dataclasses.replace(cfg, remat="").remat == ""
