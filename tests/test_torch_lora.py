"""LoRA in the port against the JAX package on the CPU, in fp32: the
`LoraLinear` layer (1e-5) and a LoRA LLaMA (1e-4) on JAX's parameters,
a fresh adapter adding nothing, `merge_lora_params` against JAX's merge
(1e-6) and the merged model's logits against the LoRA model's (1e-4),
the frozen predicate against JAX's on every path of a LoRA composite,
`load_jax_params` of a JAX LoRA tree (and its refusal of a tree without
the factors), and LoRA taking priority over `quant` in the layers while
`lm_head` stays quantized, as in JAX."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.llama import LlamaModel as JLlama
from visionllm_tpu.models.lora import LoraDense
from visionllm_tpu.models.lora import lora_frozen_predicate as jfrozen
from visionllm_tpu.models.lora import merge_lora_params as jmerge
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.models.common import init_weights
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.llama import LlamaModel
from visionllm_tpu_torch.models.lora import (LoraLinear,
                                             lora_frozen_predicate,
                                             merge_lora_params)
from visionllm_tpu_torch.ops.quant import (Int8ActLinear, Int8Linear,
                                           quantize_serving_params)
from visionllm_tpu_torch.ops.quant4 import Int4Linear
from visionllm_tpu_torch.utils.convert import load_jax_params

LLM = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, lora_r=4,
           lora_alpha=16.0)
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


def _t(x):
    return torch.from_numpy(np.array(x))


def _llama_tree(seed, **kw):
    cfg = jconfig.LLMConfig(**dict(LLM, **kw))
    model = JLlama(cfg, dtype=jnp.float32)
    emb, pos = jnp.zeros((1, 3, LLM["hidden_size"])), jnp.arange(3)[None]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), emb,
                                               pos))["params"]
    tree = jax.tree.map(np.asarray, random_flax_params(shapes, seed))
    # the init runs no embedding lookup: the port's table comes along
    tree["embed_tokens"] = {"embedding": np.random.default_rng(seed).normal(
        0, 0.02, (LLM["vocab_size"], LLM["hidden_size"])).astype(np.float32)}
    return model, tree


def _inputs(seed, L=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, L, LLM["hidden_size"])).astype(
        np.float32), np.tile(np.arange(L), (2, 1)))


def test_lora_linear_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    jm = LoraDense(20, rank=4, alpha=64.0, dtype=jnp.float32)
    params = {"kernel": rng.standard_normal((12, 20)).astype(np.float32),
              "lora_a": rng.standard_normal((12, 4)).astype(np.float32),
              "lora_b": rng.standard_normal((4, 20)).astype(np.float32)}
    want = jm.apply({"params": params}, x)
    lin = LoraLinear(12, 20, 4, 64.0)
    load_jax_params(lin, params)
    np.testing.assert_array_equal(lin.lora_a.detach().numpy(),
                                  params["lora_a"])
    with torch.no_grad():
        got = lin(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fresh_lora_adds_nothing():
    """`init_weights` draws lora_a ~ N(0, 0.02) and zeroes lora_b (flax's
    initializers): a fresh LoRA layer is its base Linear exactly."""
    lin = LoraLinear(12, 20, 4)
    init_weights(lin, torch.Generator().manual_seed(0))
    assert torch.count_nonzero(lin.lora_b) == 0
    assert 0.01 < lin.lora_a.std().item() < 0.03
    x = torch.randn(3, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(lin(x), torch.nn.functional.linear(x, lin.weight))


def test_lora_llama_matches_jax():
    jmodel, params = _llama_tree(1)
    assert set(params["layers"]["layer"]["q_proj"]) == {"kernel", "lora_a",
                                                         "lora_b"}
    emb, pos = _inputs(2)
    _, want, _ = jmodel.apply({"params": params}, emb, pos)
    model = LlamaModel(tconfig.LLMConfig(**LLM))
    load_jax_params(model, params)
    assert all(isinstance(getattr(model.layers[0], n), LoraLinear)
               for n in PROJ)
    assert type(model.lm_head) is torch.nn.Linear
    with torch.no_grad():
        _, got = model(_t(emb), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_merge_matches_jax_merge():
    jmodel, params = _llama_tree(3)
    model = LlamaModel(tconfig.LLMConfig(**LLM))
    load_jax_params(model, params)
    merged = merge_lora_params(model.state_dict(), alpha=LLM["lora_alpha"])
    assert not any("lora_" in n for n in merged)
    plain = LlamaModel(tconfig.LLMConfig(**dict(LLM, lora_r=0)))
    plain.load_state_dict(merged)
    want_tree = jmerge(params, alpha=LLM["lora_alpha"])
    want = LlamaModel(tconfig.LLMConfig(**dict(LLM, lora_r=0)))
    load_jax_params(want, want_tree)
    for (n, a), b in zip(plain.state_dict().items(),
                         want.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    emb, pos = _inputs(4)
    with torch.no_grad():
        _, lora_logits = model(_t(emb), _t(pos))
        _, merged_logits = plain(_t(emb), _t(pos))
    np.testing.assert_allclose(merged_logits.numpy(), lora_logits.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_merge_folds_in_fp32_then_casts():
    lin = LoraLinear(8, 6, 2, 64.0).to(torch.bfloat16)
    init_weights(lin, torch.Generator().manual_seed(0))
    with torch.no_grad():
        lin.lora_b.normal_(0, 0.02, generator=torch.Generator().manual_seed(1))
    out = merge_lora_params(lin.state_dict())
    want = (lin.weight.float() + (lin.lora_a.float() @ lin.lora_b.float()
                                  ).T * 32.0).to(torch.bfloat16)
    assert out["weight"].dtype == torch.bfloat16
    assert torch.equal(out["weight"], want)


def test_frozen_predicate_matches_jax_on_a_lora_composite():
    cfg = tconfig.tiny_test_config(llm=dataclasses.replace(
        tconfig.tiny_test_config().llm, lora_r=2))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    assert sum("lora_" in n for n in names) == 2 * 7 * cfg.llm.num_layers
    for n in names:
        assert lora_frozen_predicate(n) == jfrozen(n.replace(".", "/")), n
    assert not lora_frozen_predicate("core.llm.layers.0.q_proj.lora_a")
    assert lora_frozen_predicate("core.llm.layers.0.q_proj.weight")
    assert not lora_frozen_predicate("gdino.bbox_embed.layers_0.weight")


def test_load_refuses_a_tree_without_the_factors():
    _, params = _llama_tree(5, lora_r=0)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(LlamaModel(tconfig.LLMConfig(**LLM)), params)


@pytest.mark.parametrize("quant,cls", [("int8", Int8Linear),
                                       ("w8a8", Int8ActLinear),
                                       ("int4", Int4Linear)])
def test_lora_takes_priority_over_quant(quant, cls):
    """JAX builds LoraDense layers and a quantized lm_head for lora_r > 0
    with `quant` set (`llama.py:82-95`, `:237-248`); the port's module
    takes JAX's tree leaf for leaf, and quantizing a dense LoRA model
    keeps its LoRA layers."""
    cfg = tconfig.LLMConfig(**dict(LLM, quant=quant))
    jm = JLlama(jconfig.LLMConfig(**dict(LLM, quant=quant)),
                dtype=jnp.float32)
    emb, pos = jnp.zeros((1, 3, LLM["hidden_size"])), jnp.arange(3)[None]
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), emb,
                                            pos)["params"])
    tree["embed_tokens"] = {"embedding": np.zeros(
        (LLM["vocab_size"], LLM["hidden_size"]), np.float32)}
    assert "lora_a" in tree["layers"]["layer"]["q_proj"]
    assert "kernel" not in tree["lm_head"]
    model = LlamaModel(cfg)
    assert all(type(getattr(model.layers[1], n)) is LoraLinear
               for n in PROJ)
    assert isinstance(model.lm_head, cls)
    load_jax_params(model, tree)
    dense = LlamaModel(tconfig.LLMConfig(**LLM))
    quantize_serving_params(dense, bits=4 if quant == "int4" else 8,
                            act=quant == "w8a8")
    assert all(type(getattr(dense.layers[0], n)) is LoraLinear
               for n in PROJ)
    assert isinstance(dense.lm_head, cls)
