"""The port's CLIP text encoder (`models/stable_diffusion/clip_text.py`)
against the JAX package's on the CPU, in fp32, at a narrow config and at
SD-1.5's layout: the last hidden state within 1e-5 on JAX's parameters,
which `load_jax_params` maps leaf for leaf."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu.models.stable_diffusion import clip_text as jclip
from visionllm_tpu_torch.models.stable_diffusion import (ClipTextConfig,
                                                         ClipTextModel)
from visionllm_tpu_torch.utils.convert import load_jax_params

CONFIGS = {
    "tiny": dict(vocab_size=120, hidden_size=32, intermediate_size=64,
                 num_layers=2, num_heads=4, max_position_embeddings=16),
    "sd15_two_layers": dict(num_layers=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_clip_text_matches_jax(name):
    torch.set_num_threads(1)
    kw = CONFIGS[name]
    jm = jclip.ClipTextModel(jclip.ClipTextConfig(**kw))
    L = kw.get("max_position_embeddings", 77)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, kw.get("vocab_size", 49408), (2, L)).astype(
        np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            ids))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 1))
    want = o0_jit(lambda p, x: jm.apply({"params": p}, x))(params, ids)
    model = ClipTextModel(ClipTextConfig(**kw))
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
        short = model(torch.from_numpy(ids[:, :5]).long())
    assert got.shape == (2, L, kw.get("hidden_size", 768))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # causal: a prefix's states do not depend on the tokens after it
    np.testing.assert_allclose(short.numpy(), got[:, :5].numpy(), rtol=1e-5,
                               atol=1e-5)
