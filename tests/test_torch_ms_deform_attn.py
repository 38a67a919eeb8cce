"""Parity of the port's MSDA plain version against the JAX
`ms_deform_attn_reference` and `ms_deform_attn_quad` on the CPU, with
locations outside [0, 1]. fp32, tolerance 1e-5.

The CUDA kernel itself is tested on a card in
`tests/test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.ops.ms_deform_attn import (ms_deform_attn_quad,
                                              ms_deform_attn_reference)
from visionllm_tpu_torch.ops import ms_deform_attn as tmsda

TOL = 1e-5
SHAPES = ((11, 17), (6, 9), (3, 5), (2, 3))


def _inputs(seed, B=2, H=4, D=8, Q=13, P=4, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, (B, Q, H, L, P, 2)).astype(np.float32)
    attw = rng.random((B, Q, H, L, P)).astype(np.float32)
    attw /= attw.reshape(B, Q, H, -1).sum(-1).reshape(B, Q, H, 1, 1)
    return value, locs, attw


@pytest.mark.parametrize("jax_fn", [ms_deform_attn_reference,
                                    ms_deform_attn_quad],
                         ids=["reference", "quad"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax(jax_fn, seed):
    torch.set_num_threads(1)
    value, locs, attw = _inputs(seed)
    want = np.asarray(jax_fn(jnp.asarray(value), SHAPES, jnp.asarray(locs),
                             jnp.asarray(attw)))
    got = tmsda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs), torch.from_numpy(attw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_fully_out_of_bounds_is_zero():
    value, locs, attw = _inputs(2)
    locs = locs + 3.0
    got = tmsda.ms_deform_attn_plain(torch.from_numpy(value), SHAPES,
                                     torch.from_numpy(locs),
                                     torch.from_numpy(attw))
    assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_gradients_match_jax_grad(seed):
    """Gradients of value, locations and weights of the plain MSDA (what
    the backward kernel computes, `ms_deform_attn_bwd` on the CPU)
    against `jax.grad` of `ms_deform_attn_reference`, with locations
    outside [0, 1] (out-of-range corners give zero gradient); fp32,
    1e-5 abs + rel."""
    torch.set_num_threads(1)
    value, locs, attw = _inputs(seed)
    gout = np.random.default_rng(seed + 10).standard_normal(
        (value.shape[0], locs.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)

    def f(v, l, a):
        return jnp.sum(ms_deform_attn_reference(v, SHAPES, l, a) * gout)
    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attw))
    got = tmsda.ms_deform_attn_bwd(
        torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
        torch.from_numpy(attw), torch.from_numpy(gout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_far_locations_have_zero_gradient():
    value, locs, attw = _inputs(4)
    gout = np.ones((2, locs.shape[1], value.shape[2] * value.shape[3]),
                   np.float32)
    gv, gl, ga = tmsda.ms_deform_attn_bwd(
        torch.from_numpy(value), SHAPES, torch.from_numpy(locs + 3.0),
        torch.from_numpy(attw), torch.from_numpy(gout))
    assert not gv.any() and not gl.any() and not ga.any()
