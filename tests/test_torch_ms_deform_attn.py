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


def _model_inputs(seed, ref_dim, B=2, H=4, D=8, Q=13, P=4, shapes=SHAPES):
    """Locations built as the port's `DeformableAttention` builds them
    (`visionllm_tpu_torch/models/grounding_dino/layers.py`): reference
    points plus sampling offsets, over each level's (w, h) for 2-d
    references (encoder), or `ref[:2] + off / P * ref[2:] * 0.5` for 4-d
    boxes (decoder); the weights a softmax over the L x P samples."""
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    off = rng.normal(0.0, 2.0, (B, Q, H, L, P, 2)).astype(np.float32)
    if ref_dim == 2:
        ref = rng.uniform(0.0, 1.0, (B, Q, L, 2)).astype(np.float32)
        norm = np.array([(w, h) for h, w in shapes], np.float32)
        locs = (ref[:, :, None, :, None, :]
                + off / norm[None, None, None, :, None, :])
    else:
        cxcy = rng.uniform(0.1, 0.9, (B, Q, L, 2))
        wh = rng.uniform(0.05, 0.6, (B, Q, L, 2))
        ref = np.concatenate([cxcy, wh], -1).astype(np.float32)
        locs = (ref[:, :, None, :, None, :2]
                + off / P * ref[:, :, None, :, None, 2:] * 0.5)
    logits = rng.standard_normal((B, Q, H, L * P))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (value, locs.astype(np.float32),
            attw.reshape(B, Q, H, L, P).astype(np.float32))


@pytest.mark.parametrize("ref_dim", [2, 4], ids=["points", "boxes"])
def test_plain_matches_jax_on_model_locations(ref_dim):
    """The plain forward and its value/location/weight gradients against
    `ms_deform_attn_reference` and `jax.grad` of it, on locations built
    as the model builds them; fp32, 1e-5 abs + rel."""
    torch.set_num_threads(1)
    value, locs, attw = _model_inputs(20 + ref_dim, ref_dim)
    want = np.asarray(ms_deform_attn_reference(
        jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(attw)))
    got = tmsda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs), torch.from_numpy(attw))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    gout = np.random.default_rng(ref_dim).standard_normal(
        want.shape).astype(np.float32)

    def f(v, l, a):
        return jnp.sum(ms_deform_attn_reference(v, SHAPES, l, a) * gout)
    wants = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attw))
    gots = tmsda.ms_deform_attn_bwd(
        torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
        torch.from_numpy(attw), torch.from_numpy(gout))
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("D,dtype,err", [
    (12, torch.bfloat16, ValueError),       # not 8 channels a load
    (36, torch.bfloat16, ValueError),
    (16, torch.float32, TypeError),          # the kernels read bf16 value
], ids=["d12", "d36", "fp32_value"])
def test_check_args_rejects_what_the_kernels_do_not_take(D, dtype, err):
    """The CUDA wrappers' argument checks, called on CPU tensors: the
    kernels load 8 channels of a value row at once, so D must be a
    multiple of 8."""
    L, P, Q = len(SHAPES), 2, 3
    S = sum(h * w for h, w in SHAPES)
    value = torch.zeros(1, S, 2, D, dtype=dtype)
    loc = torch.zeros(1, Q, 2, L, P, 2)
    attw = torch.zeros(1, Q, 2, L, P)
    with pytest.raises(err):
        tmsda._check_args(value, SHAPES, loc, attw)
    tmsda._check_args(value[..., :8].to(torch.bfloat16), SHAPES, loc, attw)
