"""The port's temperature / top-p sampling (`generation.sample_token`,
`nucleus_filter`, `build_generate_fn(sampling=True)`) against the JAX
package on the CPU.

The port draws from a `torch.Generator` and cannot reproduce
`jax.random`'s bits, so draws are compared by their support and
distribution, and greedy rows exactly:

* temperature-0 rows give JAX's greedy ids;
* the nucleus the port keeps for fixed logits (ties included) is the set
  JAX's `sample_token` draws from over many keys;
* top_p -> 0 keeps only the argmax, at any temperature, as in JAX;
* a mixed batch keeps its greedy rows greedy and its hot rows in their
  nucleus;
* the same generator seed gives the same draws, another seed other ones;
* a chi-square of 20000 draws against the filtered softmax, computed in
  numpy, at p > 1e-4;
* `build_generate_fn(sampling=True)` at temperature 0 gives JAX's tokens
  at the tiny config, with a [DET] countdown intact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.stats import chi2

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.generation import sample_token as jax_sample_token
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.generation import (build_generate_fn,
                                            nucleus_filter, sample_token)
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rows(value, B):
    return torch.full((B,), value, dtype=torch.float32)


def test_temperature_zero_rows_are_jax_greedy():
    logits = np.random.RandomState(0).normal(0, 2, (5, 40)).astype(
        np.float32)
    want = np.asarray(jax_sample_token(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.zeros((5,)),
        jnp.full((5,), 0.5)))
    got = sample_token(torch.from_numpy(logits), _gen(0), _rows(0.0, 5),
                       _rows(0.5, 5))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, logits.argmax(-1))


# (logits, top_p): a spread distribution, ties ordered by index (a stable
# sort of the negated logits, as jnp.argsort), and a near one-hot
NUCLEI = {
    "spread": (np.log([0.3, 0.25, 0.2, 0.15, 0.1]), 0.7),
    "ties": (np.asarray([1.0, 0.0, 1.0, 1.0, -1.0]), 0.5),
    "ties_wide": (np.asarray([2.0, 2.0, 0.5, 2.0, 0.5, 0.5]), 0.9),
}


@pytest.mark.parametrize("name", sorted(NUCLEI))
def test_nucleus_is_jax_support(name):
    logits, top_p = NUCLEI[name]
    logits = logits.astype(np.float32)
    kept = torch.isfinite(nucleus_filter(
        torch.from_numpy(logits)[None], torch.tensor([top_p])))[0]
    draw = jax.jit(jax.vmap(lambda k: jax_sample_token(
        jnp.asarray(logits)[None], k, jnp.ones((1,)),
        jnp.full((1,), top_p))[0]))
    seen = set(np.asarray(draw(jax.random.split(jax.random.PRNGKey(0),
                                                400))).tolist())
    assert seen == set(np.nonzero(kept.numpy())[0].tolist())
    # the port's own draws stay inside it
    got = sample_token(torch.from_numpy(logits)[None].expand(400, -1),
                       _gen(1), _rows(1.0, 400), _rows(top_p, 400))
    assert set(got.tolist()) == seen


def test_top_p_one_hot_limit():
    logits = np.random.RandomState(0).normal(0, 2, (4, 50)).astype(
        np.float32)
    want = np.asarray(jax_sample_token(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.full((4,), 3.0),
        jnp.full((4,), 1e-6)))
    for seed in range(3):
        got = sample_token(torch.from_numpy(logits), _gen(seed),
                           _rows(3.0, 4), _rows(1e-6, 4))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, logits.argmax(-1))


def test_per_row_mixed_batch():
    """Rows 0 and 2 greedy (one with a nucleus), rows 1 and 3 hot with
    and without one: greedy rows are JAX's argmax whatever the draw, hot
    rows vary with the seed and stay in their nucleus."""
    logits = np.random.RandomState(1).normal(0, 1, (4, 30)).astype(
        np.float32)
    t = torch.tensor([0.0, 2.0, 0.0, 2.0])
    p = torch.tensor([1.0, 0.6, 0.3, 1.0])
    jgreedy = np.asarray(jax_sample_token(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(t.numpy()),
        jnp.asarray(p.numpy())))[[0, 2]]
    kept = torch.isfinite(nucleus_filter(torch.from_numpy(logits) / 2.0, p))
    hot = set()
    for seed in range(8):
        got = sample_token(torch.from_numpy(logits), _gen(seed), t, p)
        np.testing.assert_array_equal(got.numpy()[[0, 2]], jgreedy)
        assert kept[1, int(got[1])]
        hot.add((int(got[1]), int(got[3])))
    assert len(hot) > 1


def test_same_generator_same_draws():
    logits = torch.from_numpy(np.random.RandomState(2).normal(
        0, 1, (16, 64)).astype(np.float32))
    draw = [sample_token(logits, _gen(s), _rows(1.5, 16), _rows(0.9, 16))
            for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])


def _filtered_softmax(logits, temperature, top_p):
    """The nucleus distribution in numpy: sort descending (stable), keep
    while the preceding mass is below top_p, renormalise."""
    s = logits.astype(np.float64) / temperature
    order = np.argsort(-s, kind="stable")
    p = np.exp(s[order] - s[order].max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    out = np.zeros_like(p)
    out[keep] = p[keep] / p[keep].sum()
    return out[np.argsort(order)]


def test_draws_follow_filtered_softmax():
    logits = np.asarray([1.2, 0.3, -0.4, 0.9, 0.0, -2.0, 0.5], np.float32)
    T, top_p, N = 0.7, 0.8, 20000
    probs = _filtered_softmax(logits, T, top_p)
    got = sample_token(torch.from_numpy(logits)[None].expand(N, -1),
                       _gen(3), _rows(T, N), _rows(top_p, N)).numpy()
    counts = np.bincount(got, minlength=len(logits))
    support = probs > 0
    assert not counts[~support].any()
    exp = probs[support] * N
    stat = float((((counts[support] - exp) ** 2) / exp).sum())
    assert stat < chi2.ppf(1 - 1e-4, support.sum() - 1), (counts, exp)


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    jtid = JaxTid.synthetic()
    size = jcfg.vis_encoder.image_size
    ids = [1, 5, 6] + [jtid.imp] * jcfg.vis_encoder.num_patches + [7]
    img = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    params = jax.jit(lambda r: jcore.init(
        r, jnp.asarray([ids], jnp.int32), jnp.asarray(img), jtid))(
            jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)
    tcore = build_core(tiny_test_config(use_gdino=False, gdino=None),
                       device="cpu", dtype=torch.float32)
    load_jax_params(tcore, params)
    return jcore, params, tcore, np.asarray([ids], np.int32), img


@pytest.mark.parametrize("force_det", [False, True])
def test_sampling_generate_at_temperature_zero_is_jax(models, force_det):
    jcore, params, tcore, ids, img = models
    tid = SpecialTokenIds.synthetic()
    first = tid.det if force_det else None
    jgen = jax_generate_fn(jcore, JaxTid.synthetic(), max_new_tokens=8,
                           max_len=96, sampling=True)
    want = jgen(params, jnp.asarray(ids), jnp.asarray(img),
                first_token=None if first is None else jnp.asarray([first]),
                rng=jax.random.PRNGKey(5), temperature=0.0, top_p=0.5)
    tgen = build_generate_fn(tcore, tid, max_new_tokens=8, max_len=96,
                             sampling=True)
    got = tgen(torch.from_numpy(ids).long(), torch.from_numpy(img),
               first_token=None if first is None else torch.tensor([first]),
               generator=_gen(5), temperature=0.0, top_p=0.5)
    assert got["num_generated"] == int(want["num_generated"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    np.testing.assert_allclose(got["out_logprobs"].numpy(),
                               np.asarray(want["out_logprobs"]), atol=1e-4,
                               rtol=1e-4)
    if force_det:
        assert got["out_tokens"][0, :5].tolist() == \
            [tid.det] + [tid.emb + i for i in range(4)]


def test_sampling_generate_same_seed_same_tokens(models):
    _, _, tcore, ids, img = models
    tgen = build_generate_fn(tcore, SpecialTokenIds.synthetic(),
                             max_new_tokens=8, max_len=96, sampling=True)
    runs = [tgen(torch.from_numpy(ids).long(), torch.from_numpy(img),
                 generator=_gen(s), temperature=1.5)["out_tokens"]
            for s in (4, 4, 9, 10, 11)]
    assert torch.equal(runs[0], runs[1])
    assert any(not torch.equal(runs[0], r) for r in runs[2:])
