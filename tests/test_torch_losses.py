"""Parity of the port's det training losses and their pieces against the
JAX package on the CPU, in fp32: config fields, box ops, the warmup +
cosine schedule, CDN queries and the dn loss, the Hungarian matcher,
point sampling, the Hungarian-matched detection loss over layers and the
LM cross entropy. The random draws are made by `jax.random` from the JAX
call's keys and fed to the port as tensors.

Tolerances: 1e-5 abs + rel (the same fp32 arithmetic); the Hungarian
matches are identical indices (the same solver, step for step, ties
included); uncertainty points are compared as sets (the order top-k
returns them in enters no loss).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visionllm_tpu.ops import box_ops as jbox
from visionllm_tpu.train import cdn as jcdn
from visionllm_tpu.train import losses as jlosses
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch.config import (GDinoConfig, OptimizerConfig,
                                        tiny_test_config)
from visionllm_tpu_torch.ops import box_ops as tbox
from visionllm_tpu_torch.train import cdn as tcdn
from visionllm_tpu_torch.train import losses as tlosses
from visionllm_tpu_torch.train import train_step as tstep

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def test_training_config_fields_match_jax():
    from visionllm_tpu.config import GDinoConfig as JG
    jg = {f.name: getattr(JG(), f.name) for f in dataclasses.fields(JG)}
    for f in dataclasses.fields(GDinoConfig):
        assert getattr(GDinoConfig(), f.name) == jg[f.name], f.name
    jo = jstep.OptimizerConfig()
    for f in dataclasses.fields(OptimizerConfig):
        assert getattr(OptimizerConfig(), f.name) == getattr(jo, f.name)
    # accumulation and rematerialization are ported; what JAX lacks raises
    assert OptimizerConfig(grad_accum_steps=2).grad_accum_steps == 2
    assert GDinoConfig(remat="dots").remat == "dots"
    with pytest.raises(ValueError, match="grad_accum_steps=0"):
        OptimizerConfig(grad_accum_steps=0)
    with pytest.raises(ValueError, match="remat='offload'"):
        GDinoConfig(remat="offload")


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0, 0.5, (2, 7, 2)),
                        rng.uniform(0.5, 1, (2, 7, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 0.5, (2, 5, 2)),
                        rng.uniform(0.5, 1, (2, 5, 2))], -1).astype(np.float32)
    np.testing.assert_allclose(tbox.box_area(_t(a)).numpy(),
                               np.asarray(jbox.box_area(a)), atol=TOL)
    for t_fn, j_fn in ((tbox.box_iou, jbox.box_iou),
                       (tbox.generalized_box_iou, jbox.generalized_box_iou)):
        got, want = t_fn(_t(a), _t(b)), j_fn(jnp.asarray(a), jnp.asarray(b))
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=TOL, rtol=TOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(warmup):
    ocfg = jstep.OptimizerConfig(total_steps=20, warmup_steps=warmup)
    init = ocfg.learning_rate if warmup == 0 else 0.0
    want = optax.warmup_cosine_decay_schedule(init, ocfg.learning_rate,
                                              max(warmup, 1), 20)
    got = tstep.warmup_cosine_decay_schedule(init, ocfg.learning_rate,
                                             max(warmup, 1), 20)
    for c in range(25):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# CDN, matcher, point sampling, losses
# ---------------------------------------------------------------------------

def test_cdn_queries_and_dn_loss_match_jax():
    gcfg = tiny_test_config().gdino
    rng = np.random.default_rng(1)
    Bn, Nn, P, C, T, Q = 2, 3, 5, 8, 16, 7
    targets = {"labels": rng.integers(0, 3, (Bn, Nn)).astype(np.int32),
               "boxes": np.concatenate([rng.uniform(0.3, 0.7, (Bn, Nn, 2)),
                                        rng.uniform(0.05, 0.3, (Bn, Nn, 2))],
                                       -1).astype(np.float32),
               "valid": np.asarray([[True, True, False], [True, True, True]])}
    tq = rng.standard_normal((Bn, P, C)).astype(np.float32)
    tq_mask = np.asarray([[True] * 3 + [False] * 2, [True] * 4 + [False]])
    key = jax.random.PRNGKey(3)
    kw = dict(dn_number=gcfg.dn_number, label_noise_ratio=0.9,
              box_noise_scale=1.0, num_queries=Q)
    jdn, jtg = jcdn.build_cdn_queries(
        key, jax.tree.map(jnp.asarray, targets), jnp.asarray(tq),
        jnp.asarray(tq_mask), **kw)
    # the draws of that call, by its own split
    r_lab, r_new, r_sign, r_part = jax.random.split(key, 4)
    shape = (Bn, jcdn.cdn_groups(gcfg.dn_number, Nn), 2, Nn)
    noise = {"flip": _t(jax.random.uniform(r_lab, shape)),
             "label": _t(jax.random.uniform(r_new, shape)),
             "sign": _t(jax.random.randint(r_sign, shape + (4,), 0, 2)
                        * 2.0 - 1.0).float(),
             "part": _t(jax.random.uniform(r_part, shape + (4,)))}
    tt = _tree_t(targets)
    tdn, ttg = tcdn.build_cdn_queries(noise, tt, _t(tq), _t(tq_mask), **kw)
    for k in ("query_label", "query_bbox"):
        np.testing.assert_allclose(tdn[k].numpy(), np.asarray(jdn[k]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tdn["attn_mask"].numpy(),
                                  np.asarray(jdn["attn_mask"]))
    assert tdn["pad_size"] == jdn["pad_size"]
    for k in jtg:
        np.testing.assert_allclose(ttg[k].numpy(), np.asarray(jtg[k]),
                                   atol=TOL)

    pad = tdn["pad_size"]
    logits = rng.standard_normal((Bn, pad, T)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (Bn, pad, 2)),
                            rng.uniform(0.05, 0.3, (Bn, pad, 2))],
                           -1).astype(np.float32)
    text_mask = np.arange(T)[None] < np.asarray([[3], [4]])
    want = jcdn.dn_loss(jnp.asarray(logits), jnp.asarray(boxes), jtg,
                        cfg=gcfg, text_mask=jnp.asarray(text_mask))
    got = tcdn.dn_loss(_t(logits), _t(boxes), ttg, cfg=gcfg,
                       text_mask=_t(text_mask))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=TOL)


def test_hungarian_match_identical_to_jax():
    rng = np.random.default_rng(2)
    for Q, Nn in ((20, 3), (30, 7), (9, 9), (900, 20)):
        cost = rng.standard_normal((4, Q, Nn)).astype(np.float32)
        cost[1, :, -2:] = jlosses.BIG           # padded target slots
        cost[2, :, 0] = jlosses.BIG
        cost[3] = np.round(cost[3])             # many exact ties
        want = np.asarray(jlosses.hungarian_match(jnp.asarray(cost)))
        got = tlosses.hungarian_match(_t(cost)).numpy()
        np.testing.assert_array_equal(got, want)


def test_point_sample_and_uncertainty_points_match_jax():
    rng = np.random.default_rng(4)
    masks = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (2, 3, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.point_sample(_t(masks), _t(pts), chunk=16).numpy(),
        np.asarray(jlosses.point_sample(jnp.asarray(masks),
                                        jnp.asarray(pts), chunk=16)),
        atol=TOL, rtol=TOL)
    key = jax.random.PRNGKey(5)
    want = jlosses.uncertainty_points(key, jnp.asarray(masks), 16, 3.0, 0.75)
    r1, r2 = jax.random.split(key)
    draws = (_t(jax.random.uniform(r1, (2, 3, 48, 2))),
             _t(jax.random.uniform(r2, (2, 3, 4, 2))))
    got = tlosses.uncertainty_points(draws, _t(masks), 16, 0.75)
    # the chosen set; top-k's order within it does not enter any loss
    np.testing.assert_allclose(np.sort(got.numpy(), axis=2),
                               np.sort(np.asarray(want), axis=2), atol=0)


def test_detection_loss_with_aux_matches_jax():
    gcfg = tiny_test_config().gdino
    rng = np.random.default_rng(6)
    L_, Bn, Q, T, Nn, hw = 2, 2, 10, 8, 3, 8
    outs = {
        "all_logits": rng.standard_normal((L_, Bn, Q, T)).astype(np.float32),
        "all_boxes": np.concatenate(
            [rng.uniform(0.2, 0.8, (L_, Bn, Q, 2)),
             rng.uniform(0.05, 0.4, (L_, Bn, Q, 2))], -1).astype(np.float32),
        "all_masks": rng.standard_normal((L_, Bn, Q, hw, hw)
                                         ).astype(np.float32),
        "enc_logits": rng.standard_normal((Bn, Q, T)).astype(np.float32),
        "enc_boxes": np.concatenate(
            [rng.uniform(0.2, 0.8, (Bn, Q, 2)),
             rng.uniform(0.05, 0.4, (Bn, Q, 2))], -1).astype(np.float32),
        "text_mask": np.arange(T)[None] < np.asarray([[3], [5]]),
    }
    targets = {"labels": np.asarray([[0, 2, 1], [1, 0, 0]], np.int32),
               "boxes": np.concatenate(
                   [rng.uniform(0.3, 0.7, (Bn, Nn, 2)),
                    rng.uniform(0.05, 0.3, (Bn, Nn, 2))], -1
               ).astype(np.float32),
               "valid": np.asarray([[True, True, False], [True, True, True]]),
               "masks": (rng.random((Bn, Nn, 2 * hw, 2 * hw)) > 0.5
                         ).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    want_total, want = jlosses.detection_loss_with_aux(
        jax.tree.map(jnp.asarray, outs), jax.tree.map(jnp.asarray, targets),
        cfg=gcfg, rng=key)
    points = []
    n_sampled = int(gcfg.num_mask_points * gcfg.oversample_ratio)
    n_rand = gcfg.num_mask_points - int(gcfg.importance_sample_ratio
                                        * gcfg.num_mask_points)
    for lvl in range(L_):
        r1, r2 = jax.random.split(jax.random.fold_in(key, lvl))
        points.append((_t(jax.random.uniform(r1, (Bn, Nn, n_sampled, 2))),
                       _t(jax.random.uniform(r2, (Bn, Nn, n_rand, 2)))))
    tt = _tree_t(targets)
    tt["labels"] = tt["labels"].long()
    got_total, got, _ = tlosses.detection_loss_with_aux(
        _tree_t(outs), tt, cfg=gcfg, points=points)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=TOL)


def test_lm_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :4] = -100
    want = float(jlosses.lm_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = tlosses.lm_cross_entropy(_t(logits), _t(labels).long()).item()
    np.testing.assert_allclose(got, want, rtol=TOL)
