"""Parity of the port's pose training path against the JAX package on the
CPU, in fp32, at the tiny test config (CLIP and LLaMA 2 layers; UniPose
d32 with 1 encoder and 3 decoder layers, 2 of them box layers, 4 body
points, 5 groups, Swin-T on a 128 px det image; CDN with dn_number 100,
so 33 groups of 2 x 3 dn queries ahead of the 20 box queries).

The flax tree's shapes come from `jax.eval_shape` and its values from
numpy (`random_flax_params`); the CDN draws are made by `jax.random`
from the JAX step's key through the same split chain and fed to the
port as tensors. The JAX side compiles at XLA optimization level 0
(`o0_jit`).

* `forward_pose`: every output of every decoder layer and the encoder,
  the dn outputs and dn_targets, within 1e-4 abs + rel (the padded text
  columns hold the fp32 minimum on both sides); and a model whose last
  decoder layer is a box layer (the expansion at the last layer), which
  JAX trains too.
* `pose_loss_with_aux` on JAX's outputs: every term within 1e-4.
* one step of `make_pose_train_step` against JAX's (stage-1 freezing,
  the real AdamW behind a gradient capture): the metrics, key for key,
  and the gradient norm within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_train import _capture_grads
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import cdn as jcdn
from visionllm_tpu.train import pose_losses as jpl
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch.config import OptimizerConfig, tiny_test_config
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train import pose_losses as tpl
from visionllm_tpu_torch.train import train_step as tstep
from visionllm_tpu_torch.train.runner import TrainConfig, frozen_predicate
from visionllm_tpu_torch.utils.convert import load_jax_params

DET = 128
B, N = 2, 3
TOL = dict(atol=1e-4, rtol=1e-4)
OPT = dict(learning_rate=1e-3, total_steps=1000)
KEY = 41


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_prompt(tid, n_img, n_kpt, num_embs=4):
    embs = [tid.emb + i for i in range(num_embs)]
    ids = [1, 10, 11] + [tid.imp] * n_img + [12, tid.det] + embs + [13]
    for k in range(n_kpt):
        ids += [tid.pose] + embs + [20 + k]
    return ids + [2]


def _batch_np(cfg, tid, nb):
    ids = np.asarray([_pose_prompt(tid, cfg.vis_encoder.num_patches, 4)] * B,
                     np.int32)
    rng = np.random.default_rng(5)
    size = cfg.vis_encoder.image_size
    mask = np.ones((B, DET, DET), bool)
    mask[1, 96:] = False
    cxcy = rng.uniform(0.3, 0.7, (B, N, 2))
    wh = rng.uniform(0.05, 0.3, (B, N, 2))
    kpts = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2 * nb)),
                           rng.random((B, N, nb)) > 0.3], -1)
    return {
        "input_ids": ids,
        "labels": np.where(ids >= 10, ids, -100).astype(np.int32),
        "attn_mask": np.ones_like(ids),
        "images": (0.5 * rng.standard_normal((B, size, size, 3))
                   ).astype(np.float32),
        "images_aug": (0.5 * rng.standard_normal((B, DET, DET, 3))
                       ).astype(np.float32),
        "pixel_mask": mask,
        "targets": {
            "labels": np.zeros((B, N), np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "keypoints": kpts.astype(np.float32),
            "area": (wh[..., 0] * wh[..., 1]).astype(np.float32),
            "valid": np.asarray([[True, True, False], [True, True, True]]),
        },
    }


def _port_batch(b):
    out = {k: _t(v) if not isinstance(v, dict) else
           {kk: _t(vv) for kk, vv in v.items()} for k, v in b.items()}
    for k in ("input_ids", "labels", "attn_mask"):
        out[k] = out[k].long()
    out["targets"]["labels"] = out["targets"]["labels"].long()
    return out


def jax_pose_noise(key, dn_number, labels_shape):
    """The CDN draws of one JAX pose step with key `key` in the port's
    `draw_pose_noise` layout (split(key) -> dn; split(dn, 4))."""
    rng_dn, _ = jax.random.split(key)
    Bn, Nn = labels_shape
    shape = (Bn, jcdn.cdn_groups(dn_number, Nn), 2, Nn)
    r_lab, r_new, r_sign, r_part = jax.random.split(rng_dn, 4)
    cdn = {"flip": jax.random.uniform(r_lab, shape),
           "label": jax.random.uniform(r_new, shape),
           "sign": jax.random.randint(r_sign, shape + (4,), 0, 2) * 2.0 - 1.0,
           "part": jax.random.uniform(r_part, shape + (4,))}
    return {"cdn": {k: _t(v).float() for k, v in cdn.items()}}


def _jax_frozen(path):
    return path.startswith(("core/vis_encoder", "core/llm"))


def _setup(decoder_layers):
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jcfg = dataclasses.replace(jcfg, unipose=dataclasses.replace(
        jcfg.unipose, decoder_layers=decoder_layers))
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    nb = jcfg.unipose.num_body_points
    bnp = _batch_np(jcfg, jtid, nb)
    jbatch = jax.tree.map(jnp.asarray, bnp)

    def init_method(m, batch, tid):
        m.core(batch["input_ids"], batch["images"], tid, compute_logits=True)
        return m.forward_pose(batch, tid, 1, jax.random.PRNGKey(0))

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jbatch, jtid, method=init_method), jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 3))
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    cfg = dataclasses.replace(cfg, unipose=dataclasses.replace(
        cfg.unipose, decoder_layers=decoder_layers))
    tmodel = build_model(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)
    fwd = o0_jit(lambda p, b, r: jmodel.apply(
        {"params": p}, b, jtid, 1, jax.random.split(r)[0],
        method=JaxModel.forward_pose))
    return dict(jcfg=jcfg, jtid=jtid, jmodel=jmodel, jbatch=jbatch,
                params=params, cfg=cfg, tid=SpecialTokenIds.synthetic(),
                tmodel=tmodel, tbatch=_port_batch(bnp), fwd=fwd)


@pytest.fixture(scope="module")
def setup():
    return _setup(3)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=name, **TOL)


def _check_forward(s, want=None):
    key = jax.random.PRNGKey(KEY)
    if want is None:
        want = s["fwd"](s["params"], s["jbatch"], key)
    noise = jax_pose_noise(key, s["cfg"].unipose.dn_number, (B, N))
    with torch.no_grad():
        got = s["tmodel"].forward_pose(s["tbatch"], s["tid"], 1,
                                       dn_noise=noise["cdn"])
    np.testing.assert_allclose(got["lm_loss"].item(), float(want["lm_loss"]),
                               rtol=1e-4)
    gp, wp = got["pose"], want["pose"]
    n_layers = s["cfg"].unipose.decoder_layers
    for key_ in ("all_logits", "all_boxes", "all_keypoints", "dn_logits",
                 "dn_boxes"):
        assert len(gp[key_]) == len(wp[key_]) == n_layers, key_
        for lvl, (g, w) in enumerate(zip(gp[key_], wp[key_])):
            _close(g, w, f"{key_}[{lvl}]")
    for key_ in ("pred_logits", "pred_boxes", "pred_keypoints",
                 "enc_logits", "enc_boxes"):
        _close(gp[key_], wp[key_], key_)
    for key_, w in wp["dn_targets"].items():
        np.testing.assert_array_equal(gp["dn_targets"][key_].numpy(),
                                      np.asarray(w), err_msg=key_)
    return got, want


@pytest.fixture(scope="module")
def jax_out(setup):
    return setup["fwd"](setup["params"], setup["jbatch"],
                        jax.random.PRNGKey(KEY))


def test_forward_pose_matches_jax(setup, jax_out):
    _check_forward(setup, jax_out)


def test_forward_pose_with_the_expansion_at_the_last_layer():
    """decoder_layers == num_box_decoder_layers: every layer is a box
    layer and pred_keypoints are zero, in JAX's training forward and the
    port's."""
    s = _setup(2)
    got, _ = _check_forward(s)
    pose = got["pose"]
    assert pose["pred_logits"].shape[1] == s["cfg"].unipose.num_queries
    assert not pose["pred_keypoints"].any()


def test_pose_loss_with_aux_matches_jax(setup, jax_out):
    """The matchers and losses alone, on JAX's forward outputs."""
    s = setup
    keys = ("all_logits", "all_boxes", "all_keypoints", "enc_logits",
            "enc_boxes")
    pose = jax.tree.map(np.asarray, {k: jax_out["pose"][k] for k in keys})
    want_total, want = o0_jit(lambda o, t: jpl.pose_loss_with_aux(
        o, t, cfg=s["jcfg"].unipose))(pose, s["jbatch"]["targets"])
    got_total, got, matches = tpl.pose_loss_with_aux(
        {k: ([_t(x) for x in pose[k]] if isinstance(pose[k], list)
             else _t(pose[k])) for k in keys},
        s["tbatch"]["targets"], cfg=s["cfg"].unipose)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **TOL)
    np.testing.assert_allclose(got_total.item(), float(want_total), **TOL)
    # the matchings, handed back, repeat the same losses
    again, _, _ = tpl.pose_loss_with_aux(
        {k: ([_t(x) for x in pose[k]] if isinstance(pose[k], list)
             else _t(pose[k])) for k in keys},
        s["tbatch"]["targets"], cfg=s["cfg"].unipose, matches=matches)
    assert again.item() == got_total.item()


def test_oks_and_sigmas_match_jax():
    rng = np.random.default_rng(2)
    for K in (4, 14, 17, 68):
        np.testing.assert_array_equal(tpl.pose_sigmas(K), jpl.pose_sigmas(K))
    K = 17
    p, g = rng.random((3, 5, K, 2)), rng.random((3, 5, K, 2))
    v = (rng.random((3, 5, K)) > 0.4).astype(np.float32)
    area = rng.uniform(0.01, 0.3, (3, 5)).astype(np.float32)
    sig = jpl.pose_sigmas(K)
    want = jpl.oks(jnp.asarray(p, jnp.float32), jnp.asarray(g, jnp.float32),
                   jnp.asarray(v), jnp.asarray(area), jnp.asarray(sig))
    got = tpl.oks(_t(p).float(), _t(g).float(), _t(v), _t(area), _t(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_pose_step_matches_jax(setup):
    """One AdamW step of the stage-1 frozen model: metrics (the keys JAX
    reports: no `aux` terms) and the gradient norm against the JAX step's
    trainable gradients."""
    s = setup
    tx = jstep.build_optimizer(
        jstep.OptimizerConfig(**OPT),
        jstep.split_frozen(s["params"], _jax_frozen)[0])
    tx = optax.chain(_capture_grads(), tx)
    state = jstep.TrainState.create(s["params"], tx, frozen=_jax_frozen)
    fn = o0_jit(jstep.make_pose_train_step(s["jmodel"], tx, s["jtid"], 1,
                                           frozen=_jax_frozen))
    key = jax.random.PRNGKey(KEY)
    jstate, want = fn(state, s["jbatch"], key)
    grads = jax.tree_util.tree_leaves(jstate.opt_state[0])
    want = {k: float(v) for k, v in want.items()}
    want["grad_norm"] = float(np.sqrt(sum(
        np.sum(np.asarray(g, np.float64) ** 2) for g in grads)))

    model = build_model(s["cfg"], device="cpu", dtype=torch.float32)
    load_jax_params(model, s["params"])
    frozen = frozen_predicate(TrainConfig(freeze_llm=True), s["cfg"])
    ttx = tstep.build_optimizer(OptimizerConfig(**OPT), model, frozen)
    tstate = tstep.TrainState.create(model, ttx, frozen)
    step = tstep.make_pose_train_step(model, ttx, s["tid"], 1, frozen)
    tstate, got = step(tstate, s["tbatch"], noise=jax_pose_noise(
        key, s["cfg"].unipose.dn_number, (B, N)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), v, err_msg=k, **TOL)
    assert tstate.step == 1
