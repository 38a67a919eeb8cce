"""Parity of the port's det training path against the JAX package on the
CPU, in fp32, at `tiny_test_config` (CLIP 2 layers, LLaMA 2 layers,
Grounding-DINO 1 + 2 layers with Swin-T on a 128 px det image, CDN with
dn_number 4, 64 mask points). JAX params load into the port through
`load_jax_params`; the random draws (CDN noise, mask points) are made by
`jax.random` from the JAX step's keys, through the same `split` /
`fold_in` chain, and fed to the port as tensors.

Tolerances, each with its reason:
* elementwise pieces (CDN queries, box costs, point sampling, focal and
  dice terms): 1e-5 abs + rel, the same fp32 arithmetic;
* Hungarian matches: identical indices (same solver, step for step);
* model outputs after ~40 fp32 layers (logits, boxes, masks, losses):
  1e-4 abs + rel, as `tests/test_torch_composite.py`;
* gradients of the trainable parameters: relative L2 per tensor <= 1e-4
  (a backward doubles the chain and sums in another order), or, for the
  tensors whose exact gradient is zero, L2 <= 1e-8 of the global norm;
* parameters after two AdamW steps: the update of each tensor within
  1e-2 relative L2 of JAX's (Adam's first steps are lr g / (|g| + eps),
  which amplifies the gradients' rounding differences where |g| is
  small); tensors whose exact gradient is zero are only bounded, since
  Adam turns their rounding noise into steps of up to lr on both sides.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import cdn as jcdn
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch.config import OptimizerConfig, tiny_test_config
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train import train_step as tstep
from visionllm_tpu_torch.train.runner import TrainConfig, frozen_predicate
from visionllm_tpu_torch.utils.convert import _emit, load_jax_params

DET = 128
B, N = 2, 3
LR = 1e-3
OPT = dict(learning_rate=LR, total_steps=1000)
SEEDS = (31, 32)
TOL = 1e-5
MODEL_TOL = 1e-4
GRAD_REL = 1e-4
UPDATE_REL = 1e-2
# parameters whose exact gradient is zero: key biases under a softmax,
# biases right before a group norm
ZERO_GRAD = re.compile(r"((key|k_proj)\.bias|input_proj_\d\.bias|"
                       r"backbone\.out_norm\d\.bias)$")


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _batch_np(cfg, tid):
    img_len = cfg.vis_encoder.num_patches
    ids = ([1, 10, 11] + [tid.imp] * img_len + [12]
           + [tid.det] + [tid.emb + i for i in range(cfg.num_embs)] + [13]
           + [tid.det] + [tid.emb + i for i in range(cfg.num_embs)] + [2])
    input_ids = np.tile(np.asarray([ids], np.int32), (B, 1))
    rng = np.random.default_rng(0)
    size = cfg.vis_encoder.image_size
    cxcy = rng.uniform(0.3, 0.7, (B, N, 2))
    wh = rng.uniform(0.05, 0.25, (B, N, 2))
    masks = (rng.random((B, N, DET // 4, DET // 4)) > 0.5).astype(np.float32)
    return {
        "input_ids": input_ids,
        "labels": np.where(input_ids >= 10, input_ids, -100).astype(np.int32),
        "attn_mask": np.ones_like(input_ids),
        "images": (0.5 * rng.standard_normal((B, size, size, 3))
                   ).astype(np.float32),
        "images_aug": (0.5 * rng.standard_normal((B, DET, DET, 3))
                       ).astype(np.float32),
        "targets": {
            "labels": np.asarray([[0, 1, 0], [1, 0, 0]], np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "valid": np.asarray([[True, True, False], [True, True, True]]),
            "masks": masks,
        },
    }


def _port_batch(b):
    out = _tree_t(b)
    out["input_ids"] = out["input_ids"].long()
    out["labels"] = out["labels"].long()
    out["targets"]["labels"] = out["targets"]["labels"].long()
    return out


def jax_noise(key, gcfg, labels_shape):
    """The draws of one JAX det step with key `key`, in the port's
    `draw_step_noise` layout (the JAX chain: split(key) -> (dn, loss);
    split(dn, 4) -> the CDN draws; fold_in(loss, layer) -> split -> the
    candidate and random mask points)."""
    Bn, Nn = labels_shape
    rng_dn, rng_loss = jax.random.split(key)
    G = jcdn.cdn_groups(gcfg.dn_number, Nn)
    r_lab, r_new, r_sign, r_part = jax.random.split(rng_dn, 4)
    shape = (Bn, G, 2, Nn)
    cdn = {"flip": jax.random.uniform(r_lab, shape),
           "label": jax.random.uniform(r_new, shape),
           "sign": jax.random.randint(r_sign, shape + (4,), 0, 2) * 2.0 - 1.0,
           "part": jax.random.uniform(r_part, shape + (4,))}
    n_sampled = int(gcfg.num_mask_points * gcfg.oversample_ratio)
    n_unc = int(gcfg.importance_sample_ratio * gcfg.num_mask_points)
    points = []
    for lvl in range(gcfg.decoder_layers):
        r1, r2 = jax.random.split(jax.random.fold_in(rng_loss, lvl))
        points.append((
            _t(jax.random.uniform(r1, (Bn, Nn, n_sampled, 2))),
            _t(jax.random.uniform(r2, (Bn, Nn, gcfg.num_mask_points - n_unc,
                                       2)))))
    return {"cdn": {k: _t(v).float() for k, v in cdn.items()},
            "points": points}


def _jax_frozen(path):
    return path.startswith(("core/vis_encoder", "core/llm"))


def _port_frozen(cfg):
    return frozen_predicate(TrainConfig(freeze_llm=True), cfg)


def _capture_grads():
    """An optax transform that passes the gradients on and keeps them as
    its state: chained in front of the optimizer, the JAX step hands back
    the exact trainable gradients it computed."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _port_names(model, tree):
    """flax tree (None leaves dropped) -> {port name: array in port
    layout}."""
    def strip(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                v = strip(v)
                if v:
                    out[k] = v
            elif v is not None:
                out[k] = np.asarray(v)
        return out
    arrays = {}
    _emit(model, "", strip(tree), arrays)
    return arrays


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_unipose=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    bnp = _batch_np(jcfg, jtid)
    jbatch = jax.tree.map(jnp.asarray, bnp)
    params = jax.jit(lambda r: jmodel.init(r, jbatch, jtid))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = tiny_test_config(use_unipose=False, unipose=None)
    tid = SpecialTokenIds.synthetic()
    tmodel = build_model(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)
    return dict(jcfg=jcfg, jtid=jtid, jmodel=jmodel, jbatch=jbatch,
                params=params, cfg=cfg, tid=tid, tmodel=tmodel,
                tbatch=_port_batch(bnp), initial={
                    n: p.detach().clone()
                    for n, p in tmodel.named_parameters()})


def test_frozen_predicate_matches_jax(setup):
    """The port's predicate on dotted paths freezes exactly what the JAX
    one freezes on flax paths, for each freezing switch."""
    s = setup
    for kw in ({}, {"freeze_llm": True}, {"freeze_backbone": True},
               {"freeze_vis_encoder": False}):
        jf = jrunner.frozen_predicate(jrunner.TrainConfig(**kw), s["jcfg"])
        tf = frozen_predicate(TrainConfig(**kw), s["cfg"])
        flags = jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.full(np.shape(leaf),
                                       float(jf(jstep._path_str(path)))),
            s["params"])
        mapped = _port_names(s["tmodel"], flags)
        assert set(mapped) == {n for n, _ in
                               s["tmodel"].named_parameters()}
        for pname, flag in mapped.items():
            assert tf(pname) == bool(flag.reshape(-1)[0]), pname


# ---------------------------------------------------------------------------
# the model's training forward and the train step
# ---------------------------------------------------------------------------

def test_forward_det_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(11)
    rng_dn, _ = jax.random.split(key)
    want = jax.jit(lambda p, b, r: s["jmodel"].apply(
        {"params": p}, b, s["jtid"], r,
        method=JaxModel.forward_det))(s["params"], s["jbatch"], rng_dn)
    noise = jax_noise(key, s["jcfg"].gdino, s["jbatch"]["targets"]["labels"]
                      .shape)
    with torch.no_grad():
        got = s["tmodel"].forward_det(s["tbatch"], s["tid"],
                                      dn_noise=noise["cdn"])
    np.testing.assert_allclose(got["lm_loss"].item(), float(want["lm_loss"]),
                               rtol=MODEL_TOL)
    assert got["ignore_flag"].item() == float(want["ignore_flag"]) == 0.0
    gd, wd = got["det"], want["det"]
    np.testing.assert_array_equal(gd["text_mask"].numpy(),
                                  np.asarray(wd["text_mask"]))
    n_valid = int(np.asarray(wd["text_mask"]).sum(-1).max())
    for k in ("all_logits", "dn_all_logits", "enc_logits"):
        np.testing.assert_allclose(gd[k].numpy()[..., :n_valid],
                                   np.asarray(wd[k])[..., :n_valid],
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=k)
    for k in ("all_boxes", "dn_all_boxes", "enc_boxes", "all_masks",
              "logits", "pred_boxes", "pred_masks"):
        g, w = gd[k].numpy(), np.asarray(wd[k])
        if k == "logits":
            g, w = g[..., :n_valid], w[..., :n_valid]
        np.testing.assert_allclose(g, w, atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=k)
    for k in wd["dn_targets"]:
        np.testing.assert_allclose(gd["dn_targets"][k].numpy(),
                                   np.asarray(wd["dn_targets"][k]), atol=TOL)


@pytest.fixture(scope="module")
def jax_run(setup):
    """Two JAX det steps (keys 31, 32) of the stage-1 frozen model with
    the real optimizer behind the gradient capture: the first step's
    trainable gradients, each step's metrics, the final params."""
    s = setup
    tx = jstep.build_optimizer(
        jstep.OptimizerConfig(**OPT),
        jstep.split_frozen(s["params"], _jax_frozen)[0])
    tx = optax.chain(_capture_grads(), tx)
    state = jstep.TrainState.create(s["params"], tx, frozen=_jax_frozen)
    fn = jax.jit(jstep.make_det_train_step(s["jmodel"], tx, s["jtid"],
                                           frozen=_jax_frozen))
    grads, metrics = None, []
    for seed in SEEDS:
        state, m = fn(state, s["jbatch"], jax.random.PRNGKey(seed))
        metrics.append(jax.tree.map(float, m))
        if grads is None:
            grads = jax.tree.map(np.asarray, state.opt_state[0])
    return dict(grads=grads, metrics=metrics, step=int(state.step),
                params=jax.tree.map(np.asarray, state.params))


def _noise(s, seed):
    return jax_noise(jax.random.PRNGKey(seed), s["jcfg"].gdino,
                     s["jbatch"]["targets"]["labels"].shape)


def test_det_step_gradients_match_jax(setup, jax_run):
    s = setup
    want = _port_names(s["tmodel"], jax_run["grads"])
    model = s["tmodel"]
    frozen = _port_frozen(s["cfg"])
    trainable = tstep.split_frozen(model, frozen)
    assert set(want) == set(trainable)
    for p in model.parameters():
        p.grad = None
    loss, metrics, _ = tstep.det_loss(model, s["tbatch"], s["tid"],
                                      _noise(s, SEEDS[0]))
    loss.backward()
    for k, v in jax_run["metrics"][0].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=k)
    # tensors whose exact gradient is zero (key biases under the softmax,
    # biases before a norm) hold rounding noise on both sides: they are
    # held to a floor of 1e-8 of the global gradient norm
    floor = 1e-8 * np.sqrt(sum(np.sum(w.astype(np.float64) ** 2)
                               for w in want.values()))
    for name, p in trainable.items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        w = want[name]
        err = np.linalg.norm(g - w)
        assert err <= GRAD_REL * np.linalg.norm(w) or err <= floor, \
            (name, err, np.linalg.norm(w), floor)
    for p in model.parameters():
        p.grad = None
    frozen_names = [n for n, p in model.named_parameters() if frozen(n)]
    assert frozen_names and all(
        not dict(model.named_parameters())[n].requires_grad
        for n in frozen_names)


def test_two_det_train_steps_match_jax(setup, jax_run):
    s = setup
    model = build_model(s["cfg"], device="cpu", dtype=torch.float32)
    load_jax_params(model, s["params"])
    frozen = _port_frozen(s["cfg"])
    tx = tstep.build_optimizer(OptimizerConfig(**OPT), model, frozen)
    state = tstep.TrainState.create(model, tx, frozen)
    step = tstep.make_det_train_step(model, tx, s["tid"], frozen)
    for i, seed in enumerate(SEEDS):
        state, m = step(state, s["tbatch"], noise=_noise(s, seed))
        for k, v in jax_run["metrics"][i].items():
            np.testing.assert_allclose(m[k].item(), v, rtol=MODEL_TOL,
                                       atol=MODEL_TOL,
                                       err_msg=f"step {i}: {k}")
    assert state.step == jax_run["step"] == 2
    want = _port_names(model, jax_run["params"])
    before = s["initial"]
    for name, p in model.named_parameters():
        w = want[name]
        if frozen(name):
            assert torch.equal(p.detach(), before[name]), name
            continue
        b0 = before[name].numpy()
        dp, dw = p.detach().numpy() - b0, w - b0
        if ZERO_GRAD.search(name):
            # Adam turns rounding noise into steps of up to lr: bounded,
            # not compared
            assert np.abs(dp).max() <= 2.02 * LR, name
            continue
        if not dw.any():             # unused here (the pose [EMB] table)
            assert not dp.any(), name
            continue
        rel = np.linalg.norm(dp - dw) / np.linalg.norm(dw)
        assert rel <= UPDATE_REL, (name, rel)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == {n for n in state.masters
                     if not np.array_equal(want[n], before[n].numpy())}
    assert len(moved) > 0.9 * len(state.masters)
