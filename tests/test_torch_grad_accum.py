"""Gradient accumulation (`OptimizerConfig.grad_accum_steps`) in the port
on the CPU, in fp32, at the tiny chat composite (no tools), against the
JAX package's `optax.MultiSteps` (mirroring JAX `tests/test_train_step.py`
`test_grad_accumulation_matches_single_step`):

* micro-step 1 of 2 leaves the model's parameters, the masters and the
  moments bit for bit as they were, and k=2 over two identical batches
  equals k=1 over one, bit for bit;
* two different micro-batches through the chat step give JAX's losses,
  running mean and parameters within 1e-4;
* the step over given gradients gives the parameters of JAX's
  `build_optimizer` (`optax.MultiSteps`) within 1e-6 after every
  micro-step, for two micro-steps and for four at k=2 under the warmup +
  cosine schedule (the schedule and Adam's bias correction count applied
  steps);
* `Trainer.train` with k=2 on a llava chat dataset: a run saved after
  1, 2 or 3 micro-steps (mid-accumulation or at its end), resumed by a
  fresh Trainer and run to 4, ends bit for bit where 4 straight
  micro-steps end: metrics, masters, moments, the accumulator and the
  parameters (`HashedWordTokenizer`,
  `torch.use_deterministic_algorithms(True)`).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train import train_step as tstep
from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
from visionllm_tpu_torch.utils import checkpoint as tckpt
from visionllm_tpu_torch.utils.convert import _emit, load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer

TID = SpecialTokenIds.synthetic()
IMG_LEN = 16
SIZE = 56


def _jax_cfg():
    return jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_sd=False, use_ip2p=False,
                                    use_region_encoder=False)


def _cfg():
    return tconfig.tiny_test_config(use_gdino=False, gdino=None,
                                    use_unipose=False, unipose=None)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = np.asarray([[1, 10, 11] + [TID.imp] * IMG_LEN
                      + list(rng.integers(12, 200, 6)) + [2]] * 2, np.int32)
    attn = np.ones_like(ids)
    attn[1, -2:] = 0
    return {"input_ids": ids,
            "labels": np.where((ids >= 10) & (attn > 0), ids,
                               -100).astype(np.int32),
            "attn_mask": attn,
            "images": (0.5 * rng.standard_normal((2, SIZE, SIZE, 3))
                       ).astype(np.float32)}


def _port_batch(b):
    out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    for k in ("input_ids", "labels", "attn_mask"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def chat():
    torch.set_num_threads(1)
    jmodel = JaxModel(_jax_cfg(), dtype=jnp.float32, tool_dtype=jnp.float32)
    jb = jax.tree.map(jnp.asarray, _batch(0))
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb, JaxTid.synthetic(), method=JaxModel.forward_chat),
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, random_flax_params(shapes["params"],
                                                         3))
    return jmodel, params


def _port(params, **opt):
    model = build_model(_cfg(), device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    tx = tstep.build_optimizer(tconfig.OptimizerConfig(**opt), model)
    state = tstep.TrainState.create(model, tx)
    return model, state, tstep.make_chat_train_step(model, tx, TID)


def _snapshot(state):
    return {part: {n: t.clone() for n, t in getattr(state, part).items()}
            for part in ("masters", "mu", "nu")}


OPT = dict(learning_rate=1e-3, schedule="constant", total_steps=10)


def test_micro_step_leaves_state_and_k2_equals_k1_bitwise(chat):
    _, params = chat
    b = _port_batch(_batch(1))
    model, state, step = _port(params, grad_accum_steps=2, **OPT)
    before = _snapshot(state)
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = step(state, b)
    assert (state.step, state.mini_step, state.gradient_step) == (1, 1, 0)
    assert torch.isfinite(metrics["grad_norm"])
    for part, tensors in before.items():
        for n, t in tensors.items():
            assert torch.equal(getattr(state, part)[n], t), (part, n)
    for n, p in model.named_parameters():
        assert torch.equal(p, weights[n]), n
    state, _ = step(state, b)
    assert (state.step, state.mini_step, state.gradient_step) == (2, 0, 1)
    assert all(torch.count_nonzero(a) == 0 for a in state.acc.values())
    model1, state1, step1 = _port(params, **OPT)
    assert state1.acc == {}
    state1, m1 = step1(state1, b)
    for n, w in state1.masters.items():
        assert torch.equal(state.masters[n], w), n
    for n, p in model1.named_parameters():
        assert torch.equal(dict(model.named_parameters())[n], p), n


def _jax_state(chat, **opt):
    jmodel, params = chat
    tx = jstep.build_optimizer(jstep.OptimizerConfig(**opt), params)
    state = jstep.TrainState.create(params, tx)
    fn = o0_jit(jstep.make_chat_train_step(jmodel, tx, JaxTid.synthetic()))
    return state, fn


def test_chat_accumulation_matches_jax(chat):
    """Two different micro-batches at k=2 through the chat step: each
    micro-step's loss (1e-4), the running mean after the first (optax's
    `acc_grads`, 1e-4) and the parameters after the applied step within
    1e-4 (Adam divides a gradient by its own size, so an element whose
    gradient is rounding noise, as a key bias's is, moves by up to the
    learning rate either way; lr 1e-3 bounds that)."""
    opt = dict(OPT, grad_accum_steps=2)
    batches = [_batch(2), _batch(3)]
    jstate, fn = _jax_state(chat, **opt)
    model, state, step = _port(chat[1], **opt)
    for i, b in enumerate(batches):
        jstate, jm = fn(jstate, jax.tree.map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
        state, m = step(state, _port_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-4)
        if i == 0:
            acc = {}
            _emit(model, "", jax.tree.map(np.asarray,
                                          jstate.opt_state.acc_grads), acc)
            for n, a in state.acc.items():
                np.testing.assert_allclose(a.numpy(), acc[n], rtol=1e-4,
                                           atol=1e-4, err_msg=n)
    want = {}
    _emit(model, "", jax.tree.map(np.asarray, jstate.params), want)
    assert sorted(want) == sorted(state.masters)
    for n, w in want.items():
        np.testing.assert_allclose(state.masters[n].numpy(), w, rtol=1e-4,
                                   atol=1e-4, err_msg=n)


class _Params(torch.nn.Module):
    """Parameters named by `GRAD_NAMES` (one in the low-lr group)."""

    def __init__(self, init):
        super().__init__()
        for n, v in init.items():
            self.register_parameter(n, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


GRAD_NAMES = {"backbone_w": (4, 3), "bias": (5,), "head_w": (2, 3)}


@pytest.mark.parametrize("case", ["two_batches", "four_cosine"])
def test_accumulation_matches_jax_multisteps(case):
    """The port's step over given gradients (a loss of <p, g> per micro-
    step has gradient g exactly) against the JAX `build_optimizer`'s
    `optax.MultiSteps` on the same gradients: the parameters after every
    micro-step within 1e-6. "four_cosine" takes four micro-steps at k=2
    under warmup + cosine with weight decay, so the schedule and Adam's
    bias correction must count applied steps."""
    if case == "two_batches":
        opt = dict(learning_rate=1e-2, schedule="constant", total_steps=10,
                   grad_accum_steps=2)
        n = 2
    else:
        opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                   weight_decay=0.05, grad_accum_steps=2, max_grad_norm=0.5)
        n = 4
    rng = np.random.default_rng(9)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in GRAD_NAMES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in GRAD_NAMES.items()} for _ in range(n)]
    jtx = jstep.build_optimizer(jstep.OptimizerConfig(**opt), init)
    jparams, jopt = dict(init), jtx.init(init)
    model = _Params(init)
    tx = tstep.build_optimizer(tconfig.OptimizerConfig(**opt), model)
    state = tstep.TrainState.create(model, tx)
    step = tstep._make_step(
        model, tx, None,
        lambda b, noise: (sum((p * b[k]).sum() for k, p in
                              model.named_parameters()), {}, {}),
        lambda g, b: {})
    for g in grads:
        upd, jopt = jtx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                g.items()})
        for k, w in jparams.items():
            np.testing.assert_allclose(state.masters[k].numpy(),
                                       np.asarray(w), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert state.gradient_step == n // 2
    assert int(jopt.gradient_step) == n // 2


def test_schedule_and_bias_correction_count_applied_steps():
    """After 3 micro-steps at k=2 the update of the 4th uses Adam's count 2
    and the schedule's step 1, not 4 and 3."""
    cfg = tconfig.OptimizerConfig(learning_rate=1.0, warmup_steps=4,
                                  total_steps=8, grad_accum_steps=2)
    w = torch.nn.Parameter(torch.zeros(3))
    model = torch.nn.Module()
    model.w = w
    tx = tstep.build_optimizer(cfg, model)
    state = tstep.TrainState.create(model, tx)
    state.gradient_step = 1
    g = torch.tensor([1.0, -2.0, 0.5])
    tx.update({"w": g}, state)
    b1, b2 = cfg.betas
    gc = g / g.norm()                   # clipped to max_grad_norm 1
    mu, nu = (1 - b1) * gc, (1 - b2) * gc * gc
    upd = (mu / (1 - b1 ** 2)) / ((nu / (1 - b2 ** 2)).sqrt() + cfg.eps)
    lr = tx.schedule(1)
    assert lr == pytest.approx(0.25)
    torch.testing.assert_close(state.masters["w"], -lr * upd, rtol=1e-6,
                               atol=1e-7)


def test_grad_accum_steps_validated():
    assert tconfig.OptimizerConfig(grad_accum_steps=4).grad_accum_steps == 4
    with pytest.raises(ValueError, match="grad_accum_steps=0"):
        tconfig.OptimizerConfig(grad_accum_steps=0)


# ---------------------------------------------------------------------------
# Trainer.train with accumulation: save mid-accumulation, resume, finish
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llava_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("accum_llava")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        h, w = (40, 64) if i % 2 else (64, 48)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.jpg", quality=90)
        rows.append({"image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is in picture {i}?"},
            {"from": "gpt", "value": f"a noisy square number {i}"}]})
    with open(d / "chat.json", "w") as f:
        json.dump(rows, f)
    return str(d)


def _train(root, out, steps):
    tc = TrainConfig(output_dir=out, batch_size=2, total_steps=100,
                     log_every=1, save_every=100, num_workers=2, seed=0,
                     optimizer=tconfig.OptimizerConfig(
                         learning_rate=1e-3, total_steps=10,
                         grad_accum_steps=2))
    trainer = Trainer(_cfg(), tc, TID, device="cpu", dtype=torch.float32)
    state = trainer.train([{"type": "llava",
                            "ann_file": os.path.join(root, "chat.json"),
                            "image_folder": root, "image_size": SIZE}],
                          HashedWordTokenizer(), max_steps=steps)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return trainer, state, rows


@pytest.fixture(scope="module")
def straight(llava_files, tmp_path_factory):
    torch.set_num_threads(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(llava_files, str(tmp_path_factory.mktemp("s")), 4)
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("split", [1, 2, 3])
def test_resume_mid_accumulation_equals_straight_run_bitwise(
        llava_files, straight, tmp_path, split):
    torch.set_num_threads(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _, first, _ = _train(llava_files, str(tmp_path), split)
        ck = tckpt.restore_checkpoint(os.path.join(tmp_path, "checkpoints"))
        assert (ck["step"], ck["mini_step"], ck["gradient_step"]) == (
            split, split % 2, split // 2)
        assert any(torch.count_nonzero(a) for a in ck["acc"].values()) == \
            bool(split % 2)
        trainer, resumed, rows = _train(llava_files, str(tmp_path), 4)
    finally:
        torch.use_deterministic_algorithms(was)
    _, sstate, srows = straight
    assert first.step == split and resumed.step == 4
    assert resumed.gradient_step == sstate.gradient_step == 2
    for r, s in zip(rows[split:], srows[split:]):
        assert {k: v for k, v in r.items() if k != "time"} == \
            {k: v for k, v in s.items() if k != "time"}
    for part in ("masters", "mu", "nu", "acc"):
        for n, t in getattr(sstate, part).items():
            assert torch.equal(getattr(resumed, part)[n], t), (part, n)
    params = dict(resumed.model.named_parameters())
    for n, p in sstate.model.named_parameters():
        assert torch.equal(params[n], p), n
