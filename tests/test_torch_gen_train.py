"""Parity of the port's [GEN] and [EDIT] training path against the JAX
package on the CPU, in fp32, at the JAX tiny head config (`SDConfig` /
`IP2PConfig` with llm 64, sd 32, 7 queries, 8 rows, sample_size 16: the
tiny UNet, and a VAE of one downsampling, so 32 px images give 16 px
latents).

The draws are `jax.random`'s from the JAX key through the heads' split
chains (SD: split(key, 3) -> posterior noise, epsilon, timesteps; IP2P:
split(key, 4), the last the classifier-free-drop uniforms), fed to the
port as tensors (`noise=`). Tolerance 1e-4 abs + rel throughout.

* Both heads' `train_loss` (image, caption and total losses), the IP2P
  head at a drop probability of 0.3 over 4 samples, so rows train on the
  null text, on zero image latents, on both and on neither.
* The composite's `forward_gen` / `forward_edit` (the LM loss, the heads'
  losses on the [GEN] / [EDIT] rows).
* One step of `make_gen_train_step` (gen and edit) against JAX's, stage-1
  freezing with the SD UNet frozen and the IP2P UNet trained: the
  metrics, key for key, and the gradient norm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_train import _capture_grads
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.stable_diffusion.sd_head import (
    InstructPix2PixWithLLMEmb as JaxIP2P)
from visionllm_tpu.models.stable_diffusion.sd_head import (
    StableDiffusionWithLLMEmb as JaxSD)
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
    InstructPix2PixWithLLMEmb, StableDiffusionWithLLMEmb)
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train import train_step as tstep
from visionllm_tpu_torch.train.runner import TrainConfig, frozen_predicate
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
HEAD = dict(llm_hidden_size=64, sd_hidden_size=32, num_queries=7,
            num_embs_gen=8, sample_size=16, cross_attention_dim=32)
IMG = 32
OPT = dict(learning_rate=1e-3, total_steps=1000)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(shapes, seed):
    return jax.tree.map(np.asarray, random_flax_params(shapes["params"],
                                                       seed))


def jax_gen_noise(key, B, edit, latent=IMG // 2):
    """The draws of one JAX head `train_loss` with key `key`, in the
    port's `draw_noise` layout."""
    keys = jax.random.split(key, 4 if edit else 3)
    shape = (B, latent, latent, 4)
    out = {"posterior": _t(jax.random.normal(keys[0], shape)),
           "eps": _t(jax.random.normal(keys[1], shape, jnp.float32)),
           "t": _t(jax.random.randint(keys[2], (B,), 0, 1000)).long()}
    if edit:
        out["drop"] = _t(jax.random.uniform(keys[3], (B,)))
    return out


def _images(seed, B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 64)).astype(np.float32),
            rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
            rng.standard_normal((B, 7, 32)).astype(np.float32))


def _check(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **TOL)


def test_sd_train_loss_matches_jax():
    torch.set_num_threads(1)
    embs, _, out_img, cap = _images(0, 2)
    rng = jax.random.PRNGKey(1)
    jsd = JaxSD(jconfig.SDConfig(**HEAD), dtype=jnp.float32)
    params = _tree(jax.eval_shape(lambda: jsd.init(rng, embs, out_img, rng)),
                   2)
    head = StableDiffusionWithLLMEmb(pconfig.SDConfig(**HEAD))
    load_jax_params(head, params)
    key = jax.random.PRNGKey(3)
    want = o0_jit(lambda p, e, o, c: jsd.apply(
        {"params": p}, e, o, key, caption_embeds=c,
        method=JaxSD.train_loss))(params, embs, out_img, cap)
    got = head.train_loss(_t(embs), _t(out_img),
                          noise=jax_gen_noise(key, 2, False),
                          caption_embeds=_t(cap))
    _check(got, want)
    # the draws from a generator have the layout the loss reads
    drawn = head.train_loss(_t(embs), _t(out_img),
                            torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["loss"])


def test_ip2p_train_loss_matches_jax():
    """cfg_drop_prob 0.3 over 4 samples: the drop uniforms of this key
    (0.21, 0.56, 0.98, 0.84) drop the text, both, neither and the
    image."""
    torch.set_num_threads(1)
    B = 4
    embs, src, out_img, cap = _images(1, B)
    hc = dict(HEAD, cfg_drop_prob=0.3)
    rng = jax.random.PRNGKey(1)
    jip = JaxIP2P(jconfig.IP2PConfig(**hc), dtype=jnp.float32)
    params = _tree(jax.eval_shape(lambda: jip.init(rng, embs, src, out_img,
                                                   rng)), 4)
    head = InstructPix2PixWithLLMEmb(pconfig.IP2PConfig(**hc))
    load_jax_params(head, params)
    key = jax.random.PRNGKey(4)
    noise = jax_gen_noise(key, B, True)
    u = noise["drop"].numpy()
    text_drop, img_drop = u < 0.6, (u >= 0.3) & (u < 0.9)
    assert {(bool(a), bool(b)) for a, b in zip(text_drop, img_drop)} == {
        (True, False), (True, True), (False, True), (False, False)}
    want = o0_jit(lambda p, e, s, o, c: jip.apply(
        {"params": p}, e, s, o, key, caption_embeds=c,
        method=JaxIP2P.train_loss))(params, embs, src, out_img, cap)
    got = head.train_loss(_t(embs), _t(src), _t(out_img), noise=noise,
                          caption_embeds=_t(cap))
    _check(got, want)


def _prompt(tid, tool, n_img):
    ids = [1, 10] + [tid.imp] * n_img + [11, tool] + [tid.emb] * 8 + [12, 2]
    return np.asarray([ids, ids], np.int32)


def _batch_np(cfg, tid, edit):
    n_img = cfg.vis_encoder.num_patches if edit else 0
    ids = _prompt(tid, tid.edit if edit else tid.gen, n_img)
    _, src, out_img, _ = _images(2, 2)
    b = {"input_ids": ids,
         "labels": np.where(ids >= 10, ids, -100).astype(np.int32),
         "attn_mask": np.ones_like(ids), "output_images": out_img}
    if edit:
        size = cfg.vis_encoder.image_size
        b["images"] = np.random.default_rng(3).standard_normal(
            (2, size, size, 3)).astype(np.float32)
        b["input_images"] = src
    return b


def _port_batch(b):
    out = {k: _t(v) for k, v in b.items()}
    for k in ("input_ids", "labels", "attn_mask"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def composite():
    torch.set_num_threads(1)
    jcfg = jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    batches = {e: _batch_np(jcfg, jtid, e) for e in (False, True)}
    jb = {e: jax.tree.map(jnp.asarray, b) for e, b in batches.items()}

    def init_method(m, gen, edit, tid, rng):
        m.forward_gen(gen, tid, rng)
        out = m.forward_edit(edit, tid, rng)
        # the heads' __call__ also makes the VAE decoders' params
        embs = jnp.zeros((2, 8, 64))
        m.sd(embs, gen["output_images"], rng)
        m.ip2p(embs, edit["input_images"], edit["output_images"], rng)
        return out

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb[False], jb[True], jtid, r, method=init_method),
        jax.random.PRNGKey(0))
    params = _tree(shapes, 5)
    cfg = pconfig.tiny_test_config(
        use_gdino=False, gdino=None, use_unipose=False, unipose=None,
        use_sd=True, sd=pconfig.SDConfig(**HEAD), use_ip2p=True,
        ip2p=pconfig.IP2PConfig(**HEAD))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    return dict(jcfg=jcfg, jtid=jtid, jmodel=jmodel, jb=jb, params=params,
                cfg=cfg, model=model, tid=SpecialTokenIds.synthetic(),
                tb={e: _port_batch(b) for e, b in batches.items()})


@pytest.mark.parametrize("edit", [False, True])
def test_forward_gen_and_edit_match_jax(composite, edit):
    s = composite
    key = jax.random.PRNGKey(21)
    method = JaxModel.forward_edit if edit else JaxModel.forward_gen
    want = o0_jit(lambda p, b: s["jmodel"].apply(
        {"params": p}, b, s["jtid"], key, method=method))(
            s["params"], s["jb"][edit])
    fwd = s["model"].forward_edit if edit else s["model"].forward_gen
    with torch.no_grad():
        got = fwd(s["tb"][edit], s["tid"],
                  noise=jax_gen_noise(key, 2, edit))
    name = "ip2p" if edit else "sd"
    _check({"loss": got["loss"], "lm_loss": got["lm_loss"],
            **{f"{name}.{k}": v for k, v in got[name].items()}},
           {"loss": want["loss"], "lm_loss": want["lm_loss"],
            **{f"{name}.{k}": v for k, v in want[name].items()}})


@pytest.mark.parametrize("edit", [False, True])
def test_gen_step_matches_jax(composite, edit):
    s = composite
    jtc = jrunner.TrainConfig(freeze_llm=True)
    jfrozen = jrunner.frozen_predicate(jtc, s["jcfg"])
    tx = jstep.build_optimizer(jstep.OptimizerConfig(**OPT),
                               jstep.split_frozen(s["params"], jfrozen)[0])
    tx = optax.chain(_capture_grads(), tx)
    state = jstep.TrainState.create(s["params"], tx, frozen=jfrozen)
    fn = o0_jit(jstep.make_gen_train_step(s["jmodel"], tx, s["jtid"],
                                          edit=edit, frozen=jfrozen))
    key = jax.random.PRNGKey(31)
    jstate, want = fn(state, s["jb"][edit], key)
    want = {k: float(v) for k, v in want.items()}
    want["grad_norm"] = float(np.sqrt(sum(
        np.sum(np.asarray(g, np.float64) ** 2)
        for g in jax.tree_util.tree_leaves(jstate.opt_state[0]))))

    model = build_model(s["cfg"], device="cpu", dtype=torch.float32)
    load_jax_params(model, s["params"])
    frozen = frozen_predicate(TrainConfig(freeze_llm=True), s["cfg"])
    assert frozen("sd.unet.conv_in.weight")
    assert not frozen("ip2p.unet.conv_in.weight")
    ttx = tstep.build_optimizer(pconfig.OptimizerConfig(**OPT), model,
                                frozen)
    tstate = tstep.TrainState.create(model, ttx, frozen)
    step = tstep.make_gen_train_step(model, ttx, s["tid"], edit=edit,
                                     frozen=frozen)
    _, got = step(tstate, s["tb"][edit],
                  noise=jax_gen_noise(key, 2, edit))
    _check(got, want)
