"""Parity of the port's diffusion modules against the JAX package on the
CPU, in fp32: the DDIM scheduler, the SD-1.5 UNet and its blocks, the
VAE and the LLM2SD mapper.

* Scheduler: `alphas_cumprod` and `add_noise` identical;
  `ddim_sample_loop` with an oracle eps within 1e-5 of JAX's loop and
  within 2e-3 of x0 (JAX's `test_ddim_final_step_recovers_x0`).
* `timestep_embedding` within two fp32 ulps of its largest argument
  (999 x a frequency: 1.22e-4 abs): XLA's and PyTorch's `exp` differ by
  an ulp on some frequencies, and t up to 999 scales that into the
  argument of sin and cos.
* `ResnetBlock`, `CrossAttention` (self and cross), `Transformer2D`,
  `UNet2DCondition` and the mapper within 1e-4 abs + 1e-4 rel (fp32,
  summation order). The UNet runs at JAX's tiny config
  (`unet_cfg_for(16, ...)`: 2 levels, 1 resnet a level) and at a narrow
  config with SD-1.5's layout (4 levels of widths 32, 32, 64, 64, 2
  resnets a level, cross-attention in the first three, 3 upsamples, 8
  heads, groups 8), each with 4 input channels (SD) and 8 (IP2P).
* The VAE at JAX's tiny config and a narrow 4-level one ((16, 16, 32,
  32), 2 resnets a level, groups 8): `encode` as the posterior mean and
  as a sample (the test passes JAX's own noise draw), `decode`; within
  1e-4 abs + 1e-4 rel.

The flax param trees take their shapes from `jax.eval_shape` of the JAX
init and their values from numpy (`random_flax_params`); they reach the
port through `load_jax_params`. The JAX side compiles at XLA
optimization level 0 (`o0_jit`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu.models.stable_diffusion import scheduler as jsched
from visionllm_tpu.models.stable_diffusion import unet as junet
from visionllm_tpu.models.stable_diffusion import vae as jvae
from visionllm_tpu.models.stable_diffusion.sd_head import (
    LLM2SDMapper as JaxMapper)
from visionllm_tpu.models.stable_diffusion.sd_head import (
    unet_cfg_for as jax_unet_cfg_for)
from visionllm_tpu.models.stable_diffusion.sd_head import (
    vae_cfg_for as jax_vae_cfg_for)
from visionllm_tpu_torch.models.stable_diffusion import scheduler as sched
from visionllm_tpu_torch.models.stable_diffusion import unet
from visionllm_tpu_torch.models.stable_diffusion import vae
from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
    LLM2SDMapper, unet_cfg_for, vae_cfg_for)
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
ARITH_TOL = dict(atol=1e-5, rtol=1e-5)
CTX = 32          # cross-attention width of the tests' UNets


def _init(module, seed, *args, method=None):
    """Random flax params for `module` at the shapes its init gives."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))
    return jax.tree.map(np.asarray,
                        random_flax_params(shapes["params"], seed))


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scaled_linear", "linear"])
def test_alphas_cumprod_matches_jax(kind):
    want = jsched.DiffusionSchedule(schedule=kind).alphas_cumprod()
    got = sched.DiffusionSchedule(schedule=kind).alphas_cumprod()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_add_noise_matches_jax():
    rng = np.random.default_rng(0)
    x, n = _np(rng, 3, 4, 4, 4), _np(rng, 3, 4, 4, 4)
    t = np.asarray([0, 517, 999], np.int32)
    want = jsched.add_noise(jsched.DiffusionSchedule(), jnp.asarray(x),
                            jnp.asarray(n), jnp.asarray(t))
    got = sched.add_noise(sched.DiffusionSchedule(), _t(x), _t(n),
                          _t(t).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps", [50, 3])
def test_ddim_loop_matches_jax_and_recovers_x0(steps):
    """An oracle eps predictor: the loop must reconstruct x0 (the last
    step reads the appended final alpha 1.0), step for step as JAX's."""
    s = sched.DiffusionSchedule()
    ac = s.alphas_cumprod()
    rng = np.random.default_rng(1)
    x0, eps = _np(rng, 2, 8, 8, 4), _np(rng, 2, 8, 8, 4)
    t_start = (steps - 1) * (s.num_train_timesteps // steps)
    x_t = (np.sqrt(ac[t_start]) * x0
           + np.sqrt(1 - ac[t_start]) * eps).astype(np.float32)
    want = jsched.ddim_sample_loop(lambda lat, t: jnp.asarray(eps),
                                   jsched.DiffusionSchedule(),
                                   jnp.asarray(x_t), steps)
    seen = []

    def oracle(lat, t):
        seen.append(int(t[0]))
        return _t(eps)

    got = sched.ddim_sample_loop(oracle, s, _t(x_t), steps)
    assert seen[0] == t_start and seen[-1] == 0 and len(seen) == steps
    _close(got, want, **ARITH_TOL)
    np.testing.assert_allclose(got.numpy(), x0, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the UNet and its blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flip,shift", [(True, 0), (False, 1)])
def test_timestep_embedding_matches_jax(flip, shift):
    t = np.asarray([0, 1, 20, 500, 981, 999], np.int32)
    want = junet.timestep_embedding(jnp.asarray(t), 320, flip, shift)
    got = unet.timestep_embedding(_t(t), 320, flip, shift)
    _close(got, want, atol=2 * float(np.spacing(np.float32(999))), rtol=0)


@pytest.mark.parametrize("cin,cout", [(32, 32), (16, 32)],
                         ids=["same", "shortcut"])
def test_resnet_block_matches_jax(cin, cout):
    rng = np.random.default_rng(2)
    x, temb = _np(rng, 2, 6, 6, cin), _np(rng, 2, 64)
    jmod = junet.ResnetBlock(cout, 8, jnp.float32)
    params = _init(jmod, 3, x, temb)
    want = o0_jit(lambda p, a, b: jmod.apply({"params": p}, a, b))(
        params, x, temb)
    tmod = unet.ResnetBlock(cin, cout, 64, 8)
    load_jax_params(tmod, params)
    with torch.no_grad():
        _close(_nhwc(tmod(_nchw(x), _t(temb))), want)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_cross_attention_matches_jax(cross):
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 36, 32, scale=2.0)
    ctx = _np(rng, 2, 7, 24) if cross else None
    jmod = junet.CrossAttention(32, 4, 24 if cross else None, jnp.float32)
    params = _init(jmod, 5, x, ctx)
    want = jmod.apply({"params": params}, x, ctx)
    tmod = unet.CrossAttention(32, 4, 24 if cross else None)
    load_jax_params(tmod, params)
    with torch.no_grad():
        _close(tmod(_t(x), None if ctx is None else _t(ctx)), want)


def test_transformer2d_matches_jax():
    rng = np.random.default_rng(6)
    x, ctx = _np(rng, 2, 6, 6, 32), _np(rng, 2, 7, CTX)
    jmod = junet.Transformer2D(4, CTX, 8, jnp.float32)
    params = _init(jmod, 7, x, ctx)
    want = o0_jit(lambda p, a, b: jmod.apply({"params": p}, a, b))(
        params, x, ctx)
    tmod = unet.Transformer2D(32, 4, CTX, 8)
    load_jax_params(tmod, params)
    with torch.no_grad():
        _close(_nhwc(tmod(_nchw(x), _t(ctx))), want)


def _unet_cfgs(mod, name, in_channels):
    """The test's UNet config of module `mod` (the JAX `unet` or the
    port's): JAX's tiny geometry, or SD-1.5's layout at narrow widths."""
    if name == "tiny":
        cfg_for = jax_unet_cfg_for if mod is junet else unet_cfg_for
        return cfg_for(16, in_channels, CTX)
    return mod.UNetConfig(
        sample_size=16, in_channels=in_channels,
        block_out_channels=(32, 32, 64, 64), layers_per_block=2,
        cross_attention_dim=CTX, attention_head_dim=8, norm_num_groups=8,
        cross_attn_blocks=(True, True, True, False))


@pytest.mark.parametrize("in_channels", [4, 8], ids=["sd", "ip2p"])
@pytest.mark.parametrize("name", ["tiny", "sd15_layout"])
def test_unet_matches_jax(name, in_channels):
    rng = np.random.default_rng(8)
    x = _np(rng, 2, 16, 16, in_channels)
    t = np.asarray([3, 981], np.int32)
    ctx = _np(rng, 2, 7, CTX)
    jmod = junet.UNet2DCondition(_unet_cfgs(junet, name, in_channels),
                                 jnp.float32)
    params = _init(jmod, 9, x, t, ctx)
    want = o0_jit(lambda p, a, b, c: jmod.apply({"params": p}, a, b, c))(
        params, x, t, ctx)
    tmod = unet.UNet2DCondition(_unet_cfgs(unet, name, in_channels))
    if name == "sd15_layout":
        names = dict(tmod.named_children())
        assert "up_2_upsample" in names and "up_3_upsample" not in names
        assert "down_2_attn_1" in names and "down_3_attn_0" not in names
        assert "up_0_attn_0" not in names and "up_3_attn_2" in names
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(_t(x), _t(t), _t(ctx))
    assert got.shape == (2, 16, 16, 4)
    _close(got, want)


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------

def _vae_cfgs(mod, name):
    if name == "tiny":
        return (jax_vae_cfg_for if mod is jvae else vae_cfg_for)(16)
    return mod.VAEConfig(block_out_channels=(16, 16, 32, 32),
                         layers_per_block=2, norm_num_groups=8)


def _vae_params(name, img):
    jmod = jvae.AutoencoderKL(_vae_cfgs(jvae, name), jnp.float32)
    return jmod, _init(jmod, 10, img)


@pytest.mark.parametrize("sample", [False, True], ids=["mean", "sample"])
@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_vae_encode_matches_jax(name, sample):
    """The posterior mean, or a sample of it: the port takes the noise
    JAX draws (`jax.random.normal(rng, mean.shape)`)."""
    size = 32 if name == "tiny" else 64
    img = np.random.default_rng(11).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    jmod, params = _vae_params(name, img)
    key = jax.random.PRNGKey(12) if sample else None
    want = o0_jit(lambda p, a: jmod.apply(
        {"params": p}, a, key, method=jvae.AutoencoderKL.encode))(
            params, img)
    tmod = vae.AutoencoderKL(_vae_cfgs(vae, name))
    load_jax_params(tmod, params)
    noise = (_t(jax.random.normal(key, want.shape)) if sample else None)
    with torch.no_grad():
        got = tmod.encode(_t(img), noise=noise)
    side = size // 2 ** (len(tmod.cfg.block_out_channels) - 1)
    assert got.shape == want.shape == (2, side, side, 4)
    _close(got, want)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_vae_decode_matches_jax(name):
    size = 32 if name == "tiny" else 64
    img = np.zeros((1, size, size, 3), np.float32)
    jmod, params = _vae_params(name, img)
    lat_side = size // 2 ** (len(_vae_cfgs(vae, name).block_out_channels)
                             - 1)
    z = _np(np.random.default_rng(13), 2, lat_side, lat_side, 4, scale=0.2)
    want = o0_jit(lambda p, a: jmod.apply(
        {"params": p}, a, method=jvae.AutoencoderKL.decode))(params, z)
    tmod = vae.AutoencoderKL(_vae_cfgs(vae, name))
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod.decode(_t(z))
    assert got.shape == want.shape == (2, size, size, 3)
    _close(got, want)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def test_mapper_matches_jax():
    """emb_proj + 7 queries through one encoder and one decoder layer
    (8 heads of 4), fp32."""
    x = _np(np.random.default_rng(14), 2, 8, 48, scale=2.0)
    jmod = JaxMapper(48, 32, 7, dtype=jnp.float32)
    params = _init(jmod, 15, x)
    want = jmod.apply({"params": params}, x)
    tmod = LLM2SDMapper(48, 32, 7)
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.shape == (2, 7, 32)
    _close(got, want)
