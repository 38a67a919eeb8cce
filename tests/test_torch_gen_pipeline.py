"""The port's [GEN] and [EDIT] heads and their pipeline against the JAX
package on the CPU, at the JAX tiny head config (`SDConfig` /
`IP2PConfig` with llm 64, sd 32, 7 queries, 8 rows, sample_size 16: the
tiny UNet and VAE).

* `StableDiffusionWithLLMEmb.generate` (3 DDIM steps, guidance 7.5) and
  `InstructPix2PixWithLLMEmb.generate` (2 steps, guidance 7.5, image
  guidance 1.5) from JAX's own start latents (`jax.random.normal(rng,
  (B, S, S, 4))`, passed in as `latents=`), fp32: images within 1e-4 abs
  + 1e-4 rel, the mapper's conditioning within 1e-4.
* `VisionLLM.extract_gen_embs` identical to JAX's.
* `load_jax_params` fills the whole tiny gen composite (core, sd, ip2p)
  from the JAX composite's tree with no unused or missing key; the JAX
  `vllm_7b_config` gen model's full-width tree maps leaf for leaf onto
  `vllm_7b_gen_config()`'s model on the meta device (shapes only).
* `build_model` in bf16 keeps the mappers, every GroupNorm and the
  UNet's LayerNorms in fp32; the tiny UNet and the mapper then hold
  JAX's bf16 heads (fp32 params, bf16 compute): conditioning within 1e-4
  and a GroupNorm within 1e-5 (fp32 on both sides); the UNet output
  within 2e-2 relative Frobenius error of JAX's bf16 one, and as far
  from JAX's fp32 UNet as JAX's bf16 UNet is, within a factor 0.5-1.2.
* Each bf16 layer against flax's in bf16, where the roundings show: a
  Conv and a Dense identical to flax's but for one element in a
  thousand (one ulp) once the test adds their bias after the bf16
  rounding of the product (flax's order; PyTorch rounds once, after the
  bias), the UNet's self- and cross-attention within
  5e-4 relative (fp32 scores and softmax, bf16 probabilities and PV),
  its fp32-parameter LayerNorm within 1e-4.
* The pipeline end to end, mirroring JAX's
  `tests/test_edit_pipeline_e2e.py`: greedy `build_generate_fn` with the
  first token forced to [EDIT] (an image prompt) or [GEN] (text only),
  `extract_tool_queries_from_generation`, then `ip2p.generate` /
  `sd.generate` from JAX's start latents: tokens identical, rows within
  1e-4, images within 1e-4 abs + 1e-4 rel; the same latents twice give
  identical images.

The JAX core and heads are initialised separately (not the composite
through `forward_edit`), their shapes from `jax.eval_shape` and their
values from numpy (`random_flax_params`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu import constants as JC
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.generation import (
    extract_tool_queries_from_generation as jax_tool_queries)
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.stable_diffusion.sd_head import (
    InstructPix2PixWithLLMEmb as JaxIP2P)
from visionllm_tpu.models.stable_diffusion.sd_head import (
    StableDiffusionWithLLMEmb as JaxSD)
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.generation import (
    extract_tool_queries_from_generation as tool_queries)
from visionllm_tpu_torch.models.composite import (VisionLLMWithTools,
                                                  build_model)
from visionllm_tpu_torch.models.stable_diffusion import unet as U
from visionllm_tpu_torch.models.stable_diffusion.unet import GroupNorm32
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils import convert
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL_TOL = 2e-2
HEAD = dict(llm_hidden_size=64, sd_hidden_size=32, num_queries=7,
            num_embs_gen=8, sample_size=16, cross_attention_dim=32)
IMG = 32              # the tiny VAE's image side (sample_size 16, x2)
MAX_LEN = 128


def _jax_cfg():
    return jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_region_encoder=False)


def _port_cfg():
    return pconfig.tiny_test_config(
        use_gdino=False, gdino=None, use_unipose=False, unipose=None,
        use_sd=True, sd=pconfig.SDConfig(**HEAD), use_ip2p=True,
        ip2p=pconfig.IP2PConfig(**HEAD))


def _random_tree(shapes, seed):
    return jax.tree.map(np.asarray,
                        random_flax_params(shapes["params"], seed))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _rel(got, want):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _head_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((B, 8, 64)).astype(np.float32)
    src = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    return embs, src


@pytest.fixture(scope="module")
def heads():
    """JAX's fp32 [GEN] and [EDIT] heads with random params, and the
    port's tiny gen composite (fp32, CPU) holding the same params."""
    torch.set_num_threads(1)
    embs, src = _head_inputs()
    rng = jax.random.PRNGKey(1)
    jsd = JaxSD(jconfig.SDConfig(**HEAD), dtype=jnp.float32)
    jip = JaxIP2P(jconfig.IP2PConfig(**HEAD), dtype=jnp.float32)
    sd_params = _random_tree(jax.eval_shape(
        lambda: jsd.init(rng, embs, src, rng)), 2)
    ip_params = _random_tree(jax.eval_shape(
        lambda: jip.init(rng, embs, src, src, rng)), 3)
    model = build_model(_port_cfg(), device="cpu", dtype=torch.float32)
    load_jax_params(model.sd, sd_params)
    load_jax_params(model.ip2p, ip_params)
    return jsd, sd_params, jip, ip_params, model


def _jax_sd_image(jsd, params, embs, key, steps):
    return o0_jit(lambda p, e: jsd.apply(
        {"params": p}, e, key, num_inference_steps=steps,
        method=JaxSD.generate))(params, embs)


def _jax_ip2p_image(jip, params, embs, src, key, steps):
    return o0_jit(lambda p, e, s: jip.apply(
        {"params": p}, e, s, key, num_inference_steps=steps,
        method=JaxIP2P.generate))(params, embs, src)


def _jax_latents(key, B):
    """The start latents JAX's `generate` draws from `key`."""
    return _t(jax.random.normal(key, (B, HEAD["sample_size"],
                                      HEAD["sample_size"], 4), jnp.float32))


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------

def test_sd_generate_matches_jax(heads):
    jsd, params, _, _, model = heads
    embs, _ = _head_inputs(4)
    key = jax.random.PRNGKey(5)
    want = _jax_sd_image(jsd, params, embs, key, 3)
    cond = jsd.apply({"params": params}, embs,
                     method=JaxSD.map_embeddings)
    with torch.no_grad():
        _close(model.sd.map_embeddings(_t(embs)), cond)
        got = model.sd.generate(_t(embs), None, 3,
                                latents=_jax_latents(key, 2))
    assert got.shape == want.shape == (2, IMG, IMG, 3)
    _close(got, want)


def test_ip2p_generate_matches_jax(heads):
    _, _, jip, params, model = heads
    embs, src = _head_inputs(6)
    key = jax.random.PRNGKey(7)
    want = _jax_ip2p_image(jip, params, embs, src, key, 2)
    with torch.no_grad():
        got = model.ip2p.generate(_t(embs), _t(src), None, 2,
                                  latents=_jax_latents(key, 2))
    assert got.shape == want.shape == (2, IMG, IMG, 3)
    _close(got, want)


def test_generate_draws_from_the_generator(heads):
    """Without `latents=` the start is a standard normal draw from the
    caller's generator: the same seed gives the same image, and it is the
    image of the same draw passed in."""
    model = heads[4]
    embs, _ = _head_inputs(8, B=1)
    with torch.no_grad():
        a = model.sd.generate(_t(embs), torch.Generator().manual_seed(3), 2)
        b = model.sd.generate(_t(embs), torch.Generator().manual_seed(3), 2)
        lat = torch.randn((1, 16, 16, 4), generator=torch.Generator()
                          .manual_seed(3))
        c = model.sd.generate(_t(embs), None, 2, latents=lat)
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator or latents"):
        model.sd.generate(_t(embs), None, 2)


def test_extract_gen_embs_matches_jax():
    """One [GEN] and one [EDIT] trigger, each followed by its [EMB] rows
    (and stray [DET][EMB] rows that must not be taken)."""
    tid, jtid = SpecialTokenIds.synthetic(), JaxTid.synthetic()
    n = 8
    row0 = [1, 5, tid.det, tid.emb, 6, tid.gen] + [tid.emb] * n + [7]
    row1 = [1, tid.edit] + [tid.emb] * n + [8, 9, tid.det, tid.emb, 3, 4]
    ids = np.asarray([row0 + [0] * (len(row1) - len(row0)), row1],
                     np.int32)
    hidden = np.random.default_rng(9).standard_normal(
        ids.shape + (64,)).astype(np.float32)
    jcfg = _jax_cfg()
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    params = _random_tree(jax.eval_shape(lambda: jcore.init(
        jax.random.PRNGKey(0), jnp.asarray(ids[:1]),
        jnp.zeros((1, size, size, 3)), jtid)), 0)
    core = VisionLLMWithTools(_port_cfg()).core
    for code in (C.TOOL_GEN, C.TOOL_EDIT):
        want = jcore.apply({"params": params}, jnp.asarray(hidden),
                           jnp.asarray(ids), jtid, code,
                           method=JaxCore.extract_gen_embs)
        got = core.extract_gen_embs(_t(hidden), _t(ids).long(), tid, code)
        assert got.shape == (2, n, 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert C.TOOL_GEN == JC.TOOL_GEN and C.TOOL_EDIT == JC.TOOL_EDIT


# ---------------------------------------------------------------------------
# the composite: the converter, the layout, the dtypes
# ---------------------------------------------------------------------------

def test_load_jax_params_fills_the_gen_composite():
    """The JAX composite's tree (core, sd, ip2p) fills the port's tiny gen
    composite: `load_jax_params` raises on any unused or missing key."""
    jcfg, jtid = _jax_cfg(), JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    ids = jnp.asarray([[1, 10] + [jtid.imp] * jcfg.vis_encoder.num_patches
                       + [11]], jnp.int32)
    embs, src = _head_inputs(10, B=1)
    rng = jax.random.PRNGKey(0)

    def init_method(m, ids, images, embs, src):
        m.core(ids, images, jtid)
        m.sd(embs, src, rng)
        return m.ip2p(embs, src, src, rng)

    tree = _random_tree(jax.eval_shape(lambda: jmodel.init(
        rng, ids, jnp.zeros((1, size, size, 3)), embs, src,
        method=init_method)), 11)
    assert set(tree) == {"core", "sd", "ip2p"}
    model = build_model(_port_cfg(), device="cpu", dtype=torch.float32)
    load_jax_params(model, tree)
    np.testing.assert_array_equal(
        model.ip2p.mapper.mapper_queries.detach().numpy(),
        tree["ip2p"]["mapper"]["mapper_queries"].astype(np.float32))
    np.testing.assert_array_equal(
        model.sd.unet.down_0_res_0.conv1.weight.detach().numpy(),
        tree["sd"]["unet"]["down_0_res_0"]["conv1"]["kernel"].transpose(
            3, 2, 0, 1).astype(np.float32))


def test_gen_model_full_width_maps_on_meta():
    """The JAX `vllm_7b_config` gen model's param tree at full width (its
    shapes from `jax.eval_shape`, each leaf a zero-stride numpy array)
    maps leaf for leaf onto `vllm_7b_gen_config()`'s model laid out on the
    meta device, each at its parameter's shape: the SD-1.5 UNet (4 and 8
    input channels), the VAE, the 4096 -> 768 mapper. The heads hold about
    2 x 0.95 B parameters."""
    jcfg = jconfig.vllm_7b_config(use_gdino=False, use_unipose=False,
                                  use_region_encoder=False)
    jmodel = JaxModel(jcfg)
    rng = jax.random.PRNGKey(0)

    def init_method(m, embs, src):
        m.sd(embs, src, rng)
        return m.ip2p(embs, src, src, rng)

    shapes = jax.eval_shape(lambda: jmodel.init(
        rng, jnp.zeros((1, 64, 4096)), jnp.zeros((1, 512, 512, 3)),
        method=init_method))["params"]
    tree = jax.tree.map(
        lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape), shapes)
    with torch.device("meta"):
        tmodel = VisionLLMWithTools(pconfig.vllm_7b_gen_config())
    for name in ("sd", "ip2p"):
        arrays = {}
        convert._emit(getattr(tmodel, name), "", tree[name], arrays)
        own = dict(getattr(tmodel, name).named_parameters())
        assert set(arrays) == set(own)
        bad = {k: (arrays[k].shape, tuple(own[k].shape)) for k in own
               if tuple(arrays[k].shape) != tuple(own[k].shape)}
        assert not bad
    assert tuple(tmodel.ip2p.unet.conv_in.weight.shape) == (320, 8, 3, 3)
    assert tuple(tmodel.sd.unet.conv_in.weight.shape) == (320, 4, 3, 3)
    assert tuple(tmodel.sd.mapper.emb_proj_0.weight.shape) == (768, 4096)
    count = sum(p.numel() for p in tmodel.sd.parameters())
    assert 0.9e9 < count < 1.0e9


def test_build_model_keeps_the_heads_fp32_parts_in_fp32():
    model = build_model(_port_cfg(), device="cpu", dtype=torch.bfloat16)
    for head in (model.sd, model.ip2p):
        assert {p.dtype for p in head.mapper.parameters()} == {
            torch.float32}
        for kind in (GroupNorm32, U.LayerNorm):
            norms = [m for m in head.modules() if isinstance(m, kind)]
            assert norms and all(m.weight.dtype == m.bias.dtype
                                 == torch.float32 for m in norms), kind
        assert head.unet.conv_in.weight.dtype == torch.bfloat16
        for conv in (head.unet.conv_in, head.unet.up_0_res_0.conv1,
                     head.vae.decoder.conv_out):
            assert conv.weight.is_contiguous(memory_format=U.MAP_FORMAT)
        assert head.vae.decoder.conv_out.weight.dtype == torch.bfloat16
        assert head.dtype == torch.bfloat16
    assert model.core.llm.embed_tokens.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no gdino tool"):
        model._tool("gdino")
    model = build_model(pconfig.tiny_test_config(), device="cpu",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="no sd tool"):
        model._tool("sd")


def test_bf16_unet_and_mapper_match_jax_bf16():
    """JAX's bf16 [GEN] head (fp32 params, bf16 compute; the mapper fp32)
    against `build_model`'s bf16 head on the same params: the mapper's
    conditioning (fp32 on both sides) within 1e-4; the UNet's first
    GroupNorm on a bf16 map, fp32 on both sides, within 1e-5 (a GroupNorm
    cast to bf16 rounds its scale and output by up to 2^-9); one tiny
    UNet pass within 2e-2 relative Frobenius error of JAX's bf16 pass
    (measured 0.0153), and, against JAX's fp32 pass on the same params as
    the witness, as far from it as JAX's bf16 pass is within a factor
    0.5-1.2 (measured 0.93; a port computing in fp32 reads 0).

    The two bf16 passes differ by independent roundings, about one bf16
    rounding in a third of the elements a layer, not by a fault: each
    Conv and Dense adds its bias after the product's bf16 rounding in
    flax and before it in PyTorch (`test_bf16_layer_matches_flax_rounding`
    shows them identical but for one element in a thousand once the
    order is the same), and XLA and
    PyTorch round bf16 silu and gelu differently (a fifth to a third of
    the elements). Adding the biases in flax's order moves the tiny
    pass only from 0.0156 to 0.0141 of JAX's, so the roundings that
    matter are held layer by layer there, and not here."""
    import flax.linen as fnn
    embs, src = _head_inputs(12)
    rng = jax.random.PRNGKey(1)
    g = np.random.default_rng(14)
    lat = g.standard_normal((2, 16, 16, 4)).astype(np.float32)
    fmap = jnp.asarray(g.standard_normal((2, 16, 16, 32)), jnp.bfloat16)
    t = np.asarray([961, 41], np.int32)
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jsd = JaxSD(jconfig.SDConfig(**HEAD), dtype=dt)
        params = _random_tree(jax.eval_shape(
            lambda: jsd.init(rng, embs, src, rng)), 13)

        def unet_on_cond(m, e, x, t):
            cond = m.map_embeddings(e)
            return cond, m.unet(x.astype(dt), t, cond)

        outs[dt] = o0_jit(lambda p, e, x, tt: jsd.apply(
            {"params": p}, e, x, tt, method=unet_on_cond))(
                params, embs, lat, t)
    (cond_j, eps_j), eps_f32 = outs[jnp.bfloat16], outs[jnp.float32][1]
    assert cond_j.dtype == jnp.float32 and eps_j.dtype == jnp.bfloat16
    norm_j = fnn.GroupNorm(num_groups=8, epsilon=1e-5).apply(
        {"params": params["unet"]["down_0_res_0"]["norm1"]}, fmap)
    assert norm_j.dtype == jnp.float32
    model = build_model(_port_cfg(), device="cpu", dtype=torch.bfloat16)
    load_jax_params(model.sd, params)
    with torch.no_grad():
        cond = model.sd.map_embeddings(_t(embs))
        eps = model.sd.unet(_t(lat), _t(t), cond)
        norm = model.sd.unet.down_0_res_0.norm1(
            _t(fmap.astype(jnp.float32)).to(torch.bfloat16).permute(
                0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert cond.dtype == torch.float32 and eps.dtype == torch.bfloat16
    assert norm.dtype == torch.float32
    _close(cond, cond_j)
    _close(norm, norm_j, atol=1e-5, rtol=1e-5)
    err = _rel(eps, eps_j)
    assert err <= BF16_REL_TOL, err
    ratio = _rel(eps, eps_f32) / _rel(_t(eps_j.astype(jnp.float32)), eps_f32)
    assert 0.5 <= ratio <= 1.2, ratio


def _dense_bias_after_rounding(self, x):
    """flax's order: the product rounded to the compute dtype, then the
    bias added."""
    y = F.linear(x.to(self.weight.dtype), self.weight)
    return y if self.bias is None else y + self.bias.to(y.dtype)


def _conv_bias_after_rounding(self, x):
    y = self._conv_forward(x.to(self.weight.dtype), self.weight, None)
    return y + self.bias.to(y.dtype)[:, None, None]


def _bf16_layer(case, g):
    """(flax module, its params, its inputs, the port's module holding
    them, the port's inputs, the port's output to NHWC) for one case."""
    import flax.linen as fnn
    from visionllm_tpu.models.stable_diffusion import unet as JU

    def normal(*shape, scale=1.0):
        return (scale * g.standard_normal(shape)).astype(np.float32)

    to_nhwc = (lambda y: y)
    if case == "conv":
        jm, port = fnn.Conv(64, (3, 3), padding=1, dtype=jnp.bfloat16), \
            U.conv3x3(64, 64)
        params = {"kernel": normal(3, 3, 64, 64, scale=1 / 24),
                  "bias": normal(64, scale=0.5)}
        args = (normal(2, 16, 16, 64),)
        port_args = (_t(args[0]).permute(0, 3, 1, 2),)
        to_nhwc = (lambda y: y.permute(0, 2, 3, 1))
    elif case == "dense":
        jm, port = fnn.Dense(320, dtype=jnp.bfloat16), U.Dense(320, 320)
        params = {"kernel": normal(320, 320, scale=320 ** -0.5),
                  "bias": normal(320, scale=0.5)}
        args = (normal(2, 64, 320),)
        port_args = (_t(args[0]),)
    elif case == "layernorm":
        jm, port = fnn.LayerNorm(dtype=jnp.bfloat16), U.LayerNorm(320)
        params = {"scale": 1 + normal(320, scale=0.1),
                  "bias": normal(320, scale=0.02)}
        args = (3 * normal(2, 256, 320) + 1,)
        port_args = (_t(args[0]),)
    else:                       # SD-1.5's head width: 8 heads of 40
        cross = case == "cross_attn"
        jm = JU.CrossAttention(320, 8, 96 if cross else None,
                               dtype=jnp.bfloat16)
        port = U.CrossAttention(320, 8, 96 if cross else None)
        params = {"to_q": {"kernel": normal(320, 320, scale=320 ** -0.5)},
                  "to_k": {"kernel": normal(96 if cross else 320, 320,
                                            scale=0.1)},
                  "to_v": {"kernel": normal(96 if cross else 320, 320,
                                            scale=0.1)},
                  "to_out": {"kernel": normal(320, 320, scale=320 ** -0.5),
                             "bias": normal(320, scale=0.5)}}
        args = (normal(2, 256, 320),) + ((normal(2, 77, 96),) if cross
                                         else ())
        port_args = tuple(_t(a) for a in args)
    if case != "layernorm":     # the LayerNorm keeps fp32 params
        port = port.to(torch.bfloat16)
    load_jax_params(port, params)
    args = tuple(jnp.asarray(a, jnp.bfloat16) for a in args)
    port_args = tuple(a.to(torch.bfloat16) for a in port_args)
    return jm, params, args, port, port_args, to_nhwc


@pytest.mark.parametrize("case,tol", [
    ("conv", 0.0), ("dense", 0.0), ("self_attn", 5e-4),
    ("cross_attn", 5e-4), ("layernorm", 1e-4)])
def test_bf16_layer_matches_flax_rounding(case, tol, monkeypatch):
    """One bf16 layer of the UNet against flax's in bf16 (bf16 inputs,
    flax's fp32 params) at SD-1.5's widths, with the port's Conv and
    Dense adding their bias after the product's bf16 rounding as flax
    does (the one ordering PyTorch does otherwise):
    * Conv and Dense: identical but for at most one element in a
      thousand, one bf16 ulp apart (the fp32 sum's order flips a
      rounding; measured 3 of 32768 for the conv); in PyTorch's own
      order a third of the elements sit one rounding apart;
    * self- and cross-attention, 8 heads of 40: within 5e-4 relative
      Frobenius error (measured 2.3e-4 / 0.9e-4, from the fp32 sums'
      order in the scores and softmax); the same test reads 2.5e-3 to
      5.6e-3 for an attention that takes its scores in bf16, 1.9e-3 to
      2.8e-3 for one whose PV product is fp32;
    * LayerNorm: within 1e-4 (measured 1.4e-5); with bf16 parameters,
      as a blanket bf16 cast leaves them, it reads 2.9e-3."""
    monkeypatch.setattr(U.Dense, "forward", _dense_bias_after_rounding)
    monkeypatch.setattr(U.Conv, "forward", _conv_bias_after_rounding)
    jm, params, args, port, port_args, to_nhwc = _bf16_layer(
        case, np.random.default_rng(30))
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args)
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = to_nhwc(port(*port_args))
    assert got.dtype == torch.bfloat16
    if tol == 0.0:
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        apart = got != want
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want[apart]))) - 7)
        assert apart.mean() <= 1e-3, apart.mean()
        assert np.all(np.abs(got - want)[apart] <= ulp)
    else:
        err = _rel(got, want)
        assert err <= tol, err


# ---------------------------------------------------------------------------
# the pipeline end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline(heads):
    """JAX's tiny fp32 core (initialised alone) and the port's gen
    composite holding its params beside the heads'."""
    jsd, sd_params, jip, ip_params, model = heads
    jcfg, jtid = _jax_cfg(), JaxTid.synthetic()
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    ids = jnp.asarray([[1, 10] + [jtid.imp] * jcfg.vis_encoder.num_patches
                       + [11]], jnp.int32)
    core_params = _random_tree(jax.eval_shape(lambda: jcore.init(
        jax.random.PRNGKey(0), ids, jnp.zeros((1, size, size, 3)), jtid)),
        20)
    load_jax_params(model.core, core_params)
    return jcore, core_params, model


@pytest.mark.parametrize("tool", ["edit", "gen"])
def test_pipeline_end_to_end_matches_jax(heads, pipeline, tool):
    """Prompt -> greedy decode with the first token forced to [EDIT] or
    [GEN] -> the num_embs_gen [EMB] rows -> the head's DDIM -> the VAE
    decode, against the JAX pipeline on the same params and start."""
    jsd, sd_params, jip, ip_params, model = heads
    jcore, core_params, _ = pipeline
    cfg, jcfg = model.cfg, jcore.cfg
    tid, jtid = SpecialTokenIds.synthetic(), JaxTid.synthetic()
    rng = np.random.default_rng(21)
    n_gen, size = cfg.num_embs_gen, cfg.vis_encoder.image_size
    if tool == "edit":
        ids = np.asarray([[1, 10] + [tid.imp] * cfg.vis_encoder.num_patches
                          + [11, 12]], np.int32)
        images = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    else:
        ids = np.asarray([[1, 14, 15, 16, 17, 11]], np.int32)
        images = None
    src = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    first = tid.edit if tool == "edit" else tid.gen
    new = n_gen + 3

    jgen = jax_generate_fn(jcore, jtid, max_new_tokens=new, max_len=MAX_LEN)
    jout = jgen(core_params, jnp.asarray(ids),
                None if images is None else jnp.asarray(images),
                first_token=jnp.asarray([first], jnp.int32))
    jrows = jax_tool_queries(jcfg, jtid, jout["out_tokens"],
                             jout["out_hidden"])[tool]
    gen = build_generate_fn(model.core, tid, max_new_tokens=new,
                            max_len=MAX_LEN)
    out = gen(_t(ids).long(), None if images is None else _t(images),
              first_token=torch.tensor([first], dtype=torch.int32))
    toks = out["out_tokens"][0].tolist()
    assert toks == np.asarray(jout["out_tokens"][0]).tolist()
    assert toks[0] == first and toks[1:1 + n_gen] == [tid.emb] * n_gen
    rows, mask = tool_queries(cfg, tid, out["out_tokens"],
                              out["out_hidden"])[tool]
    assert bool(mask[0, 0]) and not bool(mask[0, 1:].any())
    embs = rows[:, 0]
    assert embs.shape == (1, n_gen, cfg.llm.hidden_size)
    _close(embs, jrows[0][:, 0])

    key = jax.random.PRNGKey(22)
    lat = _jax_latents(key, 1)
    jembs = np.asarray(jrows[0][:, 0])
    with torch.no_grad():
        if tool == "edit":
            want = _jax_ip2p_image(jip, ip_params, jembs, src, key, 2)
            got = model.ip2p.generate(embs, _t(src), None, 2, latents=lat)
            again = model.ip2p.generate(embs, _t(src), None, 2, latents=lat)
        else:
            want = _jax_sd_image(jsd, sd_params, jembs, key, 2)
            got = model.sd.generate(embs, None, 2, latents=lat)
            again = model.sd.generate(embs, None, 2, latents=lat)
    assert got.shape == (1, IMG, IMG, 3) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    _close(got, want)
