"""The port's checkpoint converters (`visionllm_tpu_torch/utils/
torch_convert.py`, `convert_gdino.py`, `convert_unipose.py`,
`convert_sd.py`) against the JAX package's on the CPU.

Each case builds a state dict under the reference checkpoint's key
names from a numpy seed: from a tiny HF transformers model's key set
(LLaMA, CLIP), by hand (InternLM2's packed `wqkv`, InternViT), from a
flax tree through the JAX tests' own inverse helpers (Grounding-DINO),
or from a seeded port module through the reference-layout writer
`tests/torch_ref_layout.py` (UniPose, the SD parts, the mapper, the
region encoder, the bridges, the whole composite). Then:

* the port's converter gives exactly (bit for bit, fp32, same keys) the
  state dict that the JAX converter followed by `load_jax_params` gives
  the port's module;
* the writer writes that state back to the reference's keys exactly,
  so the JAX converter reads P back from what the port wrote;
* no key is left unread outside the JAX package's allowlist.

Also: a differing tied alias raises; bf16 stays bf16 and the fp32
modules get fp32; the InternImage tools raise naming the backbone (JAX
raises a KeyError); the full-width 7B and 26B key sets convert on the
meta device; the safetensors reader equals the `safetensors` package.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_ref_layout as W
from tests.test_convert_gdino import CFG as JAX_GDINO_CFG
from tests.test_convert_gdino import SWIN as JAX_SWIN
from tests.test_convert_gdino import _build_reference_sd
from tests.test_torch_flagship26b import _tiny26
from tests.test_torch_unipose import random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.grounding_dino import model as jgm
from visionllm_tpu.models.stable_diffusion import sd_head as jsd
from visionllm_tpu.utils import convert_sd as JSD
from visionllm_tpu.utils import torch_convert as JT
from visionllm_tpu.utils.convert_gdino import convert_gdino as jax_gdino
from visionllm_tpu.utils.convert_unipose import convert_unipose as jax_unipose
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch.models.clip_vit import ClipVisionTower
from visionllm_tpu_torch.models.composite import _meta_model, build_model
from visionllm_tpu_torch.models.grounding_dino.model import GroundingDino
from visionllm_tpu_torch.models.intern_vit import InternVisionTower
from visionllm_tpu_torch.models.llama import LlamaModel
from visionllm_tpu_torch.models.region_encoder import RegionEncoder
from visionllm_tpu_torch.models.stable_diffusion import clip_text as PCT
from visionllm_tpu_torch.models.stable_diffusion import sd_head as psd
from visionllm_tpu_torch.models.stable_diffusion.unet import UNet2DCondition
from visionllm_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
from visionllm_tpu_torch.models.unipose.model import UniPose
from visionllm_tpu_torch.models.vl_bridge import VLBridge
from visionllm_tpu_torch.utils import convert_sd as PSD
from visionllm_tpu_torch.utils import torch_convert as PT
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.convert_gdino import (convert_gdino,
                                                     swin_preset)
from visionllm_tpu_torch.utils.convert_unipose import convert_unipose

HEAD = dict(llm_hidden_size=64, sd_hidden_size=32, num_queries=7,
            num_embs_gen=8, sample_size=16, cross_attention_dim=32)
TEXT = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_position_embeddings=16)


def _seeded(module, seed):
    """`module` with every parameter drawn from numpy (seed): N(0, 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return module


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _np(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            sd.items()}


def _assert_same(got, want):
    """Same keys; each tensor of the same dtype and shape, bit for bit."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or got[k].shape != want[k].shape
           or not torch.equal(got[k], want[k])]
    assert not bad, bad[:10]


def _jax_loaded(module, tree):
    """The port module's state after `load_jax_params` of a JAX tree."""
    load_jax_params(module, tree)
    return _state(module)


def _check(port_convert, jax_convert, module, ref, write=None,
           unread=()):
    """Port converter vs JAX converter + `load_jax_params` on `ref`;
    every key read but `unread`; the writer (when given) writes the
    state back to `ref`'s keys bit for bit."""
    rec = PT.ReadRecorder(ref)
    got = port_convert(rec)
    assert rec.unread(lambda k: False) == sorted(unread)
    want = _jax_loaded(module, jax_convert(_np(ref)))
    _assert_same(got, want)
    if write is not None:
        back = write(want)
        _assert_same({k: back[k] for k in ref if k not in unread},
                     {k: v for k, v in ref.items() if k not in unread})
    return got


def _from_state(state, seed):
    """Values drawn from numpy (seed) at a state dict's shapes."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in state.items()}


# ---------------------------------------------------------------------------
# the language models and the vision towers
# ---------------------------------------------------------------------------

def test_llama_from_hf_key_set():
    transformers = pytest.importorskip("transformers")
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False))
    ref = _from_state(hf.state_dict(), 0)
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2)
    pcfg, jcfg = pconfig.LLMConfig(**kw), jconfig.LLMConfig(**kw)
    _check(lambda sd: PT.convert_llama(sd, pcfg),
           lambda sd: JT.convert_llama(sd, jcfg), LlamaModel(pcfg), ref,
           lambda s: W.write_llama(s, pcfg))


def test_clip_vit_from_hf_key_set():
    """The bare CLIP checkpoint leaves its `post_layernorm` unread (the
    allowlist names it under `vis_encoder.` only)."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=56, patch_size=14))
    ref = _from_state(hf.state_dict(), 1)
    kw = dict(image_size=56, patch_size=14, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4)
    pcfg = pconfig.VisionEncoderConfig(**kw)
    jcfg = jconfig.VisionEncoderConfig(**kw)
    _check(lambda sd: PT.convert_clip_vit(sd, pcfg),
           lambda sd: JT.convert_clip_vit(sd, jcfg), ClipVisionTower(pcfg),
           ref, lambda s: W.write_clip_vit(s, pcfg),
           unread=("vision_model.post_layernorm.bias",
                   "vision_model.post_layernorm.weight"))


def _internlm2_ref(rng, h, h_kv, d, hid, n, vocab=64, inter=96):
    ref = {"model.tok_embeddings.weight": (vocab, hid),
           "model.norm.weight": (hid,), "output.weight": (vocab, hid)}
    for i in range(n):
        lp = f"model.layers.{i}."
        ref.update({lp + "attention.wqkv.weight": ((h + 2 * h_kv) * d, hid),
                    lp + "attention.wo.weight": (hid, h * d),
                    lp + "feed_forward.w1.weight": (inter, hid),
                    lp + "feed_forward.w3.weight": (inter, hid),
                    lp + "feed_forward.w2.weight": (hid, inter),
                    lp + "attention_norm.weight": (hid,),
                    lp + "ffn_norm.weight": (hid,)})
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in ref.items()}


@pytest.mark.parametrize("ratio", [1, 2, 6])
def test_internlm2_unpacks_wqkv_per_group(ratio):
    """GQA ratio 1, 2 and 6 (the 20B's 48 heads over 8): the packed
    `wqkv` holds each kv group as [q x ratio, k, v]."""
    h_kv, d = 2, 4
    h = h_kv * ratio
    hid = h * d
    kw = dict(arch="internlm2", vocab_size=64, hidden_size=hid,
              intermediate_size=96, num_layers=2, num_heads=h,
              num_kv_heads=h_kv)
    pcfg, jcfg = pconfig.LLMConfig(**kw), jconfig.LLMConfig(**kw)
    ref = _internlm2_ref(np.random.default_rng(ratio), h, h_kv, d, hid, 2)
    got = _check(lambda sd: PT.convert_internlm2(sd, pcfg),
                 lambda sd: JT.convert_internlm2(sd, jcfg),
                 LlamaModel(pcfg), ref,
                 lambda s: W.write_internlm2(s, pcfg))
    # head j of q is row block j % ratio of kv group j // ratio
    wqkv = ref["model.layers.1.attention.wqkv.weight"].reshape(
        h_kv, ratio + 2, d, hid)
    q = got["layers.1.q_proj.weight"].reshape(h, d, hid)
    for j in range(h):
        assert torch.equal(q[j], wqkv[j // ratio, j % ratio])
    k = got["layers.1.k_proj.weight"].reshape(h_kv, d, hid)
    assert torch.equal(k, wqkv[:, ratio])


@pytest.mark.parametrize("qk_norm", [True, False])
def test_intern_vit_with_and_without_qk_norm(qk_norm):
    """InternViT's RMSNorms, layer scales, `class_embedding` [1, 1, D];
    with QK-norm and no qkv bias (the 6B's), and without QK-norm and
    with a qkv bias."""
    kw = dict(arch="intern_vit", image_size=28, patch_size=14,
              hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, qk_normalization=qk_norm, use_ls=True,
              qkv_bias=not qk_norm)
    pcfg = pconfig.VisionEncoderConfig(**kw)
    jcfg = jconfig.VisionEncoderConfig(**kw)
    rng = np.random.default_rng(7)
    D = 32
    shapes = {"embeddings.patch_embedding.weight": (D, 3, 14, 14),
              "embeddings.patch_embedding.bias": (D,),
              "embeddings.class_embedding": (1, 1, D),
              "embeddings.position_embedding": (1, 5, D)}
    for i in range(2):
        lp = f"encoder.layers.{i}."
        shapes.update({lp + "norm1.weight": (D,), lp + "norm2.weight": (D,),
                       lp + "attn.qkv.weight": (3 * D, D),
                       lp + "attn.proj.weight": (D, D),
                       lp + "attn.proj.bias": (D,),
                       lp + "mlp.fc1.weight": (64, D),
                       lp + "mlp.fc1.bias": (64,),
                       lp + "mlp.fc2.weight": (D, 64),
                       lp + "mlp.fc2.bias": (D,),
                       lp + "ls1": (D,), lp + "ls2": (D,)})
        if qk_norm:
            shapes[lp + "attn.q_norm.weight"] = (D,)
            shapes[lp + "attn.k_norm.weight"] = (D,)
        else:
            shapes[lp + "attn.qkv.bias"] = (3 * D,)
    ref = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for k, s in shapes.items()}
    _check(lambda sd: PT.convert_intern_vit(sd, pcfg),
           lambda sd: JT.convert_intern_vit(sd, jcfg),
           InternVisionTower(pcfg), ref,
           lambda s: W.write_intern_vit(s, pcfg))


@pytest.mark.parametrize("kind", ["mlp2x_gelu", "internvl_mlp"])
def test_vl_bridge(kind):
    """The Sequential indices, activation slots skipped; `internvl_mlp`'s
    leading LayerNorm."""
    state = _state(_seeded(VLBridge(kind, 24, 40), 3))
    ref = W.write_vl_bridge(state)
    _check(PT.convert_vl_bridge, JT.convert_vl_bridge,
           VLBridge(kind, 24, 40), ref, W.write_vl_bridge)


def test_region_encoder():
    cfg = pconfig.tiny_test_config().region_encoder
    state = _state(_seeded(RegionEncoder(cfg), 4))
    ref = W.write_region_encoder(state)
    _check(PT.convert_region_encoder, JT.convert_region_encoder,
           RegionEncoder(cfg), ref, W.write_region_encoder)


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def _gdino_port_cfg():
    c = JAX_GDINO_CFG
    return pconfig.GDinoConfig(
        d_model=c.d_model, num_queries=c.num_queries,
        encoder_layers=c.encoder_layers, decoder_layers=c.decoder_layers,
        num_heads=c.num_heads, ffn_dim=c.ffn_dim, text_dim=c.text_dim,
        mask_dim=c.mask_dim, dn_number=c.dn_number,
        backbone_overrides=dict(embed_dim=JAX_SWIN.embed_dim,
                                depths=JAX_SWIN.depths,
                                num_heads=JAX_SWIN.num_heads,
                                window_size=JAX_SWIN.window_size))


@pytest.fixture(scope="module")
def gdino_ref():
    """A flax Grounding-DINO tree P (the JAX converter test's config and
    Swin) drawn from numpy, and the JAX test's reference-named dict of
    it with the shared heads' tied aliases added."""
    model = jgm.GroundingDino(JAX_GDINO_CFG, dtype=jnp.float32)
    orig = jgm.swin_tiny_config
    jgm.swin_tiny_config = lambda **kw: JAX_SWIN
    try:
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
            jnp.zeros((1, 5, 4, JAX_GDINO_CFG.text_dim)),
            jnp.ones((1, 5), bool)))["params"]
    finally:
        jgm.swin_tiny_config = orig
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          random_flax_params(shapes, 5))
    ref = _build_reference_sd(params)
    n = JAX_GDINO_CFG.decoder_layers
    for head, bases in (("bbox_embed", ("bbox_embed",
                                        "model.decoder.bbox_embed")),
                        ("mask_embed", ("mask_embed",))):
        kept = {k[len(head) + 2:]: v for k, v in ref.items()
                if k.startswith(head + ".0.")}
        for base in bases:
            for i in range(n):
                if f"{base}.{i}" != f"{head}.0":
                    ref.update({f"{base}.{i}{s}": v.copy()
                                for s, v in kept.items()})
    return params, _torch(ref)


def test_gdino_matches_jax_on_the_jax_tests_reference_dict(gdino_ref):
    """The JAX converter test's own reference-named dict (HF Swin with
    separate q / k / v, packed MHA, the mask FPN, the tied heads); the
    writer writes it back exactly, plus the index buffers, and the JAX
    converter reads P back from the writer's dict."""
    params, ref = gdino_ref
    pcfg = _gdino_port_cfg()
    swin = swin_preset("swin_tiny", (0, 1, 2, 3), pcfg.backbone_overrides)
    got = _check(lambda sd: convert_gdino(sd, pcfg),
                 lambda sd: jax_gdino(sd, JAX_GDINO_CFG, swin_cfg=JAX_SWIN),
                 GroundingDino(pcfg), ref)
    back = W.write_gdino(got, pcfg, swin)
    extra = set(back) - set(ref)
    assert extra and all(k.endswith("relative_position_index")
                         for k in extra)
    _assert_same({k: back[k] for k in ref}, ref)
    again = jax_gdino(_np(back), JAX_GDINO_CFG, swin_cfg=JAX_SWIN)
    jax.tree.map(np.testing.assert_array_equal, again, params)


@pytest.mark.parametrize("alias", ["bbox_embed.1.layers.2.bias",
                                   "model.decoder.bbox_embed.0.layers.0"
                                   ".weight",
                                   "mask_embed.1.layers.1.weight"])
def test_differing_tied_alias_raises(gdino_ref, alias):
    ref = dict(gdino_ref[1])
    ref[alias] = ref[alias] + 1.0
    with pytest.raises(ValueError, match="tied copy"):
        convert_gdino(ref, _gdino_port_cfg())
    with pytest.raises(ValueError, match="tied copy"):
        jax_gdino(_np(ref), JAX_GDINO_CFG, swin_cfg=JAX_SWIN)


def test_unipose_vendored_swin_and_tied_heads():
    """UniPose on Swin-T: the vendored Swin's packed qkv, gam_v / gam_l,
    the text layers, three tied heads, hw / hw_append."""
    pcfg = pconfig.tiny_test_config().unipose
    jcfg = jconfig.tiny_test_config().unipose
    state = _state(_seeded(UniPose(pcfg), 6))
    swin = swin_preset(pcfg.backbone, (1, 2, 3))
    ref = W.write_unipose(state, pcfg, swin)
    index = [k for k in ref if k.endswith("relative_position_index")]
    assert index and any(k.startswith("transformer.decoder.pose_embed.")
                         for k in ref)
    _check(lambda sd: convert_unipose(sd, pcfg),
           lambda sd: jax_unipose(sd, jcfg), UniPose(pcfg), ref,
           lambda s: W.write_unipose(s, pcfg, swin), unread=index)


def _unet_cfgs(in_channels):
    return (psd.unet_cfg_for(16, in_channels, 32),
            jsd.unet_cfg_for(16, in_channels, 32))


@pytest.mark.parametrize("part", ["unet4", "unet8", "vae", "clip_text",
                                  "mapper"])
def test_sd_parts(part):
    """The SD head's parts at the tiny head geometry: the UNet with 4 and
    8 input channels, the VAE, the CLIP text model, the LLM -> SD mapper
    (`nn.Transformer`'s packed in_proj)."""
    if part.startswith("unet"):
        pcfg, jcfg = _unet_cfgs(int(part[4:]))
        module = lambda: UNet2DCondition(pcfg)          # noqa: E731
        port = lambda sd: PSD.convert_unet(sd, pcfg)      # noqa: E731
        jax_ = lambda sd: JSD.convert_unet(sd, jcfg)      # noqa: E731
        write = lambda s: W.write_unet(s, pcfg)           # noqa: E731
    elif part == "vae":
        pcfg, jcfg = psd.vae_cfg_for(16), jsd.vae_cfg_for(16)
        module = lambda: AutoencoderKL(pcfg)              # noqa: E731
        port = lambda sd: PSD.convert_vae(sd, pcfg)       # noqa: E731
        jax_ = lambda sd: JSD.convert_vae(sd, jcfg)       # noqa: E731
        write = lambda s: W.write_vae(s, pcfg)            # noqa: E731
    elif part == "clip_text":
        module = lambda: PCT.ClipTextModel(               # noqa: E731
            PCT.ClipTextConfig(**TEXT))
        port, jax_ = PSD.convert_clip_text, JSD.convert_clip_text
        write = W.write_clip_text
    else:
        module = lambda: psd.LLM2SDMapper(64, 32, 7)      # noqa: E731
        port, jax_ = PT.convert_llm2sd_mapper, JT.convert_llm2sd_mapper
        write = W.write_llm2sd_mapper
    state = _state(_seeded(module(), 8))
    _check(port, jax_, module(), write(state), write)


def test_unet_linear_projection_becomes_a_1x1_conv():
    """A checkpoint with `use_linear_projection` stores proj_in / proj_out
    as Linear weights [C, C]: the port's 1x1 conv gets [C, C, 1, 1], as
    JAX's gets [1, 1, C, C]."""
    pcfg, jcfg = _unet_cfgs(4)
    state = _state(_seeded(UNet2DCondition(pcfg), 9))
    ref = W.write_unet(state, pcfg)
    lin = {k: v[:, :, 0, 0].contiguous() if ".proj_" in k and v.dim() == 4
           else v for k, v in ref.items()}
    assert sum(v.dim() == 2 for k, v in lin.items() if ".proj_" in k) > 0
    _assert_same(PSD.convert_unet(lin, pcfg), state)
    _assert_same(_jax_loaded(UNet2DCondition(pcfg),
                             JSD.convert_unet(_np(lin), jcfg)), state)


# ---------------------------------------------------------------------------
# the whole checkpoint
# ---------------------------------------------------------------------------

def _tiny_all_tools(mod):
    return mod.tiny_test_config(
        use_region_encoder=True, use_sd=True, sd=mod.SDConfig(**HEAD),
        use_ip2p=True, ip2p=mod.IP2PConfig(**HEAD))


@pytest.fixture(scope="module")
def composite():
    cfg = _tiny_all_tools(pconfig)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    state = _state(model)
    return cfg, state, W.write_composite(state, cfg)


def test_composite_with_every_tool_matches_jax(composite):
    """The tiny composite with every tool (CLIP, LLaMA, the region
    encoder, Grounding-DINO and UniPose on Swin-T, both SD heads): the
    port's `convert_composite` and JAX's + `load_jax_params` both give
    the model's state back bit for bit; each reads every key but the
    allowlisted ones (index buffers, CLIP's post_layernorm, the SD text
    encoders), which the writer adds as a released checkpoint holds
    them."""
    cfg, state, ref = composite
    rec = PT.ReadRecorder(ref)
    got = PT.convert_composite(rec, cfg)
    assert rec.unread() == []
    left = rec.unread(lambda k: False)
    assert {k.split(".")[0] for k in left if ".sd_text_encoder." in k} == \
        {"sd", "ip2p"}
    assert any(k.endswith("relative_position_index") for k in left)
    assert "vis_encoder.vision_model.post_layernorm.weight" in left
    _assert_same(got, state)
    jrec = PT.ReadRecorder(_np(ref))
    tree = JT.convert_composite(jrec, _tiny_all_tools(jconfig))
    assert jrec.unread() == []
    fresh = build_model(cfg, device="cpu", dtype=torch.float32, seed=11)
    _assert_same(_jax_loaded(fresh, tree), state)
    # JAX's tree P, loaded into the port and written out, converts back
    # to P bit for bit
    again = JT.convert_composite(_np(W.write_composite(_state(fresh), cfg)),
                                 _tiny_all_tools(jconfig))
    jax.tree.map(np.testing.assert_array_equal, again, tree)
    loaded = build_model(cfg, device="cpu", dtype=torch.float32,
                         state_dict=got)
    _assert_same(_state(loaded), state)


def test_bf16_checkpoint_stays_bf16_and_fp32_modules_get_fp32(composite):
    """A bf16 checkpoint converts to bf16 tensors (no cast, no copy of a
    renamed tensor); `build_model(dtype=bf16, state_dict=...)` gives the
    `fp32_modules` fp32 and keeps the UNet's convs channels_last."""
    cfg, _, ref = composite
    ref16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in ref.items()}
    got = PT.convert_composite(ref16, cfg)
    assert {v.dtype for v in got.values()} == {torch.bfloat16}
    assert got["core.llm.norm.weight"] is ref16["llm.model.norm.weight"]
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16,
                        state_dict=got)
    fp32 = {id(p) for m in model.fp32_modules() for p in m.parameters()}
    assert fp32
    for name, p in model.named_parameters():
        want = torch.float32 if id(p) in fp32 else torch.bfloat16
        assert p.dtype == want, name
        assert torch.equal(p.detach(), got[name].to(want)), name
    assert model.core.region_encoder.stem_norm0.weight.dtype == torch.float32
    assert model.sd.mapper.emb_proj_0.weight.dtype == torch.float32
    w = model.sd.unet.conv_in.weight
    assert w.is_contiguous(memory_format=torch.channels_last)


def test_unread_keys_and_unfilled_parameters(composite):
    cfg, state, ref = composite
    rec = PT.ReadRecorder(dict(ref, **{"gdino.model.stray.weight":
                                       torch.zeros(2)}))
    got = PT.convert_composite(rec, cfg)
    assert rec.unread() == ["gdino.model.stray.weight"]
    short = dict(got)
    del short["gdino.level_embed"]
    with pytest.raises(KeyError, match="missing.*gdino.level_embed"):
        build_model(cfg, device="cpu", dtype=torch.float32, state_dict=short)
    bad = dict(got, **{"core.llm.norm.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="core.llm.norm.weight"):
        build_model(cfg, device="cpu", dtype=torch.float32, state_dict=bad)
    with pytest.raises(KeyError, match="unexpected"):
        build_model(cfg, device="cpu", dtype=torch.float32,
                    state_dict=dict(got, extra=torch.zeros(1)))


def test_26b_core_converts_and_intern_image_tools_raise():
    """The tiny 26B-shaped model (InternViT with QK-norm, pixel shuffle's
    `internvl_mlp`, InternLM2 at 12 heads over 2, the region encoder):
    its core converts as JAX's does. Its tools run on InternImage, which
    no converter reads: the port raises naming the backbone, JAX's
    converter fails on the Swin keys it looks for."""
    cfg, jcfg = _tiny26(pconfig), _tiny26(jconfig)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=12)
    core = _state(model.core)
    ref = W.write_core(core, cfg)
    got = PT.convert_composite(ref, cfg)
    _assert_same(got, {"core." + k: v for k, v in core.items()})
    tree = JT.convert_composite(_np(ref), jcfg)
    assert set(tree) == {"core"}
    fresh = build_model(cfg, device="cpu", dtype=torch.float32, seed=13)
    _assert_same(_jax_loaded(fresh.core, tree["core"]), core)
    for tool in ("gdino", "unipose"):
        with_tool = dict(ref, **{f"{tool}.model.level_embed":
                                 torch.zeros(4, 32)})
        with pytest.raises(ValueError, match="intern_image_tiny"):
            PT.convert_composite(with_tool, cfg)
        with pytest.raises(KeyError):
            JT.convert_composite(_np(with_tool), jcfg)
    with pytest.raises(ValueError, match="intern_image_h"):
        swin_preset(pconfig.vllm_26b_config().gdino.backbone, (0, 1, 2, 3))


@pytest.mark.parametrize("which", ["7b", "26b_core"])
def test_full_width_key_sets_convert_on_meta(which):
    """`vllm_7b_config()` whole and the 26B's core at full width, on the
    meta device: the writer's key set converts back to every parameter
    at its shape and dtype, every key read but the allowlisted."""
    if which == "7b":
        cfg = pconfig.vllm_7b_config()
        state = _meta_model(cfg, torch.bfloat16).state_dict()
        ref = W.write_composite(state, cfg)
        convert = PT.convert_composite
    else:
        cfg = pconfig.vllm_26b_config(use_gdino=False, use_unipose=False,
                                      use_sd=False, use_ip2p=False)
        state = {"core." + k: v for k, v in _meta_model(
            cfg, torch.bfloat16).core.state_dict().items()}
        ref = W.write_core({k[5:]: v for k, v in state.items()}, cfg)
        convert = PT.convert_composite
    rec = PT.ReadRecorder(ref)
    got = convert(rec, cfg)
    assert rec.unread() == []
    assert set(got) == set(state)
    bad = [k for k in state if got[k].shape != state[k].shape
           or got[k].dtype != state[k].dtype]
    assert not bad, bad[:10]
    if which == "26b_core":
        wqkv = ref["llm.model.layers.47.attention.wqkv.weight"]
        assert tuple(wqkv.shape) == ((48 + 2 * 8) * 128, 6144)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.int64)


def _file_dict(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3 + i, 5, generator=g) * 100
        out[f"block.{i}.weight"] = x.to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4)
    return out


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_safetensors_reader_matches_the_library(tmp_path, layout):
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy = pytest.importorskip("safetensors.numpy")
    sd = _file_dict(0)
    if layout == "single":
        path = str(tmp_path / "model.safetensors")
        st_torch.save_file(sd, path)
        files = [path]
    else:
        keys = sorted(sd)
        shards = (keys[:3], keys[3:])
        files, weight_map = [], {}
        for j, part in enumerate(shards):
            f = tmp_path / f"model-0000{j + 1}-of-00002.safetensors"
            st_torch.save_file({k: sd[k] for k in part}, str(f))
            files.append(str(f))
            weight_map.update({k: f.name for k in part})
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": weight_map}, f)
        path = str(tmp_path)
    got = PT.load_state_dict_files(path)
    want = {}
    for f in files:
        want.update(st_torch.load_file(f))
    _assert_same(got, want)
    _assert_same(got, sd)
    for f in files:
        for k, v in st_numpy.load_file(f).items():
            if got[k].dtype != torch.bfloat16:
                np.testing.assert_array_equal(got[k].numpy(), v)


def test_safetensors_index_must_match_the_shards(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    st_torch.save_file({"a": torch.ones(2)}, str(tmp_path / "m.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"a": "m.safetensors",
                                  "b": "m.safetensors"}}, f)
    with pytest.raises(ValueError, match="index"):
        PT.load_state_dict_files(str(tmp_path))


def test_written_safetensors_read_by_the_library(tmp_path):
    """`torch_ref_layout.save_safetensors` (what `chip_smoke.py` writes)
    is read back by the `safetensors` package and by the port."""
    st_torch = pytest.importorskip("safetensors.torch")
    sd = _file_dict(1)
    sd["flag"] = torch.tensor([True, False, True])
    path = str(tmp_path / "w.safetensors")
    W.save_safetensors(sd, path)
    _assert_same(st_torch.load_file(path), sd)
    _assert_same(PT.read_safetensors(path), sd)


@pytest.mark.parametrize("suffix", [".bin", ".pth"])
def test_torch_files_keep_their_dtypes(tmp_path, suffix):
    sd = _file_dict(2)
    wrapped = {"state_dict": sd} if suffix == ".pth" else sd
    torch.save(wrapped, str(tmp_path / ("pytorch_model" + suffix)))
    _assert_same(PT.load_state_dict_files(str(tmp_path)), sd)
    _assert_same(PT.load_state_dict_files(
        str(tmp_path / ("pytorch_model" + suffix))), sd)


def test_composite_round_trip_through_files(composite, tmp_path):
    """A reference-layout dict written as .safetensors and as .bin, read
    by `load_state_dict_files`, converts to the same state."""
    cfg, state, ref = composite
    part = {k: v for k, v in ref.items() if k.startswith(("gdino.",
                                                          "region_encoder."))}
    W.save_safetensors(part, str(tmp_path / "part.safetensors"))
    torch.save(part, str(tmp_path / "part.bin"))
    for name in ("part.safetensors", "part.bin"):
        back = PT.load_state_dict_files(str(tmp_path / name))
        _assert_same(back, part)
        got = convert_gdino(back, cfg.gdino, prefix="gdino.")
        _assert_same({"gdino." + k: v for k, v in got.items()},
                     {k: v for k, v in state.items()
                      if k.startswith("gdino.")})
