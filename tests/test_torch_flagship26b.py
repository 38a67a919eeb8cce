"""Parity of the port's whole 26B flagship against the JAX package on the
CPU, in fp32: `vllm_26b_config()` field for field, the Swin-L backbone
at window 12 and Grounding-DINO on it, and a tiny model of the 26B's
shape built whole and loaded from JAX's params.

The tiny model has InternViT (2 layers of width 32, QK-norm, layer
scale), pixel shuffle and the `internvl_mlp` bridge, an InternLM2-style
LLM of 2 layers with 12 heads over 2 KV heads (the 20B's 6:1 group),
Grounding-DINO and UniPose both on the JAX test backbone
`intern_image_tiny`, tiny SD and IP2P heads at the LLM's width 96, and
the region encoder from the ViT's 32 features to the LLM's 96. It is
held to JAX's on `infer_det` over a 7-tile stack, `infer_pose`, the
[GEN] and [EDIT] rows of a greedy decode with the first token forced
(and `extract_gen_embs` on one prefill of the prompt and those tokens)
and the mappers' outputs on them, a region prompt's <region> rows, and
one `ChatService` greedy answer under `internlm2_chat` (text only: JAX's
service counts (image_size // 14) ** 2 <im_patch> tokens a tile where
pixel shuffle leaves a quarter, `ROADMAP.md` §C.2).

Grounding-DINO on `swin_large` runs with `backbone_overrides` (width 48,
depths (1, 1, 2, 1)) at window 12 on a 200 x 152 image: its levels
(50 x 38, 25 x 19, 13 x 10, 7 x 5) are no multiples of 12, so every
stage pads and the shifted windows take the masked path.

The flax param trees take their shapes from `jax.eval_shape` of the JAX
init and their values from numpy (`random_flax_params`); the JAX side
compiles at XLA optimization level 0 (`o0_jit`).

Tolerance: 1e-4 abs + 1e-4 rel (fp32, summation order) on every module
output; logprobs 2e-4; token ids identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import (_assert_pose_close, _pose_prompt,
                                      o0_jit, random_flax_params)
from visionllm_tpu import config as jconfig
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.generation import (
    extract_tool_queries_from_generation as jax_tool_queries)
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.grounding_dino.model import (
    GroundingDino as JaxGDino)
from visionllm_tpu.models.swin import SwinBackbone as JaxSwin
from visionllm_tpu.models.swin import swin_large_config as jax_swin_large
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.serve import ChatService as JaxChatService
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.generation import (
    extract_tool_queries_from_generation as tool_queries)
from visionllm_tpu_torch.models.backbone import BACKBONES, build_backbone
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.grounding_dino.model import GroundingDino
from visionllm_tpu_torch.models.swin import (SwinBackbone,
                                             swin_large_config)
from visionllm_tpu_torch.models.unipose.model import UniPose
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.serve import ChatService
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)
LOGPROB_TOL = dict(atol=2e-4, rtol=2e-4)
DET = 128
TILES = 7
IMG = 32              # the tiny VAE's image side (sample_size 16, x2)
MAX_LEN = 128
# Swin-L at reduced width and depth, its window 12 and heads kept
SWIN_L = dict(embed_dim=48, depths=(1, 1, 2, 1))
SWIN_HW = (200, 152)


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _init(module, seed, *args, method=None):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))
    return jax.tree.map(np.asarray,
                        random_flax_params(shapes["params"], seed))


def _restrict(want, got):
    """`want` (nested dicts) cut to the keys `got` has, at every level."""
    return {k: _restrict(want[k], v) if isinstance(v, dict)
            and isinstance(want.get(k), dict) else want.get(k, KeyError)
            for k, v in got.items()}


# ---------------------------------------------------------------------------
# the presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whole", "det"])
def test_26b_config_matches_jax_field_for_field(name):
    """`vllm_26b_config()` and `vllm_26b_det_config()` against JAX's
    `vllm_26b_config()` (with the det path's tools off): every field of
    the port's, nested ones included, equals JAX's (`dataclasses.asdict`),
    and the nested configs of the tools but Grounding-DINO have JAX's
    fields (the port's `GDinoConfig` keeps no `aux_loss`)."""
    if name == "whole":
        got, want = pconfig.vllm_26b_config(), jconfig.vllm_26b_config()
    else:
        got = pconfig.vllm_26b_det_config()
        want = jconfig.vllm_26b_config(use_unipose=False, use_sd=False,
                                       use_ip2p=False,
                                       use_region_encoder=False)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert _restrict(w, g) == g
    for tool in ("unipose", "sd", "ip2p", "region_encoder"):
        assert set(g[tool]) == set(w[tool]), tool
    on = {t: getattr(got, f"use_{t}") for t in
          ("gdino", "unipose", "sd", "ip2p", "region_encoder")}
    assert on == {t: name == "whole" or t == "gdino" for t in on}
    assert got.unipose.backbone == got.gdino.backbone == "intern_image_h"
    assert got.image_token_len == 256


def test_swin_large_preset_matches_jax():
    assert dataclasses.asdict(swin_large_config()) == dataclasses.asdict(
        jax_swin_large())
    assert dataclasses.asdict(swin_large_config(**SWIN_L)) == \
        dataclasses.asdict(jax_swin_large(**SWIN_L))


@pytest.mark.parametrize("tool", ["gdino", "unipose"])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_both_tools_take_every_backbone(tool, backbone):
    """Grounding-DINO and UniPose build on each backbone JAX names, on
    the meta device, their input projections at the backbone's own stage
    widths (UniPose: stages 1-3, so 640 / 1280 / 2560 on InternImage-H)."""
    with torch.device("meta"):
        mod = (GroundingDino(pconfig.GDinoConfig(backbone=backbone))
               if tool == "gdino"
               else UniPose(pconfig.UniPoseConfig(backbone=backbone)))
        _, bb_cfg = build_backbone(backbone, (1, 2, 3))
    widths = [mod.input_proj_0.in_channels, mod.input_proj_1.in_channels,
              mod.input_proj_2.in_channels, mod.input_proj_3.in_channels]
    assert widths == [bb_cfg.stage_dim(s) for s in (1, 2, 3, 3)]
    if backbone == "intern_image_h":
        assert widths[:3] == [640, 1280, 2560]


# ---------------------------------------------------------------------------
# Swin-L at window 12, Grounding-DINO on it
# ---------------------------------------------------------------------------

def test_swin_large_backbone_at_window_12_matches_jax():
    """Each stage map of Swin-L (reduced width and depth, window 12) on a
    200 x 152 image whose stage grids are no multiples of 12."""
    cfg = jax_swin_large(out_stages=(0, 1, 2, 3), **SWIN_L)
    x = _np(np.random.default_rng(31), 1, *SWIN_HW, 3, scale=0.5)
    jmod = JaxSwin(cfg, jnp.float32)
    params = _init(jmod, 32, x)
    want = o0_jit(lambda p, a: jmod.apply({"params": p}, a))(params, x)
    tmod = SwinBackbone(swin_large_config(out_stages=(0, 1, 2, 3),
                                          **SWIN_L))
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == [(50, 38), (25, 19),
                                                  (13, 10), (7, 5)]
    for g, w in zip(got, want):
        _close(g, w)


def test_gdino_on_swin_large_matches_jax():
    """Grounding-DINO on `swin_large` with `backbone_overrides`, at the
    200 x 152 image with its right columns padding."""
    kw = dict(backbone="swin_large", backbone_overrides=SWIN_L, d_model=32,
              num_queries=20, encoder_layers=1, decoder_layers=1,
              num_heads=4, ffn_dim=64, text_dim=64, mask_dim=32,
              dn_number=4, num_mask_points=64)
    jcfg = jconfig.GDinoConfig(**kw)
    rng = np.random.default_rng(33)
    pix = _np(rng, 1, *SWIN_HW, 3, scale=0.5)
    pmask = np.ones((1,) + SWIN_HW, bool)
    pmask[:, :, 120:] = False
    tq = _np(rng, 1, 2, 4, jcfg.text_dim)
    tq_mask = np.asarray([[True, True]])
    jmod = JaxGDino(jcfg, jnp.float32)
    params = _init(jmod, 34, pix, tq, tq_mask, pmask)
    want = o0_jit(lambda p, a, b, c, d: jmod.apply(
        {"params": p}, a, b, c, pixel_mask=d))(params, pix, tq, tq_mask,
                                               pmask)
    tmod = GroundingDino(pconfig.GDinoConfig(**kw))
    assert tmod.backbone.cfg.window_size == 12
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(pix), torch.from_numpy(tq),
                   torch.from_numpy(tq_mask),
                   pixel_mask=torch.from_numpy(pmask))
    for key in ("logits", "enc_logits"):
        _close(got[key][..., :2], want[key][..., :2])
    for key in ("pred_boxes", "pred_masks", "enc_boxes"):
        _close(got[key], want[key])


# ---------------------------------------------------------------------------
# the tiny 26B-shaped model, built whole
# ---------------------------------------------------------------------------

def _tiny26(mod):
    """The tiny model of the 26B's shape in config module `mod` (JAX's or
    the port's)."""
    head = dict(llm_hidden_size=96, sd_hidden_size=32, num_queries=7,
                num_embs_gen=8, sample_size=16, cross_attention_dim=32)
    return mod.tiny_test_config(
        vis_encoder=mod.VisionEncoderConfig(
            arch="intern_vit", image_size=56, patch_size=14, hidden_size=32,
            intermediate_size=64, num_layers=2, num_heads=4,
            layer_norm_eps=1e-6, hidden_act="gelu", qk_normalization=True,
            use_ls=True, qkv_bias=False, output_layer=-1),
        llm=mod.LLMConfig(
            arch="internlm2", vocab_size=32096, hidden_size=96,
            intermediate_size=128, num_layers=2, num_heads=12,
            num_kv_heads=2, rope_theta=1000000.0,
            max_position_embeddings=512),
        vl_bridge_type="internvl_mlp", use_pixelshuffle=True,
        use_gdino=True,
        gdino=mod.GDinoConfig(
            backbone="intern_image_tiny", d_model=32, num_queries=20,
            encoder_layers=1, decoder_layers=2, num_heads=4, ffn_dim=64,
            text_dim=96, mask_dim=32, dn_number=4, num_mask_points=64),
        use_unipose=True,
        unipose=mod.UniPoseConfig(
            backbone="intern_image_tiny", d_model=32, num_queries=20,
            encoder_layers=1, decoder_layers=3, num_heads=4, ffn_dim=64,
            text_dim=96, num_body_points=4, num_groups=5,
            max_obj_patches=8, max_kpt_patches=8),
        use_sd=True, sd=mod.SDConfig(**head),
        use_ip2p=True, ip2p=mod.IP2PConfig(**head),
        use_region_encoder=True,
        region_encoder=mod.RegionEncoderConfig(
            hidden_dim=16, embed_dim=32, out_dim=96, patch_size=14,
            num_sample_points=32),
        num_embs_gen=8, max_num_patches=10)


def _det_ids(tid, tiles, groups=2, regions=0):
    """4 <im_patch> a tile (a 56 px tile's 16 patches after pixel
    shuffle), `regions` <region> tokens, then [DET][EMB x4] groups."""
    ids = [1, 10, 11] + [tid.imp] * (4 * tiles) + [12]
    for r in range(regions):
        ids += [tid.reg, 40 + r]
    for g in range(groups):
        ids += [tid.det] + [tid.emb + i for i in range(4)] + [13 + g]
    return np.asarray([ids + [2]], np.int32)


def _region_masks(rng, R):
    size = 56
    masks = np.zeros((1, R, size, size), np.float32)
    masks[0, 0, 8:30, 5:40] = 1
    masks[0, 1] = rng.random((size, size)) < 0.3
    return masks


@pytest.fixture(scope="module")
def whole():
    """JAX's tiny 26B-shaped composite with every tool, its param tree
    (every submodule initialised), and the port's model built whole from
    the port's config and loaded from that tree."""
    torch.set_num_threads(1)
    jcfg, jtid = _tiny26(jconfig), JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    rng = jax.random.PRNGKey(1)
    size = jcfg.vis_encoder.image_size

    def init_method(m, ids, reg_ids, pose_ids, images, aug, regions, embs,
                    src):
        m.core(reg_ids, images, jtid, compute_logits=True, regions=regions)
        m.infer_det(ids, images, aug, jtid)
        m.infer_pose(pose_ids, images, aug, jtid, 1)
        m.sd(embs, src, rng)
        return m.ip2p(embs, src, src, rng)

    params = _init(
        jmodel, 41, jnp.asarray(_det_ids(jtid, 1)),
        jnp.asarray(_det_ids(jtid, 1, 1, 2)),
        jnp.asarray(_pose_prompt(jtid, 4, 4)),
        jnp.zeros((1, size, size, 3)), jnp.zeros((1, DET, DET, 3)),
        jnp.ones((1, 2, size, size)), jnp.zeros((1, 8, 96)),
        jnp.zeros((1, IMG, IMG, 3)), method=init_method)
    tmodel = build_model(_tiny26(pconfig), device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)
    return jcfg, jmodel, params, tmodel


def test_tiny_26b_built_whole_holds_every_jax_param(whole):
    jcfg, _, params, tmodel = whole
    assert all(getattr(tmodel, t) is not None
               for t in ("gdino", "unipose", "sd", "ip2p"))
    assert tmodel.core.region_encoder is not None
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax
    assert tuple(tmodel.core.region_encoder.up_dim.weight.shape)[0] == 96


def test_tiny_26b_infer_det_tile_stack_matches_jax(whole):
    jcfg, jmodel, params, tmodel = whole
    tid = SpecialTokenIds.synthetic()
    ids = _det_ids(tid, TILES)
    rng = np.random.default_rng(42)
    size = jcfg.vis_encoder.image_size
    images = _np(rng, 1, TILES, size, size, 3, scale=0.5)
    aug = _np(rng, 1, DET, DET, 3, scale=0.5)
    want = o0_jit(lambda p, a, b, c: jmodel.apply(
        {"params": p}, a, b, c, JaxTid.synthetic(),
        method=JaxModel.infer_det))(params, ids, images, aug)
    got = tmodel.infer_det(torch.from_numpy(ids).long(),
                           torch.from_numpy(images), torch.from_numpy(aug),
                           tid)
    for key in ("logits", "enc_logits"):
        _close(got[key][..., :2], want[key][..., :2])
    for key in ("pred_boxes", "pred_masks", "enc_boxes"):
        _close(got[key], want[key])


def test_tiny_26b_infer_pose_on_intern_image_matches_jax(whole):
    """UniPose on `intern_image_tiny` (stages 1-3), the whole
    `infer_pose`, with the bottom of the det image padding."""
    jcfg, jmodel, params, tmodel = whole
    tid = SpecialTokenIds.synthetic()
    ids = _pose_prompt(tid, 4, 3)
    rng = np.random.default_rng(43)
    size = jcfg.vis_encoder.image_size
    images = _np(rng, 1, size, size, 3, scale=0.5)
    aug = _np(rng, 1, DET, DET, 3, scale=0.5)
    mask = np.zeros((1, DET, DET), bool)
    mask[:, :96] = True
    want = o0_jit(lambda p, a, b, c, d: jmodel.apply(
        {"params": p}, a, b, c, JaxTid.synthetic(), 1, pixel_mask=d,
        method=JaxModel.infer_pose))(params, ids, images, aug, mask)
    got = tmodel.infer_pose(torch.from_numpy(ids).long(),
                            torch.from_numpy(images), torch.from_numpy(aug),
                            tid, 1, pixel_mask=torch.from_numpy(mask))
    assert tmodel.unipose.backbone.cfg.out_indices == (1, 2, 3)
    _assert_pose_close(got, want, np.ones((1, 1), bool))


@pytest.mark.parametrize("tool", ["gen", "edit"])
def test_tiny_26b_gen_rows_through_the_mapper_match_jax(whole, tool):
    """A greedy decode with the first token forced to [GEN] / [EDIT]: the
    tokens, the num_embs_gen [EMB] rows (InternLM2's width 96) and the
    head's mapper output on them (96 -> 32, 7 queries)."""
    jcfg, jmodel, params, tmodel = whole
    tid, jtid = SpecialTokenIds.synthetic(), JaxTid.synthetic()
    size = jcfg.vis_encoder.image_size
    if tool == "edit":
        ids = np.asarray([[1, 10] + [tid.imp] * 4 + [11, 12]], np.int32)
        images = _np(np.random.default_rng(44), 1, size, size, 3, scale=0.5)
    else:
        ids = np.asarray([[1, 14, 15, 16, 17, 11]], np.int32)
        images = None
    first = getattr(tid, tool)
    new = jcfg.num_embs_gen + 3
    jgen = jax_generate_fn(JaxCore(jcfg, dtype=jnp.float32), jtid,
                           max_new_tokens=new, max_len=MAX_LEN)
    jout = jgen(params["core"], jnp.asarray(ids),
                None if images is None else jnp.asarray(images),
                first_token=jnp.asarray([first], jnp.int32))
    jrows = np.asarray(jax_tool_queries(jcfg, jtid, jout["out_tokens"],
                                        jout["out_hidden"])[tool][0][:, 0])
    gen = build_generate_fn(tmodel.core, tid, max_new_tokens=new,
                            max_len=MAX_LEN)
    out = gen(torch.from_numpy(ids).long(),
              None if images is None else torch.from_numpy(images),
              first_token=torch.tensor([first], dtype=torch.int32))
    assert out["out_tokens"][0].tolist() == \
        np.asarray(jout["out_tokens"][0]).tolist()
    _close(out["out_logprobs"], jout["out_logprobs"], **LOGPROB_TOL)
    rows = tool_queries(tmodel.cfg, tid, out["out_tokens"],
                        out["out_hidden"])[tool][0][:, 0]
    assert tuple(rows.shape) == (1, jcfg.num_embs_gen, 96)
    _close(rows, jrows)
    # the training forward's reading: one prefill of the prompt and the
    # emitted tokens through `extract_gen_embs` gives the decode's rows
    full = torch.cat([torch.from_numpy(ids).long(),
                      out["out_tokens"][:, :1 + jcfg.num_embs_gen].long()], 1)
    with torch.no_grad():
        hid = tmodel.core(full, None if images is None
                          else torch.from_numpy(images), tid,
                          compute_logits=False)["hidden"]
    _close(tmodel.core.extract_gen_embs(
        hid, full, tid, C.TOOL_GEN if tool == "gen" else C.TOOL_EDIT), jrows)
    head = getattr(tmodel, "sd" if tool == "gen" else "ip2p")
    jhead = "sd" if tool == "gen" else "ip2p"
    want = o0_jit(lambda p, e: jmodel.apply(
        {"params": p}, e, method=lambda m, x: getattr(
            m, jhead).map_embeddings(x)))(params, jrows)
    with torch.no_grad():
        got = head.map_embeddings(torch.from_numpy(jrows.copy()))
    assert tuple(got.shape) == (1, 7, 32)
    _close(got, want)


def test_tiny_26b_region_rows_match_jax(whole):
    """A region prompt on a 7-tile stack: the rows its <region> tokens
    receive (the region encoder on the last tile's ViT levels, 32 -> 96),
    a mask region and a random one."""
    jcfg, jmodel, params, tmodel = whole
    tid = SpecialTokenIds.synthetic()
    ids = _det_ids(tid, TILES, groups=1, regions=2)
    rng = np.random.default_rng(45)
    size = jcfg.vis_encoder.image_size
    images = _np(rng, 1, TILES, size, size, 3, scale=0.5)
    masks = _region_masks(rng, 2)
    want = o0_jit(lambda p, a, b, c: jmodel.apply(
        {"params": p}, a, b, JaxTid.synthetic(), regions=c,
        method=lambda m, *x, **k: m.core.build_prompt_embeds(*x, **k)[0]))(
            params, ids, images, masks)
    with torch.no_grad():
        got, _ = tmodel.core.build_prompt_embeds(
            torch.from_numpy(ids).long(), torch.from_numpy(images), tid,
            regions=torch.from_numpy(masks))
    at = ids[0] == tid.reg
    assert at.sum() == 2
    _close(got[0][torch.from_numpy(at)], np.asarray(want)[0][at])
    _close(got, want)


def test_tiny_26b_chat_service_internlm2_chat_matches_jax(whole):
    """One greedy `ChatService` answer under `internlm2_chat` (a text
    request with a history): the prompt JAX's service renders, its ids
    and the answer's ids and text."""
    jcfg, _, params, tmodel = whole
    tok = SimpleTokenizer()
    size = jcfg.vis_encoder.image_size
    kw = dict(conv_version="internlm2_chat", max_new_tokens=8,
              max_prompt=64, batch_window_ms=1.0)
    jsvc = JaxChatService(jcfg, params["core"], tok, image_size=size,
                          dtype=jnp.float32, **kw)
    tsvc = ChatService(tmodel.cfg, tmodel.core, tok, device="cpu", **kw)
    req = dict(prompt="and what should I bring",
               history=["I plan a trip", "when do you leave"])
    try:
        jids, _, jconv = jsvc._encode(req["prompt"], None, req["history"])
        tids, _, tconv = tsvc._encode(req["prompt"], None, req["history"])
        assert tconv.get_prompt() == jconv.get_prompt()
        assert "<|im_start|>" in tconv.get_prompt()
        np.testing.assert_array_equal(tids, jids)
        want, got = jsvc.generate(**req), tsvc.generate(**req)
    finally:
        jsvc.close()
        tsvc.close()
    assert got["num_tokens"] >= 1
    assert got["ids"] == want["ids"]
    assert got["text"] == want["text"]
