"""Parity of the port's 26B det path against the JAX package on the CPU,
in fp32, at a tiny form of `vllm_26b_config` (InternViT 2 layers of
width 32 with QK-norm and layer scale, pixel shuffle and the
`internvl_mlp` bridge, an InternLM2-style LLM of 2 layers with 12 heads
over 2 KV heads (the 20B model's 6:1 group), rope theta 1e6, and
Grounding-DINO on the JAX test backbone `intern_image_tiny`: InternImage
with depths (1, 1, 1, 1) and groups (2, 2, 4, 4)).

Every module holds the JAX one on the same numpy inputs: `InternVitLayer`
and `InternVisionTower` (with and without QK-norm), `pixel_shuffle`
(exact), `VLBridge("internvl_mlp")`, the LLM's prefill and cached decode
at the 6:1 group, `dcnv3_core` and `DCNv3`, `InternImage`, and
Grounding-DINO on it; then the whole tiny 26B `infer_det` on a
[1, 7, H, W, 3] tile stack (7 x 4 image tokens, as `dynamic_preprocess`
and pixel shuffle give them) and on one tile, and greedy `generate`.
`dynamic_preprocess` must give JAX's tiles byte for byte, and the JAX
26B det model's, the whole `vllm_26b_config()` model's and UniPose on
Swin-L's full-width param trees must map leaf for leaf onto the port's
models (shapes only, on the meta device), the whole model's leaf count
equal to the host-only `model_size`. The flax param
trees take their shapes from `jax.eval_shape` of the JAX init and their
values from numpy (`random_flax_params`); they reach the port through
`load_jax_params`. The JAX side compiles at XLA optimization level 0
(`o0_jit`).

One test pins a fault of the JAX reference instead of a parity: its
`Predictor` counts (image_size // 14) ** 2 = 1024 <im_patch> tokens per
448 px image, while pixel shuffle leaves 256 feature rows, so the
scatter's clipped cumsum writes row 255 into placeholders 256-1023.

Tolerance: 1e-4 abs + 1e-4 rel (fp32, summation order) on every output,
the selected proposals' boxes and logits (`enc_boxes`, `enc_logits`)
among them; pixel shuffle, tiles and token ids identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data.mm_utils import dynamic_preprocess as jax_tiles
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.grounding_dino.model import (
    GroundingDino as JaxGDino)
from visionllm_tpu.models.intern_image import InternImage as JaxInternImage
from visionllm_tpu.models.intern_image import (
    intern_image_tiny_config as jax_ii_tiny)
from visionllm_tpu.models.intern_vit import InternVisionTower as JaxTower
from visionllm_tpu.models.intern_vit import InternVitLayer as JaxVitLayer
from visionllm_tpu.models.llama import KVCache as JaxCache
from visionllm_tpu.models.llama import LlamaModel as JaxLlama
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu.models.vl_bridge import VLBridge as JaxBridge
from visionllm_tpu.models.vl_bridge import pixel_shuffle as jax_shuffle
from visionllm_tpu.ops.dcnv3 import DCNv3 as JaxDCNv3
from visionllm_tpu.ops.dcnv3 import dcnv3_core as jax_dcnv3_core
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch.data.mm_utils import dynamic_preprocess
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.grounding_dino.model import GroundingDino
from visionllm_tpu_torch.models.intern_image import (
    InternImage, intern_image_tiny_config)
from visionllm_tpu_torch.models.intern_vit import (InternVisionTower,
                                                   InternVitLayer)
from visionllm_tpu_torch.models.llama import KVCache, LlamaModel
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.models.vl_bridge import VLBridge, pixel_shuffle
from visionllm_tpu_torch.ops.dcnv3 import DCNv3, dcnv3_core
from visionllm_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
DET = 128
TILES = 7
MAX_NEW, MAX_LEN = 6, 96


def _tiny(mod, **vis):
    """The tiny 26B det config of module `mod` (the JAX `config` or the
    port's), with `vis` overriding vision-encoder fields."""
    enc = dict(arch="intern_vit", image_size=56, patch_size=14,
               hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, layer_norm_eps=1e-6, hidden_act="gelu",
               qk_normalization=True, use_ls=True, qkv_bias=False,
               output_layer=-1)
    enc.update(vis)
    kw = dict(
        vis_encoder=mod.VisionEncoderConfig(**enc),
        llm=mod.LLMConfig(
            arch="internlm2", vocab_size=32096, hidden_size=96,
            intermediate_size=128, num_layers=2, num_heads=12,
            num_kv_heads=2, rope_theta=1000000.0,
            max_position_embeddings=512),
        vl_bridge_type="internvl_mlp", use_pixelshuffle=True,
        gdino=mod.GDinoConfig(
            backbone="intern_image_tiny", d_model=32, num_queries=20,
            encoder_layers=1, decoder_layers=2, num_heads=4, ffn_dim=64,
            text_dim=96, mask_dim=32, dn_number=4, num_mask_points=64),
        use_unipose=False, unipose=None)
    if mod is jconfig:
        kw.update(use_sd=False, use_ip2p=False, use_region_encoder=False)
    return mod.tiny_test_config(**kw)


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


# ---------------------------------------------------------------------------
# InternViT, pixel shuffle, the internvl_mlp bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "plain"])
def test_intern_vit_layer_matches_jax(qk_norm):
    cfg = _tiny(jconfig, qk_normalization=qk_norm,
                qkv_bias=not qk_norm).vis_encoder
    x = _np(np.random.default_rng(0), 2, 17, cfg.hidden_size)
    jmod = JaxVitLayer(cfg, jnp.float32)
    params = _init(jmod, 1, x)
    want = o0_jit(lambda p, a: jmod.apply({"params": p}, a))(params, x)
    tmod = InternVitLayer(_tiny(pconfig, qk_normalization=qk_norm,
                                qkv_bias=not qk_norm).vis_encoder)
    load_jax_params(tmod, params)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "plain"])
def test_intern_vision_tower_matches_jax(qk_norm):
    cfg = _tiny(jconfig, qk_normalization=qk_norm).vis_encoder
    size = cfg.image_size
    x = _np(np.random.default_rng(2), 3, size, size, 3)
    jmod = JaxTower(cfg, jnp.float32)
    params = _init(jmod, 3, x)
    want = o0_jit(lambda p, a: jmod.apply({"params": p}, a))(params, x)
    tmod = InternVisionTower(_tiny(pconfig,
                                   qk_normalization=qk_norm).vis_encoder)
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == want.shape == (cfg.num_layers + 1, 3,
                                       cfg.num_patches + 1, cfg.hidden_size)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 32, 32, 3200)],
                         ids=["tiny", "internvit_448"])
def test_pixel_shuffle_matches_jax(shape):
    x = _np(np.random.default_rng(4), *shape)
    want = np.asarray(jax_shuffle(jnp.asarray(x), 0.5))
    got = pixel_shuffle(torch.from_numpy(x), 0.5)
    assert got.shape == want.shape == (shape[0], shape[1] // 2,
                                       shape[2] // 2, shape[3] * 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_internvl_bridge_matches_jax():
    """LayerNorm (flax eps 1e-6) + Linear + exact GELU + Linear, from the
    pixel-shuffled width 4 x 32 to the LLM's 96."""
    x = _np(np.random.default_rng(5), 2, 4, 128, scale=3.0)
    jmod = JaxBridge("internvl_mlp", 96, jnp.float32)
    params = _init(jmod, 6, x)
    assert set(params) == {"0", "1", "3"}
    want = jmod.apply({"params": params}, x)
    tmod = VLBridge("internvl_mlp", 128, 96)
    assert tmod._modules["0"].eps == 1e-6
    load_jax_params(tmod, params)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# the LLM at a 6:1 grouped-query attention
# ---------------------------------------------------------------------------

def test_llm_gqa_prefill_then_decode_matches_jax():
    """12 heads over 2 KV heads (the 20B model's 48/8), rope theta 1e6: a
    left-padded prefill into a KV cache of 2 KV heads, then 3 decode
    steps; hidden states and logits."""
    jcfg = _tiny(jconfig).llm
    cfg = _tiny(pconfig).llm
    assert cfg.num_heads // cfg.num_kv_heads == 6
    rng = np.random.default_rng(7)
    B, L = 2, 9
    x = _np(rng, B, L, cfg.hidden_size, scale=0.5)
    pos = np.tile(np.arange(L, dtype=np.int32)[None], (B, 1))
    mask = np.ones((B, L), np.int32)
    mask[1, :3] = 0
    dmask = np.concatenate([mask, np.ones((B, MAX_LEN - L), np.int32)], 1)
    jllm = JaxLlama(jcfg, jnp.float32)

    def init_method(m, e, ps):
        m.embed(jnp.zeros((1, 1), jnp.int32))
        return m(e, ps)

    params = _init(jllm, 8, x, pos, method=init_method)
    jc = JaxCache.create(jcfg, B, MAX_LEN, dtype=jnp.float32)
    tc = KVCache.create(cfg, B, MAX_LEN, torch.float32, "cpu")
    assert tuple(tc.k.shape) == (2, B, MAX_LEN, 2, 8)
    tllm = LlamaModel(cfg)
    load_jax_params(tllm, params)
    apply = o0_jit(lambda p, e, ps, c, m: jllm.apply(
        {"params": p}, e, ps, attn_mask=m, cache=c))
    jh, jl, jc = apply(params, x, pos, jc, mask)
    with torch.no_grad():
        th, tl = tllm(torch.from_numpy(x), torch.from_numpy(pos).long(),
                      attn_mask=torch.from_numpy(mask), cache=tc)
    pairs = [(jh, th), (jl, tl)]
    for step in range(3):
        e = _np(rng, B, 1, cfg.hidden_size, scale=0.5)
        p1 = np.full((B, 1), L + step, np.int32)
        jh, jl, jc = apply(params, e, p1, jc, dmask)
        with torch.no_grad():
            th, tl = tllm(torch.from_numpy(e), torch.from_numpy(p1).long(),
                          attn_mask=torch.from_numpy(dmask), cache=tc)
        pairs += [(jh, th), (jl, tl)]
    assert tc.index == int(jc.index) == L + 3
    _close(tc.k, jc.k)
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"output {i}", **TOL)


# ---------------------------------------------------------------------------
# DCNv3, InternImage, Grounding-DINO on InternImage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,C", [(2, 16), (4, 32)])
def test_dcnv3_core_matches_jax(G, C):
    """Offsets of a few pixels (many taps between pixels, some past the
    padded border), a softmaxed mask."""
    rng = np.random.default_rng(G)
    N, H, W, P = 2, 9, 11, 9
    x = _np(rng, N, H, W, C)
    off = _np(rng, N, H, W, G * P * 2, scale=2.0)
    logits = _np(rng, N, H, W, G, P)
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = mask.reshape(N, H, W, G * P).astype(np.float32)
    want = jax_dcnv3_core(jnp.asarray(x), jnp.asarray(off),
                          jnp.asarray(mask), group=G)
    got = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(mask), group=G)
    _close(got, want)


def test_dcnv3_module_matches_jax():
    rng = np.random.default_rng(9)
    x = _np(rng, 2, 8, 10, 32)
    jmod = JaxDCNv3(32, group=4, dtype=jnp.float32)
    params = _init(jmod, 10, x)
    want = o0_jit(lambda p, a: jmod.apply({"params": p}, a))(params, x)
    tmod = DCNv3(32, group=4)
    load_jax_params(tmod, params)
    assert tuple(tmod.dw_conv.weight.shape) == (32, 1, 3, 3)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


def test_intern_image_matches_jax():
    """The test InternImage (channels 16, depths (1, 1, 1, 1), groups
    (2, 2, 4, 4)): the four normed stage maps."""
    jcfg = jax_ii_tiny(depths=(1, 1, 1, 1), groups=(2, 2, 4, 4))
    x = _np(np.random.default_rng(11), 1, 64, 96, 3)
    jmod = JaxInternImage(jcfg, jnp.float32)
    params = _init(jmod, 12, x)
    want = o0_jit(lambda p, a: jmod.apply({"params": p}, a))(params, x)
    tmod = InternImage(intern_image_tiny_config(depths=(1, 1, 1, 1),
                                                groups=(2, 2, 4, 4)))
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (1, 16, 24, 16), (1, 8, 12, 32), (1, 4, 6, 64), (1, 2, 3, 128)]
    for g, w in zip(got, want):
        _close(g, w)


def test_gdino_on_intern_image_matches_jax():
    """Grounding-DINO on `intern_image_tiny` at a 128 px image whose
    bottom rows are padding."""
    jcfg = _tiny(jconfig).gdino
    rng = np.random.default_rng(13)
    pix = _np(rng, 1, DET, DET, 3, scale=0.5)
    pmask = np.ones((1, DET, DET), bool)
    pmask[:, 96:] = False
    tq = _np(rng, 1, 2, 4, jcfg.text_dim)
    tq_mask = np.asarray([[True, True]])
    jmod = JaxGDino(jcfg, jnp.float32)
    params = _init(jmod, 14, pix, tq, tq_mask, pmask)
    want = o0_jit(lambda p, a, b, c, d: jmod.apply(
        {"params": p}, a, b, c, pixel_mask=d))(params, pix, tq, tq_mask,
                                               pmask)
    tmod = GroundingDino(_tiny(pconfig).gdino)
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
# anyres tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(800, 1088), (1088, 800), (300, 900),
                                (500, 500), (448, 1344)])
def test_dynamic_preprocess_matches_jax(hw):
    img = np.random.default_rng(hw[0] + hw[1]).integers(
        0, 256, hw + (3,), dtype=np.uint8)
    want = jax_tiles(img, image_size=448, max_num=6)
    got = dynamic_preprocess(img, image_size=448, max_num=6)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (448, 448, 3)
        np.testing.assert_array_equal(g, w)
    if hw == (800, 1088):
        assert len(got) == 7          # a 3x2 grid and the thumbnail


# ---------------------------------------------------------------------------
# the whole tiny 26B det path and greedy generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    jcfg = _tiny(jconfig)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    ids = _prompt(jtid, 1, 1)

    def init_method(m, input_ids, images, images_aug, tid):
        m.core(input_ids, images, tid, compute_logits=True)
        return m.infer_det(input_ids, images, images_aug, tid)

    params = _init(jmodel, 15, jnp.asarray(ids),
                   jnp.zeros((1, size, size, 3)),
                   jnp.zeros((1, DET, DET, 3)), jtid, method=init_method)
    tmodel = build_model(_tiny(pconfig), device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)
    jfwd = o0_jit(lambda p, a, b, c: jmodel.apply(
        {"params": p}, a, b, c, jtid, method=JaxModel.infer_det))
    return jcfg, params, jfwd, tmodel


def _prompt(tid, tiles, groups):
    """ids as the dataset builds them: 4 <im_patch> a tile (the 16
    patches of a 56 px tile after pixel shuffle), then [DET][EMB x4]
    groups."""
    ids = [1, 10, 11] + [tid.imp] * (4 * tiles) + [12]
    for g in range(groups):
        ids += [tid.det] + [tid.emb + i for i in range(4)] + [13 + g]
    return np.asarray([ids + [2]], np.int32)


@pytest.mark.parametrize("tiles,groups", [(TILES, 2), (1, 1)],
                         ids=["tile_stack_7", "one_tile"])
def test_infer_det_26b_matches_jax(models, tiles, groups):
    jcfg, params, jfwd, tmodel = models
    tid = SpecialTokenIds.synthetic()
    ids = _prompt(tid, tiles, groups)
    rng = np.random.default_rng(16 + tiles)
    size = jcfg.vis_encoder.image_size
    shape = (1, tiles, size, size, 3) if tiles > 1 else (1, size, size, 3)
    images = _np(rng, *shape, scale=0.5)
    aug = _np(rng, 1, DET, DET, 3, scale=0.5)
    with torch.no_grad():
        feats, _ = tmodel.core.encode_images(torch.from_numpy(images))
    assert tuple(feats.shape) == (tiles, 4, 96)
    want = jfwd(params, jnp.asarray(ids), jnp.asarray(images),
                jnp.asarray(aug))
    got = tmodel.infer_det(torch.from_numpy(ids).long(),
                           torch.from_numpy(images), torch.from_numpy(aug),
                           tid)
    for key in ("logits", "enc_logits"):
        _close(got[key][..., :groups], want[key][..., :groups])
    np.testing.assert_array_equal(got["logits"].numpy()[..., groups:],
                                  np.asarray(want["logits"])[..., groups:])
    for key in ("pred_boxes", "pred_masks", "enc_boxes"):
        _close(got[key], want[key])


def test_generate_26b_matches_jax(models):
    """Greedy generate on the tiny 26B core over a 7-tile stack and a
    text-only row, left-padded: tokens identical, hidden states and
    log-probabilities within the tolerance."""
    jcfg, params, _, tmodel = models
    jtid, tid = JaxTid.synthetic(), SpecialTokenIds.synthetic()
    rng = np.random.default_rng(20)
    size = jcfg.vis_encoder.image_size
    img_ids = [1] + [tid.imp] * (4 * TILES) + list(rng.integers(4, 90, 5))
    txt_ids = [1] + list(rng.integers(4, 90, 8))
    L = len(img_ids)
    ids = np.zeros((2, L), np.int32)
    mask = np.zeros((2, L), bool)
    for b, r in enumerate((img_ids, txt_ids)):
        ids[b, L - len(r):] = r
        mask[b, L - len(r):] = True
    imgs = _np(rng, 2, TILES, size, size, 3, scale=0.5)
    imgs[1] = 0.0
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    jgen = jax_generate_fn(jcore, jtid, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)
    want = jgen(params["core"], jnp.asarray(ids), jnp.asarray(imgs),
                attn_mask=jnp.asarray(mask))
    tgen = build_generate_fn(tmodel.core, tid, max_new_tokens=MAX_NEW,
                             max_len=MAX_LEN)
    got = tgen(torch.from_numpy(ids).long(), torch.from_numpy(imgs),
               attn_mask=torch.from_numpy(mask))
    assert got["num_generated"] == int(want["num_generated"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    assert tuple(got["cache"].k.shape[-2:]) == (2, 8)
    for key in ("out_hidden", "out_logprobs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_full_width_26b_tree_maps_onto_the_port():
    """The JAX `vllm_26b_config` det model's param tree at full width
    (its shapes from `jax.eval_shape`, each leaf a zero-stride numpy
    array, so nothing is allocated) maps leaf for leaf onto the port's
    `vllm_26b_det_config()` model laid out on the meta device, each at
    its parameter's shape, through `load_jax_params`' name and layout map:
    the scanned InternViT and InternLM2 layers, `stage{s}_block{b}` of
    InternImage-H, its depthwise convs, `ls1` / `ls2`, the bridge's
    "0" / "1" / "3"."""
    from visionllm_tpu_torch.models.composite import VisionLLMWithTools
    from visionllm_tpu_torch.utils import convert
    jcfg = jconfig.vllm_26b_config(use_unipose=False, use_sd=False,
                                   use_ip2p=False, use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg)

    def init_method(m, input_ids, images, images_aug, tid):
        m.core(input_ids, images, tid, compute_logits=True)
        return m.infer_det(input_ids, images, images_aug, tid)

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 300), jnp.int32),
        jnp.zeros((1, 448, 448, 3)), jnp.zeros((1, 256, 256, 3)), jtid,
        method=init_method))["params"]
    tree = jax.tree.map(
        lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape), shapes)
    with torch.device("meta"):
        tmodel = VisionLLMWithTools(pconfig.vllm_26b_det_config())
    arrays = {}
    convert._emit(tmodel, "", tree, arrays)
    own = dict(tmodel.named_parameters())
    assert set(arrays) == set(own)
    bad = {k: (arrays[k].shape, tuple(own[k].shape)) for k in own
           if tuple(arrays[k].shape) != tuple(own[k].shape)}
    assert not bad
    assert tuple(own["gdino.backbone.stage2_block31.dcn.dw_conv.weight"]
                 .shape) == (1280, 1, 3, 3)


def _flax_shapes(module, *args, method=None):
    """A flax param tree at full width as zero-stride numpy arrays (its
    shapes from `jax.eval_shape`: nothing is allocated)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))["params"]
    return jax.tree.map(
        lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape), shapes)


def _maps_onto(tmodel, tree):
    """`load_jax_params`' name and layout map from `tree` onto `tmodel`
    (on meta): the same names, each leaf at its parameter's shape."""
    from visionllm_tpu_torch.utils import convert
    arrays = {}
    convert._emit(tmodel, "", tree, arrays)
    own = dict(tmodel.named_parameters())
    assert set(arrays) == set(own)
    bad = {k: (arrays[k].shape, tuple(own[k].shape)) for k in own
           if tuple(arrays[k].shape) != tuple(own[k].shape)}
    assert not bad
    return own


def test_full_width_whole_26b_tree_maps_onto_the_port():
    """The JAX `vllm_26b_config()` model's whole param tree at full width
    (every tool: Grounding-DINO and UniPose on InternImage-H, the SD-1.5
    and InstructPix2Pix heads with their 6144 -> 768 mappers, the region
    encoder 3200 -> 6144) maps leaf for leaf onto the port's
    `vllm_26b_config()` model on the meta device; and the host-only
    count `model_size` (what `build_model` will hold in bf16, the fp32
    parts at 4 bytes) counts the tree's values."""
    from visionllm_tpu_torch.models.composite import (VisionLLMWithTools,
                                                      model_size)
    jcfg = jconfig.vllm_26b_config()
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg)
    rng = jax.random.PRNGKey(0)
    ids = [1] + [jtid.imp] * 256 + [jtid.reg, 5, jtid.det] + [
        jtid.emb + i for i in range(4)] + [6]
    for k in range(2):
        ids += [jtid.pose] + [jtid.emb + i for i in range(4)] + [7 + k]

    def init_method(m, input_ids, images, images_aug, regions, embs, src):
        m.core(input_ids, images, jtid, compute_logits=True,
               regions=regions)
        m.infer_det(input_ids, images, images_aug, jtid)
        m.infer_pose(input_ids, images, images_aug, jtid, 1)
        m.sd(embs, src, rng)
        return m.ip2p(embs, src, src, rng)

    tree = _flax_shapes(
        jmodel, jnp.zeros((1, len(ids)), jnp.int32),
        jnp.zeros((1, 448, 448, 3)), jnp.zeros((1, 256, 256, 3)),
        jnp.ones((1, 1, 448, 448)), jnp.zeros((1, 64, 6144)),
        jnp.zeros((1, 512, 512, 3)), method=init_method)
    with torch.device("meta"):
        tmodel = VisionLLMWithTools(pconfig.vllm_26b_config())
    own = _maps_onto(tmodel, tree)
    assert tuple(own["unipose.input_proj_0.weight"].shape) == (256, 640, 1, 1)
    assert tuple(own["unipose.backbone.stage2_block31.dcn.dw_conv.weight"]
                 .shape) == (1280, 1, 3, 3)
    assert tuple(own["sd.mapper.emb_proj_0.weight"].shape) == (768, 6144)
    assert tuple(own["core.region_encoder.up_dim.weight"].shape)[0] == 6144
    n = sum(x.size for x in jax.tree.leaves(tree))
    size = model_size(pconfig.vllm_26b_config())
    assert size["params"] == n
    assert 30.0e9 < n < 30.1e9
    assert 60.1e9 < size["bytes"] < 60.3e9


def test_full_width_unipose_on_swin_large_tree_maps_onto_the_port():
    """UniPose on full-depth Swin-L (embed 192, depths (2, 2, 18, 2),
    window 12): its JAX param tree at full width maps onto the port's
    UniPose on the meta device. Only the tree is checked here: JAX's
    `UniPoseConfig` has no backbone override, so no tiny Swin-L UniPose
    can be run against it on the CPU (Grounding-DINO's Swin-L runs in
    `tests/test_torch_flagship26b.py`)."""
    from visionllm_tpu.models.unipose.model import UniPose as JaxUniPose
    from visionllm_tpu_torch.models.unipose.model import UniPose
    jcfg = dataclasses.replace(jconfig.UniPoseConfig(), backbone="swin_large")
    B, D = 1, 256               # 1360 encoder tokens for 900 queries
    tree = _flax_shapes(
        JaxUniPose(jcfg), jnp.zeros((B, D, D, 3)),
        jnp.zeros((B, 1, 4, 4096)), jnp.ones((B, 1), bool),
        jnp.zeros((B, 17, 4, 4096)), jnp.ones((B, 17), bool))
    with torch.device("meta"):
        tmodel = UniPose(dataclasses.replace(pconfig.UniPoseConfig(),
                                             backbone="swin_large"))
    own = _maps_onto(tmodel, tree)
    assert tmodel.backbone.cfg.window_size == 12
    assert tuple(own["backbone.stage2_block17.relative_position_bias_table"]
                 .shape) == (23 * 23, 24)
    assert tuple(own["input_proj_0.weight"].shape) == (256, 384, 1, 1)


# ---------------------------------------------------------------------------
# a reference fault, pinned
# ---------------------------------------------------------------------------

def test_jax_predictor_counts_1024_placeholders_for_256_feature_rows():
    """The JAX `Predictor` (`infer.py:102`) puts (448 // 14) ** 2 = 1024
    <im_patch> tokens in a 26B prompt, but pixel shuffle leaves 256
    feature rows a tile (`models/visionllm.py:176-180`), and the scatter
    clips its cumsum: placeholders 256-1023 all receive row 255. This
    pins the reference's behaviour; the port's det path builds 256 a
    tile, as the training dataset does."""
    from visionllm_tpu.infer import Predictor
    tok = MockTokenizer()
    cfg = dataclasses.replace(
        jconfig.vllm_26b_config(use_unipose=False, use_sd=False,
                                use_ip2p=False, use_region_encoder=False),
        vis_encoder=_tiny(jconfig, image_size=448).vis_encoder)
    pred = Predictor(cfg, None, tok)
    prep = pred._prepare(np.zeros((64, 64, 3), np.uint8), "<image>\nhi",
                         "ok")
    n_imp = int((np.asarray(prep["input_ids"]) == pred.tid.imp).sum())
    assert n_imp == 1024
    core = JaxCore(cfg, dtype=jnp.float32)
    img = jnp.zeros((1, 448, 448, 3), jnp.float32)
    feats = jax.eval_shape(lambda: core.init_with_output(
        jax.random.PRNGKey(0), img, method=JaxCore.encode_images)[0][0])
    assert feats.shape == (1, 256, cfg.llm.hidden_size)
    # the scatter on those counts: row k of 256 lands on placeholder k,
    # and row 255 on every placeholder past it
    rows = jnp.arange(256, dtype=jnp.float32)[None, :, None] * jnp.ones(
        (1, 1, 4))
    ids = jnp.asarray([[1] + [7] * 1024 + [2]])
    out = JaxCore.scatter_image_features(jnp.zeros((1, 1026, 4)), ids,
                                         rows, 7)
    got = np.asarray(out[0, 1:1025, 0])
    np.testing.assert_array_equal(got[:256], np.arange(256))
    np.testing.assert_array_equal(got[256:], np.full(768, 255.0))
