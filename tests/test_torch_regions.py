"""The port's region prompts (`models/region_encoder.py`, the `regions`
of `VisionLLM.build_prompt_embeds`, `infer_det`, both generate closures,
the slot engine and `eval/region_eval.py`) against the JAX package on the
CPU, and the image-token count of `Predictor` and `ChatService`.

Parity in fp32 at JAX's tiny dims (the region encoder hidden 16, ViT
width 32, LLM width 64), the flax params drawn from numpy
(`random_flax_params`) or by the JAX init and loaded with
`load_jax_params`. Tolerances: the adjoint matrices, masks, prompt ids
and tokens identical; the closed-form pooling 1e-5 abs + 1e-4 rel of
the brute-force grid_sample mean; modules and embeddings 1e-4 abs and
rel; logprobs 2e-4.

One bf16 case holds the port's region encoder, as `build_model` casts it
(convs and `up_dim` bf16, `LayerNorm2d` fp32), against JAX's bf16 encoder
(`BF16_REL_TOL`, relative Frobenius), and its channel LayerNorm layer by
layer against flax's on the same bf16 input: the fp32 parameters agree
to a few elements in a thousand, bf16 parameters do not.

The image-token count (`VisionLLMConfig.image_token_len`): under pixel
shuffle (the tiny 26B config of `test_torch_internvl.py`) `Predictor`
and `ChatService` put as many <im_patch> ids in a prompt as the encoder
yields feature rows; the 7B count stays 576.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests.test_torch_internvl import _tiny as tiny_26b
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.eval import region_eval as jre
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.region_encoder import LayerNorm2d as JaxLN2d
from visionllm_tpu.models.region_encoder import RegionEncoder as JaxRegEnc
from visionllm_tpu.models.region_encoder import (
    _bilinear_adjoint_matrix as jax_adjoint)
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch import slots
from visionllm_tpu_torch.data import mm_utils as tmm
from visionllm_tpu_torch.eval import region_eval as tre
from visionllm_tpu_torch.generation import (build_generate_fn,
                                            build_speculative_generate_fn)
from visionllm_tpu_torch.infer import Predictor
from visionllm_tpu_torch.models.composite import build_core, build_model
from visionllm_tpu_torch.models.region_encoder import (
    LayerNorm2d, RegionEncoder, _bilinear_adjoint_matrix, pooling_weights)
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.serve import ChatService
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import RoundTripTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)
LP_TOL = dict(atol=2e-4, rtol=2e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-4)
# bf16 region encoder, port vs JAX (relative Frobenius): a few bf16
# ulps (2^-8 = 3.9e-3) of the output
BF16_REL_TOL = 1e-2
TID, JTID = SpecialTokenIds.synthetic(), JaxTid.synthetic()
REG_CFG = dict(hidden_dim=16, embed_dim=32, out_dim=64, patch_size=14,
               num_sample_points=32)
MAX_NEW, MAX_LEN = 8, 160


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the pooling and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(336, 24), (448, 32), (56, 4), (45, 7)],
                         ids=lambda s: f"{s[0]}to{s[1]}")
def test_bilinear_adjoint_matrix_matches_jax(sizes):
    np.testing.assert_array_equal(_bilinear_adjoint_matrix(*sizes),
                                  jax_adjoint(*sizes))


def _grid_sample_mean(feat, mask):
    """The mean over every in-mask pixel of bilinear grid_sample reads
    (align_corners=False, zero padding): the expectation of the
    reference's random-point estimator."""
    ys, xs = np.nonzero(mask)
    H, W = mask.shape
    coords = np.stack([xs / W, ys / H], axis=-1)
    grid = torch.from_numpy(coords).float()[None, :, None, :] * 2 - 1
    s = F.grid_sample(torch.from_numpy(feat), grid, align_corners=False)
    return s[0, :, :, 0].mean(dim=1).numpy()


MASKS = {"interior": (slice(10, 30), slice(8, 40)),
         "border": (slice(0, 21), slice(37, 56))}


@pytest.mark.parametrize("where", sorted(MASKS))
def test_pooling_is_the_grid_sample_mean(where):
    """The closed form divides by the pixel count: at the border the
    weight outside the map is lost from the numerator only. A pooling
    normalised by its in-map weight misses the border case."""
    rng = np.random.default_rng(0)
    H, hf, C = 56, 4, 3
    feat = _np(rng, 1, C, hf, hf)
    mask = np.zeros((H, H), np.float32)
    mask[MASKS[where]] = 1
    want = _grid_sample_mean(feat, mask)
    wmap = pooling_weights(torch.from_numpy(mask)[None], hf, hf)[0].numpy()
    np.testing.assert_allclose(np.einsum("chw,hw->c", feat[0], wmap), want,
                               **POOL_TOL)
    normalised = np.einsum("chw,hw->c", feat[0], wmap / wmap.sum())
    assert (where == "interior") == np.allclose(normalised, want,
                                                **POOL_TOL)


def _jax_encoder(size, n, dtype=jnp.float32, seed=0):
    """JAX's tiny RegionEncoder, its params and inputs at `size` px: n
    regions, the second empty."""
    cfg = jconfig.RegionEncoderConfig(**REG_CFG)
    rng = np.random.default_rng(seed)
    images = _np(rng, n, size, size, 3)
    masks = np.zeros((n, size, size), np.float32)
    masks[0, 5:25, 3:size - 9] = 1
    masks[2:, size // 2:, : size // 3] = 1
    P = (size // 14) ** 2
    feats = [_np(rng, n, P, cfg.embed_dim) for _ in range(3)]
    jmod = JaxRegEnc(cfg, dtype)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), images, masks, feats))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, seed + 1))
    return jmod, params, images, masks, feats


@pytest.mark.parametrize("size", [56, 84])
def test_region_encoder_matches_jax(size):
    jmod, params, images, masks, feats = _jax_encoder(size, 3)
    want = o0_jit(lambda p, a, b, c: jmod.apply({"params": p}, a, b, c))(
        params, images, masks, feats)
    enc = RegionEncoder(pconfig.RegionEncoderConfig(**REG_CFG))
    load_jax_params(enc, params)
    with torch.no_grad():
        got = enc(torch.from_numpy(images), torch.from_numpy(masks),
                  [torch.from_numpy(f) for f in feats])
    assert tuple(got.shape) == (3, REG_CFG["out_dim"])
    _close(got, want)


def test_region_encoder_refuses_a_side_off_the_patch_grid():
    enc = RegionEncoder(pconfig.RegionEncoderConfig(**REG_CFG))
    with pytest.raises(ValueError, match="multiple of the patch"):
        enc(torch.zeros(1, 50, 56, 3), torch.zeros(1, 50, 56),
            [torch.zeros(1, 12, 32)] * 3)


def _bf16_encoder(params):
    """The port's tiny encoder as `build_model` casts it: bf16, its
    `fp32_modules` (the LayerNorm2ds) back to fp32."""
    cfg = pconfig.tiny_test_config(use_region_encoder=True)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    enc = model.core.region_encoder
    load_jax_params(enc, params)
    return model, enc


def test_bf16_region_encoder_matches_jax_bf16():
    jmod, params, images, masks, feats = _jax_encoder(56, 3, jnp.bfloat16)
    bf = [f.astype(jnp.bfloat16) for f in feats]
    want = o0_jit(lambda p, a, b, c: jmod.apply({"params": p}, a, b, c))(
        params, images, masks, bf)
    model, enc = _bf16_encoder(params)
    norms = [m for m in model.modules() if isinstance(m, LayerNorm2d)]
    assert len(norms) == 2
    assert all(p.dtype == torch.float32 for m in norms
               for p in m.parameters())
    assert enc.stem_conv0.weight.dtype == torch.bfloat16
    assert enc.up_dim.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = enc(torch.from_numpy(images), torch.from_numpy(masks),
                  [torch.from_numpy(np.asarray(f, np.float32)).bfloat16()
                   for f in bf])
    assert got.dtype == torch.bfloat16
    err = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert err < BF16_REL_TOL, err


def test_bf16_layernorm2d_needs_fp32_parameters():
    """Layer by layer: flax's LayerNorm2d on a bf16 map against the port's
    with its fp32 parameters and with them rounded to bf16 (the cast
    `build_model` applies to everything not in `fp32_modules`)."""
    rng = np.random.default_rng(3)
    C = 64
    x = jnp.asarray(_np(rng, 2, 9, 9, C, scale=3.0) + 1.0, jnp.bfloat16)
    params = {"weight": 1.0 + 0.3 * _np(rng, C),
              "bias": 0.3 * _np(rng, C)}
    want = np.asarray(JaxLN2d().apply({"params": params}, x), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().permute(
        0, 3, 1, 2)

    def port(dtype):
        ln = LayerNorm2d(C)
        load_jax_params(ln, params)
        ln.to(dtype)
        with torch.no_grad():
            return ln(xt).permute(0, 2, 3, 1).float().numpy()

    off32 = np.mean(port(torch.float32) != want)
    off16 = np.mean(port(torch.bfloat16) != want)
    assert off32 < 0.01, off32
    assert off16 > 10 * max(off32, 1e-3), (off16, off32)


# ---------------------------------------------------------------------------
# the core: build_prompt_embeds with regions
# ---------------------------------------------------------------------------

def _jax_cfg(**kw):
    base = dict(use_gdino=False, use_unipose=False, use_sd=False,
                use_ip2p=False, use_region_encoder=True)
    base.update(kw)
    return jconfig.tiny_test_config(**base)


def _port_cfg(**kw):
    base = dict(use_gdino=False, gdino=None, use_region_encoder=True)
    base.update(kw)
    return pconfig.tiny_test_config(**base)


SIZE = 56
IMG_LEN = 16


@pytest.fixture(scope="module")
def core_pair():
    torch.set_num_threads(1)
    jcore = JaxCore(_jax_cfg(), dtype=jnp.float32)
    ids = jnp.asarray([[1] + [JTID.imp] * IMG_LEN + [JTID.reg, 5]])
    shapes = jax.eval_shape(lambda: jcore.init(
        jax.random.PRNGKey(0), ids, jnp.zeros((1, SIZE, SIZE, 3)), JTID,
        regions=jnp.ones((1, 1, SIZE, SIZE))))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 7))
    core = build_core(_port_cfg(), device="cpu", dtype=torch.float32)
    load_jax_params(core, params)
    return jcore, params, core


def _region_masks(rng, B, R, empty=()):
    masks = np.zeros((B, R, SIZE, SIZE), np.float32)
    for b in range(B):
        for r in range(R):
            if (b, r) in empty:
                continue
            y0, x0 = rng.integers(0, SIZE - 12, 2)
            h, w = rng.integers(4, 12, 2)
            masks[b, r, y0:y0 + h, x0:x0 + w] = 1
    masks[0, 0, :, SIZE - 5:] = 1          # a region at the border
    return masks


def _region_prompt(tiles, n_regions, extra):
    ids = [1, 9] + [TID.imp] * (IMG_LEN * tiles) + [11]
    for i in range(n_regions):
        ids += [TID.reg, 12 + i]
    return ids + list(extra)


CASES = {
    # (image rank, B, T, R, empty slots)
    "flat_images": (4, 2, 1, 3, {(1, 2)}),
    "stack_T1": (5, 2, 1, 3, {(0, 1)}),
    "stack_T2": (5, 2, 2, 2, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_prompt_embeds_with_regions_matches_jax(core_pair, case):
    jcore, params, core = core_pair
    ndim, B, T, R, empty = CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (B, T, SIZE, SIZE, 3) if ndim == 5 else (B, SIZE, SIZE, 3)
    images = _np(rng, *shape, scale=0.5)
    masks = _region_masks(rng, B, R, empty)
    rows = [_region_prompt(T, R - sum(1 for e in empty if e[0] == b),
                           [20 + b, 21]) for b in range(B)]
    L = max(map(len, rows))
    ids = np.asarray([[0] * (L - len(r)) + r for r in rows], np.int32)
    want = o0_jit(lambda p, a, b, c: jcore.apply(
        {"params": p}, a, b, JTID, regions=c,
        method=JaxCore.build_prompt_embeds)[0])(params, ids, images, masks)
    got, _ = core.build_prompt_embeds(
        torch.from_numpy(ids).long(), torch.from_numpy(images), TID,
        regions=torch.from_numpy(masks))
    _close(got, want)
    # the <region> rows carry region features, not token embeddings
    plain, _ = core.build_prompt_embeds(torch.from_numpy(ids).long(),
                                        torch.from_numpy(images), TID)
    sel = torch.from_numpy(ids == TID.reg)
    assert not torch.allclose(got[sel], plain[sel])
    assert torch.equal(got[~sel], plain[~sel])


def test_region_features_path_matches_jax(core_pair):
    jcore, params, core = core_pair
    rng = np.random.default_rng(4)
    ids = np.asarray([_region_prompt(1, 2, [30])], np.int32)
    images = _np(rng, 1, SIZE, SIZE, 3, scale=0.5)
    rf = _np(rng, 2, 64)
    want = o0_jit(lambda p, a, b, c: jcore.apply(
        {"params": p}, a, b, JTID, region_features=c,
        method=JaxCore.build_prompt_embeds)[0])(params, ids, images, rf)
    got, _ = core.build_prompt_embeds(
        torch.from_numpy(ids).long(), torch.from_numpy(images), TID,
        region_features=torch.from_numpy(rf))
    _close(got, want)


def test_regions_need_the_encoder_and_the_images(core_pair):
    _, _, core = core_pair
    ids = torch.tensor([_region_prompt(1, 1, [30])])
    masks = torch.ones(1, 1, SIZE, SIZE)
    with pytest.raises(ValueError, match="region prompts need"):
        core.build_prompt_embeds(ids, None, TID, regions=masks)
    plain = build_core(_port_cfg(use_region_encoder=False), device="cpu",
                       dtype=torch.float32)
    assert plain.region_encoder is None
    with pytest.raises(ValueError, match="region prompts need"):
        plain.build_prompt_embeds(ids, torch.zeros(1, SIZE, SIZE, 3), TID,
                                  regions=masks)


# ---------------------------------------------------------------------------
# infer_det with regions
# ---------------------------------------------------------------------------

DET = 128


def test_infer_det_with_regions_matches_jax():
    torch.set_num_threads(1)
    jcfg = _jax_cfg(use_gdino=True)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    rng = np.random.default_rng(11)
    ids = [1] + [TID.imp] * IMG_LEN + [TID.reg, 9]
    for g in range(2):
        ids += [TID.det] + [TID.emb + i for i in range(4)] + [13 + g]
    ids = np.asarray([ids + [2]], np.int32)
    images = _np(rng, 1, SIZE, SIZE, 3, scale=0.5)
    aug = _np(rng, 1, DET, DET, 3, scale=0.5)
    masks = _region_masks(rng, 1, 2, {(0, 1)})

    def init_method(m, a, b, c, tid, regions):
        m.core(a, b, tid, compute_logits=True, regions=regions)
        return m.infer_det(a, b, c, tid, regions=regions)

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), ids, images, aug, JTID, masks,
        method=init_method))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 12))
    want = o0_jit(lambda p, a, b, c, d: jmodel.apply(
        {"params": p}, a, b, c, JTID, regions=d,
        method=JaxModel.infer_det))(params, ids, images, aug, masks)
    want_h = o0_jit(lambda p, a, b, d: jmodel.apply(
        {"params": p}, a, b, JTID, compute_logits=False, regions=d,
        method=lambda m, *x, **k: m.core(*x, **k)["hidden"]))(
            params, ids, images, masks)
    model = build_model(_port_cfg(use_gdino=True,
                                  gdino=pconfig.tiny_test_config().gdino,
                                  use_unipose=False, unipose=None),
                        device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    t = [torch.from_numpy(x) for x in (ids, images, aug, masks)]
    t[0] = t[0].long()
    got = model.infer_det(t[0], t[1], t[2], TID, regions=t[3])
    with torch.no_grad():
        hid = model.core(t[0], t[1], TID, compute_logits=False,
                         regions=t[3])["hidden"]
        tq, _ = model.core.extract_text_query(hid, t[0], TID)
    _close(hid, want_h)
    assert tq.shape[1] == 10
    for key in ("logits", "enc_logits"):
        _close(got[key][..., :2], want[key][..., :2])
    for key in ("pred_boxes", "enc_boxes"):
        _close(got[key], want[key])


# ---------------------------------------------------------------------------
# generation and the slot engine with regions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_setup(core_pair):
    """A left-padded B2 batch of [B, 1, S, S, 3] images (the service's
    dispatch layout) with region masks, R = 3, one slot empty."""
    rng = np.random.default_rng(21)
    masks = _region_masks(rng, 2, 3, {(1, 1)})
    rows = [_region_prompt(1, 3, [40, 41, 42]),
            _region_prompt(1, 2, [43])]
    L = max(map(len, rows))
    ids = np.zeros((2, L), np.int64)
    mask = np.zeros((2, L), bool)
    for b, r in enumerate(rows):
        ids[b, L - len(r):] = r
        mask[b, L - len(r):] = True
    images = _np(rng, 2, 1, SIZE, SIZE, 3, scale=0.5)
    return ids, mask, images, masks


def _port_generate(core, ids, mask, images, masks, b=None):
    sl = slice(None) if b is None else slice(b, b + 1)
    gen = build_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                            max_len=MAX_LEN)
    return gen(torch.from_numpy(ids[sl]), torch.from_numpy(images[sl]),
               attn_mask=torch.from_numpy(mask[sl]),
               regions=torch.from_numpy(masks[sl]))


def test_generate_with_regions_matches_jax(core_pair, gen_setup):
    jcore, params, core = core_pair
    ids, mask, images, masks = gen_setup
    jgen = jax_generate_fn(jcore, JTID, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)
    want = jgen(params, jnp.asarray(ids, jnp.int32), jnp.asarray(images),
                attn_mask=jnp.asarray(mask), regions=jnp.asarray(masks))
    got = _port_generate(core, ids, mask, images, masks)
    assert got["num_generated"] == int(want["num_generated"])
    np.testing.assert_array_equal(got["out_tokens"].numpy(),
                                  np.asarray(want["out_tokens"]))
    np.testing.assert_allclose(got["out_logprobs"].numpy(),
                               np.asarray(want["out_logprobs"]), **LP_TOL)
    # without the regions the answer is conditioned otherwise
    plain = build_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                              max_len=MAX_LEN)(
        torch.from_numpy(ids), torch.from_numpy(images),
        attn_mask=torch.from_numpy(mask))
    assert not torch.allclose(plain["out_logprobs"][:, 0],
                              got["out_logprobs"][:, 0])


@pytest.mark.parametrize("k", [1, 3])
def test_speculative_with_regions_equals_greedy(core_pair, gen_setup, k):
    _, _, core = core_pair
    ids, mask, images, masks = gen_setup
    for b in range(2):
        want = _port_generate(core, ids, mask, images, masks, b)
        spec = build_speculative_generate_fn(
            core, TID, max_new_tokens=MAX_NEW, max_len=MAX_LEN, k_draft=k)
        got = spec(torch.from_numpy(ids[b:b + 1]),
                   torch.from_numpy(images[b:b + 1]),
                   attn_mask=torch.from_numpy(mask[b:b + 1]),
                   regions=torch.from_numpy(masks[b:b + 1]))
        n = got["num_generated"]
        assert n == want["num_generated"]
        assert got["out_tokens"][0, :n].tolist() == \
            want["out_tokens"][0, :n].tolist()
        np.testing.assert_allclose(got["out_logprobs"][0, :n].numpy(),
                                   want["out_logprobs"][0, :n].numpy(),
                                   **LP_TOL)


CHUNK = 16


@pytest.mark.parametrize("admission", ["b1", "chunked"])
def test_slot_admission_with_regions_equals_plain(core_pair, gen_setup,
                                                  admission):
    """Both rows admitted into a 2-slot engine, the second while the
    first decodes: each row's tokens equal its plain generate run."""
    _, _, core = core_pair
    ids, mask, images, masks = gen_setup
    Lp = -(-ids.shape[1] // CHUNK) * CHUNK
    pad = Lp - ids.shape[1]
    ids = np.pad(ids, ((0, 0), (pad, 0)))
    mask = np.pad(mask, ((0, 0), (pad, 0)))
    init, prefill, insert, step = slots.build_slot_fns(
        core, TID, n_slots=2, max_len=MAX_LEN)
    row_cache, embed, run, finish = slots.build_chunked_prefill_fns(
        core, TID, chunk=CHUNK, max_len=MAX_LEN)
    state, valid = init()
    streams = {}
    for b in range(2):
        t = [torch.from_numpy(x[b:b + 1]) for x in (ids, images, mask,
                                                   masks)]
        if admission == "b1":
            pre = prefill(t[0], t[1], t[2], regions=t[3])
        else:
            emb = embed(t[0], t[1], regions=t[3])
            cache = row_cache()
            vrow = torch.ones(MAX_LEN, dtype=torch.bool)
            vrow[:Lp] = t[2][0]
            for c in range(Lp // CHUNK):
                cache, last = run(emb[:, c * CHUNK:(c + 1) * CHUNK], cache,
                                  vrow)
            first, emb1, lp = finish(last)
            pre = {"first": first[0], "embed": emb1, "cache": cache,
                   "valid": vrow}
        state, valid = insert(state, b, pre["first"], pre["embed"],
                              pre["cache"], pre["valid"], valid)
        streams[b] = [int(pre["first"])]
        if b == 0:
            out = step(state, valid)
            streams[0].append(int(out["token"][0]))
    while min(map(len, streams.values())) < MAX_NEW:
        out = step(state, valid)
        for b in range(2):
            streams[b].append(int(out["token"][b]))
    for b in range(2):
        want = _port_generate(core, ids, mask, images, masks, b)
        n = want["num_generated"]
        assert streams[b][:n] == want["out_tokens"][0, :n].tolist()


# ---------------------------------------------------------------------------
# the region helpers (data/mm_utils.py) and eval/region_eval.py
# ---------------------------------------------------------------------------

def test_region_strings_and_box_masks_match_jax():
    for n in (1, 2, 3):
        for named in (True, False):
            assert tmm.region_str(n, named) == jre.region_str(n, named)
    for q in ("REFG_QUESTION", "COCO_RECOG_QUESTION", "LVIS_RECOG_QUESTION",
              "OSPREY_CLS_QUESTION"):
        assert getattr(tre, q) == getattr(jre, q)
    boxes = np.asarray([[3.2, 1.7, 20.5, 9.0], [0, 0, 40, 30],
                        [10.9, 12.1, 11.2, 12.3]], np.float32)
    np.testing.assert_array_equal(tmm.boxes_to_masks(boxes, 30, 40),
                                  jre.boxes_to_masks(boxes, 30, 40))


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (48, 48)])
def test_clip_region_masks_match_jax(hw):
    rng = np.random.default_rng(hw[0])
    masks = (rng.random((3,) + hw) > 0.6).astype(np.float32)
    masks[0] = 0
    masks[0, 2:9, 5:30] = 1
    np.testing.assert_array_equal(tmm.clip_region_masks(masks, 56),
                                  jre._clip_region_masks(masks, 56))
    assert tmm.clip_region_masks(masks[:0], 56).shape == (0, 56, 56)


def test_region_prompt_ids_match_jax():
    tok = RoundTripTokenizer()
    q = "What is " + tmm.region_str(2) + "?"
    for conv in ("vicuna_v1", "v1"):
        np.testing.assert_array_equal(
            tre._prompt_ids(q, tok, 576, conv),
            jre._prompt_ids(q, tok, 336, conv))


def test_run_region_generate_matches_jax(core_pair):
    jcore, params, core = core_pair
    tok = RoundTripTokenizer()
    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)
    rows = []
    for i, q in enumerate((tre.OSPREY_CLS_QUESTION, tre.COCO_RECOG_QUESTION)):
        m = np.zeros((i + 1, 40, 56), np.float32)
        m[0, 5:20, 10:30] = 1
        if i:
            m[1, 25:, :12] = 1
        rows.append({"image": img, "masks": m, "id": i,
                     "question": q.replace("<regions>",
                                           tmm.region_str(i + 1))})
    jgen = jax_generate_fn(jcore, JTID, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)
    want = jre.run_region_generate(jgen, params, tok, rows, image_size=SIZE)
    gen = build_generate_fn(core, TID, max_new_tokens=MAX_NEW,
                            max_len=MAX_LEN)
    got = tre.run_region_generate(gen, core.cfg, tok, rows, device="cpu")
    assert got == want
    assert [r["id"] for r in got] == [0, 1]


# ---------------------------------------------------------------------------
# the converter at full width
# ---------------------------------------------------------------------------

def test_full_width_region_encoder_maps_on_meta():
    """The JAX `RegionEncoderConfig()` tree at 336 px (shapes from
    `jax.eval_shape`) maps leaf for leaf onto the region encoder of the
    port's `vllm_7b_config()` model laid out on the meta device: about
    4.5 M parameters, the stem convs HWIO -> OIHW."""
    from visionllm_tpu_torch.models.composite import VisionLLMWithTools
    from visionllm_tpu_torch.utils import convert
    jmod = JaxRegEnc(jconfig.RegionEncoderConfig())
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 336, 336, 3)),
        jnp.zeros((1, 336, 336)), [jnp.zeros((1, 576, 1024))] * 3))
    tree = jax.tree.map(
        lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape),
        shapes["params"])
    with torch.device("meta"):
        model = VisionLLMWithTools(pconfig.vllm_7b_config())
    enc = model.core.region_encoder
    arrays = {}
    convert._emit(enc, "", tree, arrays)
    own = dict(enc.named_parameters())
    assert set(arrays) == set(own)
    assert all(tuple(arrays[k].shape) == tuple(own[k].shape) for k in own)
    assert tuple(own["stem_conv0.weight"].shape) == (64, 4, 7, 7)
    assert 4.4e6 < sum(p.numel() for p in enc.parameters()) < 4.6e6


# ---------------------------------------------------------------------------
# the image-token count (ROADMAP C.1)
# ---------------------------------------------------------------------------

def _feature_rows(core, size):
    with torch.no_grad():
        feats, _ = core.encode_images(torch.zeros(1, size, size, 3))
    return feats.shape[1]


@pytest.fixture(scope="module")
def shuffle_model():
    cfg = tiny_26b(pconfig)
    return cfg, build_model(cfg, device="cpu", dtype=torch.float32)


def test_predictor_counts_the_shuffled_feature_rows(shuffle_model):
    cfg, model = shuffle_model
    assert cfg.use_pixelshuffle and cfg.image_token_len == 4
    pred = Predictor(cfg, model, RoundTripTokenizer(), device="cpu")
    prep = pred._prepare(np.zeros((40, 56, 3), np.uint8), "<image>\nhi",
                         "ok")
    n_imp = int((prep["input_ids"] == pred.tid.imp).sum())
    assert n_imp == _feature_rows(model.core, 56) == 4


def test_chat_service_counts_the_shuffled_feature_rows(shuffle_model):
    cfg, model = shuffle_model
    svc = ChatService(cfg, model.core, RoundTripTokenizer(), device="cpu",
                      max_new_tokens=2)
    try:
        ids, img, _ = svc._encode("hi", np.zeros((40, 56, 3), np.uint8))
        assert int((ids == svc.tid.imp).sum()) == _feature_rows(
            model.core, 56) == 4
        assert img.shape == (56, 56, 3)
    finally:
        svc.close()


def test_7b_image_token_count_stays_576():
    cfg = pconfig.vllm_7b_config()
    assert cfg.image_token_len == 576
    small = pconfig.tiny_test_config(
        use_gdino=False, gdino=None, vis_encoder=pconfig.VisionEncoderConfig(
            image_size=336, patch_size=14, hidden_size=32,
            intermediate_size=64, num_layers=1, num_heads=4))
    core = build_core(small, device="cpu", dtype=torch.float32)
    svc = ChatService(small, core, RoundTripTokenizer(), device="cpu",
                      max_new_tokens=2, max_prompt=640)
    try:
        ids, _, _ = svc._encode("hi", np.zeros((40, 56, 3), np.uint8))
        assert int((ids == svc.tid.imp).sum()) == 576 == _feature_rows(
            core, 336)
    finally:
        svc.close()


def test_chat_service_refuses_another_image_size(shuffle_model):
    cfg, model = shuffle_model
    with pytest.raises(ValueError, match="image_size 448"):
        ChatService(cfg, model.core, RoundTripTokenizer(), device="cpu",
                    image_size=448)
