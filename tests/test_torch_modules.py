"""Per-module parity of the port against the JAX package on the CPU.

Each case builds the flax module and its port at tiny dims, initialises
the flax params, loads them into the port through `load_jax_params`, feeds
both the same numpy inputs (made from a seed) and compares in fp32 with
tolerance 1e-4 abs + 1e-4 rel (same arithmetic, other summation order;
Grounding-DINO's ~20 layers stay inside it too).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _load(tmodule, params):
    from visionllm_tpu_torch.utils.convert import load_jax_params
    load_jax_params(tmodule, _np(params))
    return tmodule.eval()


def case_rmsnorm_rope(rng):
    from visionllm_tpu.models import common as jc
    from visionllm_tpu_torch.models import common as tc
    x = _rand(rng, 2, 5, 16)
    jm = jc.RMSNorm(eps=1e-5)
    p = jm.init(jax.random.PRNGKey(0), x)["params"]
    p = {"weight": np.asarray(p["weight"]) + _rand(rng, 16, scale=0.1)}
    tm = _load(tc.RMSNorm(16, 1e-5), p)
    pos = np.tile(np.arange(5, dtype=np.int32)[None] + 3, (2, 1))
    jcos, jsin = jc.rope_cos_sin(jnp.asarray(pos), 8)
    tcos, tsin = tc.rope_cos_sin(_t(pos), 8)
    q, k = _rand(rng, 2, 5, 4, 8), _rand(rng, 2, 5, 2, 8)
    jq, jk = jc.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    tq, tk = tc.apply_rope(_t(q), _t(k), tcos, tsin)
    return [(jm.apply({"params": p}, x), tm(_t(x))), (jcos, tcos),
            (jsin, tsin), (jq, tq), (jk, tk),
            (jc.quick_gelu(jnp.asarray(x)), tc.quick_gelu(_t(x)))]


def case_clip(rng):
    from visionllm_tpu.config import VisionEncoderConfig as JCfg
    from visionllm_tpu.models.clip_vit import ClipVisionTower as J
    from visionllm_tpu_torch.config import VisionEncoderConfig as TCfg
    from visionllm_tpu_torch.models.clip_vit import ClipVisionTower as T
    dims = dict(image_size=56, patch_size=14, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4)
    x = _rand(rng, 2, 56, 56, 3)
    jm = J(JCfg(**dims), jnp.float32)
    p = jm.init(jax.random.PRNGKey(1), x)["params"]
    tm = _load(T(TCfg(**dims)), p)
    return [(jm.apply({"params": p}, x), tm(_t(x)))]


def case_bridge(rng):
    from visionllm_tpu.models.vl_bridge import VLBridge as J
    from visionllm_tpu_torch.models.vl_bridge import VLBridge as T
    x = _rand(rng, 2, 7, 32)
    out = []
    for kind in ("mlp2x_gelu", "linear"):
        jm = J(kind, 48, jnp.float32)
        p = jm.init(jax.random.PRNGKey(2), x)["params"]
        tm = _load(T(kind, 32, 48), p)
        out.append((jm.apply({"params": p}, x), tm(_t(x))))
    return out


def case_llama_prefill(rng):
    from visionllm_tpu.config import LLMConfig as JCfg
    from visionllm_tpu.models.llama import LlamaModel as J
    from visionllm_tpu_torch.config import LLMConfig as TCfg
    from visionllm_tpu_torch.models.llama import LlamaModel as T
    dims = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2)
    x = _rand(rng, 2, 11, 64, scale=0.5)
    pos = np.tile(np.arange(11, dtype=np.int32)[None], (2, 1))
    mask = np.ones((2, 11), np.int32)
    mask[1, :4] = 0                       # left-padded sample
    ids = rng.integers(0, 97, (2, 11)).astype(np.int32)
    jm = J(JCfg(**dims), jnp.float32)
    p = jm.init(jax.random.PRNGKey(3), ids, x, pos,
                method=lambda m, i, e, ps: (m.embed(i), m(e, ps)))["params"]
    tm = _load(T(TCfg(**dims)), p)
    out = [(jm.apply({"params": p}, ids, method=J.embed),
            tm.embed(_t(ids).long()))]
    for m in (None, mask):
        jh, jl, _ = jm.apply({"params": p}, x, pos, attn_mask=m)
        th, tl = tm(_t(x), _t(pos), attn_mask=None if m is None else _t(m))
        out += [(jh, th), (jl, tl)]
    return out


def case_swin(rng):
    from visionllm_tpu.models.swin import SwinBackbone as J
    from visionllm_tpu.models.swin import SwinConfig as JCfg
    from visionllm_tpu_torch.models.swin import SwinBackbone as T
    from visionllm_tpu_torch.models.swin import SwinConfig as TCfg
    dims = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                window_size=4, out_stages=(0, 1, 2, 3))
    x = _rand(rng, 1, 70, 52, 3)          # ragged grids: padding + shift
    jm = J(JCfg(**dims), jnp.float32)
    p = jax.jit(jm.init)(jax.random.PRNGKey(4), x)["params"]
    tm = _load(T(TCfg(**dims)), p)
    want = jax.jit(lambda p_: jm.apply({"params": p_}, x))(p)
    return list(zip(want, tm(_t(x))))


def case_gdino_layers(rng):
    from visionllm_tpu.models.grounding_dino import layers as jl
    from visionllm_tpu_torch.models.grounding_dino import layers as tl
    shapes = ((6, 8), (3, 4), (2, 2))
    S = sum(h * w for h, w in shapes)
    B, Q, T_, d = 2, 9, 5, 32
    vis = _rand(rng, B, S, d)
    qry = _rand(rng, B, Q, d)
    txt = _rand(rng, B, T_, d)
    pos = _rand(rng, B, S, d, scale=0.1)
    vmask = rng.random((B, S)) > 0.2
    tpad = np.zeros((B, T_), bool)
    tpad[1, 3:] = True
    ratios = rng.uniform(0.6, 1.0, (B, len(shapes), 2)).astype(np.float32)
    out = [(jl.encoder_reference_points(shapes, jnp.asarray(ratios)),
            tl.encoder_reference_points(shapes, _t(ratios)))]
    m = rng.random((B, 6, 8)) > 0.3
    out.append((jl.sine_position_embedding(jnp.asarray(m), d),
                tl.sine_position_embedding(_t(m), d)))
    coords = rng.random((B, Q, 4)).astype(np.float32)
    out.append((jl.get_sine_pos_embed(jnp.asarray(coords), 16),
                tl.get_sine_pos_embed(_t(coords), 16)))

    def both(jm, tm, *args, **kw):
        p = jm.init(jax.random.PRNGKey(5), *args, **kw)["params"]
        tm = _load(tm, p)
        targs = [_t(a) for a in args]
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        return jm.apply({"params": p}, *args, **kw), tm(*targs, **tkw)

    blocked = rng.random((B, Q, Q)) > 0.7
    blocked[:, np.arange(Q), np.arange(Q)] = False
    out.append(both(jl.TorchMHA(d, 4), tl.TorchMHA(d, 4), qry, qry, qry,
                    attn_mask=blocked))
    out.append(both(jl.TorchMHA(d, 4), tl.TorchMHA(d, 4), qry, txt, txt,
                    key_padding_mask=tpad))
    ref2 = rng.random((B, Q, len(shapes), 2)).astype(np.float32)
    ref4 = rng.uniform(0.1, 0.9, (B, Q, len(shapes), 4)).astype(np.float32)
    for ref in (ref2, ref4):
        out.append(both(jl.DeformableAttention(d, 4, len(shapes), 2),
                        tl.DeformableAttention(d, 4, len(shapes), 2),
                        qry, vis, position_embeddings=qry,
                        reference_points=ref, spatial_shapes=shapes,
                        value_mask=vmask))
    jv, tv = both(jl.BiMultiHeadAttention(d, 64, 2),
                  tl.BiMultiHeadAttention(d, 64, 2), vis, txt,
                  vision_pad_mask=~vmask, text_pad_mask=tpad)
    out += list(zip(jv, tv))
    jv, tv = both(jl.FusionLayer(d, 64, 2), tl.FusionLayer(d, 64, 2),
                  vis, txt, vision_pad_mask=~vmask, text_pad_mask=tpad)
    out += list(zip(jv, tv))
    tblock = rng.random((B, T_, T_)) > 0.6
    tblock[:, np.arange(T_), np.arange(T_)] = False
    out.append(both(jl.TextEnhancerLayer(d, 64, 2),
                    tl.TextEnhancerLayer(d, 64, 2), txt, attn_mask=tblock,
                    position_embeddings=_rand(rng, B, T_, d)))
    ref_enc = np.asarray(jl.encoder_reference_points(shapes,
                                                     jnp.asarray(ratios)))
    out.append(both(jl.DeformableEncoderLayer(d, 64, 4, len(shapes), 2),
                    tl.DeformableEncoderLayer(d, 64, 4, len(shapes), 2),
                    vis, position_embeddings=pos, reference_points=ref_enc,
                    spatial_shapes=shapes, value_mask=vmask))
    return out


def case_grounding_dino(rng):
    from visionllm_tpu.config import GDinoConfig as JCfg
    from visionllm_tpu.models.grounding_dino.model import GroundingDino as J
    from visionllm_tpu_torch.config import GDinoConfig as TCfg
    from visionllm_tpu_torch.models.grounding_dino.model import (
        GroundingDino as T)
    swin = {"patch_size": 4, "embed_dim": 8, "depths": (1, 1, 1, 1),
            "num_heads": (2, 2, 4, 4), "window_size": 4}
    dims = dict(d_model=32, num_queries=12, encoder_layers=1,
                decoder_layers=2, num_heads=4, ffn_dim=64, text_dim=48,
                mask_dim=32, max_text_len=16, backbone_overrides=swin)
    img = _rand(rng, 2, 128, 96, 3, scale=0.5)
    tq = _rand(rng, 2, 5, 4, 48)
    tq_mask = np.ones((2, 5), bool)
    tq_mask[1, 3:] = False
    pmask = np.ones((2, 128, 96), bool)
    pmask[1, 100:, :] = False             # padded det image
    pmask[1, :, 72:] = False
    jm = J(JCfg(**dims, dn_number=0), jnp.float32)
    p = jax.jit(lambda r: jm.init(r, img, tq, tq_mask, pixel_mask=pmask))(
        jax.random.PRNGKey(6))["params"]
    tm = _load(T(TCfg(**dims)), p)
    want = jax.jit(lambda p_: jm.apply({"params": p_}, img, tq, tq_mask,
                                       pixel_mask=pmask))(p)
    got = tm(_t(img), _t(tq), _t(tq_mask), pixel_mask=_t(pmask))
    return [(want[k], got[k]) for k in
            ("logits", "pred_boxes", "pred_masks", "enc_logits",
             "enc_boxes", "mask_features", "text_features")]


CASES = {f.__name__[5:]: f for f in (
    case_rmsnorm_rope, case_clip, case_bridge, case_llama_prefill,
    case_swin, case_gdino_layers, case_grounding_dino)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name):
    torch.set_num_threads(1)
    rng = np.random.default_rng(sorted(CASES).index(name))
    with torch.no_grad():
        pairs = CASES[name](rng)
    for i, (want, got) in enumerate(pairs):
        want = np.asarray(want)
        got = got.detach().numpy()
        assert got.shape == want.shape, (i, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=f"{name} output {i}")
